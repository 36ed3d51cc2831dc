"""Step builders + input_specs (port of `repro/launch/steps.py`).

For every (architecture x input shape x mesh) this module produces:
  * the step function (train_step / prefill_step / decode_step),
  * meta-device tensors standing in for every input (the reference's
    ShapeDtypeStructs: shapes and dtypes, no storage),
  * in/out NamedShardings assembled from the partition rules
    (`sharding.specs`).

Sharding policy (the reference's baseline):
  * batch over the data-parallel axes (pod, data) when divisible;
  * weights FSDP: d_model over `data`, wide dim over `model`;
  * decode KV caches: sequence dim over every mesh axis not used by the
    batch (flash-decoding style sharded softmax);
  * train/prefill activations: batch-sharded, full sequence per device.

The steps run eagerly on whatever tensors they are given (on a 1-device
mesh: tensors on that device), with the activation-sharding context armed
(`sharding.context`). Where the reference jits with `donate_argnums`, the
port updates the donated arguments in place: the train step's params and
Adam moments (`training.optimizer.adam_apply_`), the prefill's and the
decode's cache (the models write it).

`lower_case` is the counterpart of the reference's `jax.jit(...).lower`:
it places a case's meta structs as DTensors on a `DeviceMesh` (the
dry-run's fake world, `launch.mesh.make_production_mesh`) by the case's
in-shardings, and its `analyze()` runs the step once under the dry-run's
counting modes (`launch.hlo_analysis`) and reshard policy
(`launch.reshard`). Build such a case with `impl="ref"`: the kernels take
no meta tensors, and the reference's dry-run traces its jnp paths too.
A decode step runs no kernel, so `impl` reaches the loss and the prefill.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.launch.shapes import ShapeSpec, adapt_config
from repro_torch.models.zoo import build_model
from repro_torch.sharding.context import activation_sharding
from repro_torch.sharding.specs import (PARAM_RULES, NamedSharding,
                                        batch_spec, cache_rules, mesh_shape,
                                        tree_shardings)
from repro_torch.training.optimizer import adam_apply_, adam_init, \
    value_and_grad

META = torch.device("meta")


class Case(NamedTuple):
    fn: Any                     # the step callable
    arg_structs: Tuple          # meta tensors standing in for its arguments
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...]   # arguments updated in place
    cfg: ArchConfig


def _repl(mesh):
    return NamedSharding(mesh, ())


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def batch_structs(cfg: ArchConfig, batch: int, seq: int) -> Dict:
    out = {"tokens": _meta((batch, seq), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = _meta((batch, cfg.frontend_tokens, cfg.d_model),
                              torch.float32)
    if cfg.frontend == "vision":
        out["image_embeds"] = _meta((batch, cfg.frontend_tokens,
                                     cfg.frontend_dim), torch.float32)
    return out


def _batch_shardings(structs: Dict, mesh, dp) -> Dict:
    return {k: NamedSharding(mesh, (dp,) + (None,) * (v.ndim - 1))
            for k, v in structs.items()}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    """Meta tensors standing in for every model input of this shape (the
    public entry the assignment asks for)."""
    if shape.kind == "train":
        b = batch_structs(cfg, shape.global_batch, shape.seq_len)
        b["labels"] = _meta((shape.global_batch, shape.seq_len), torch.int32)
        return b
    if shape.kind == "prefill":
        return batch_structs(cfg, shape.global_batch, shape.seq_len)
    return {"token": _meta((shape.global_batch, 1), torch.int32)}


def _split(batch: Dict, n: int):
    """The batch as `n` microbatches along its leading axis."""
    parts = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
             for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ----------------------------------------------------------------------
def build_case(arch_cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               lr: float = 1e-4, compute_dtype=torch.bfloat16,
               remat: bool = True, seq_shard_activations: bool = False,
               microbatches: int = 1, tp_inference: bool = False,
               param_dtype=torch.float32, impl: str = "auto") -> Optional[Case]:
    """The step of `shape.kind` for `arch_cfg` adapted to `shape` (None
    when the pair is skipped) on `mesh` (a `launch.mesh.Mesh`, a
    `DeviceMesh` or a mapping from axis name to size). On the card the
    steps' attention and scans run the kernels (`impl="auto"`); "ref"
    takes their plain versions anywhere."""
    cfg = adapt_config(arch_cfg, shape)
    if cfg is None:
        return None
    model = build_model(cfg)
    sizes = mesh_shape(mesh)
    dp = batch_spec(mesh, shape.global_batch)
    seq_ax = ("model" if seq_shard_activations
              and shape.seq_len % sizes["model"] == 0 else None)
    act_sh = NamedSharding(mesh, (dp if dp else None, seq_ax, None))
    moe_sh = None
    if cfg.moe is not None and cfg.moe.num_experts % sizes["model"] == 0:
        moe_sh = NamedSharding(mesh, (dp if dp else None, "model", None,
                                      None))

    def pin_activations(fn):
        """Arm the activation-sharding constraints while the step runs."""
        def wrapped(*args):
            with activation_sharding(act_sh, moe_sh):
                return fn(*args)
        return wrapped

    # shapes only: no generator, every draw on the meta device is a shape
    params_struct = model.init(None, param_dtype, device=META)
    prules = None
    if tp_inference and shape.kind != "train":
        # tensor-parallel-only weights: replicate over the `data`/`pod`
        # axes so serving steps never pay per-step FSDP all-gathers
        prules = [(pat, tuple(None if e in ("data", "pod") else e
                              for e in entries))
                  for pat, entries in PARAM_RULES]
    param_sh = (tree_shardings(params_struct, mesh, rules=prules)
                if prules else tree_shardings(params_struct, mesh))

    if shape.kind == "train":
        bstructs = input_specs(cfg, shape)
        b_sh = _batch_shardings(bstructs, mesh, dp)
        opt_struct = adam_init(params_struct)
        opt_sh = tree_shardings(opt_struct, mesh)

        def grad_of(params, mb):
            return value_and_grad(
                lambda p: model.loss(p, mb, compute_dtype=compute_dtype,
                                     remat=remat, impl=impl), params)

        def train_step(params, opt_state, batch):
            if microbatches <= 1:
                loss, metrics, grads = grad_of(params, batch)
            else:
                # gradient accumulation: activation working sets scale with
                # B / microbatches; grads accumulate in fp32, the loss sums
                # in fp32, both divided at the end; the metrics are the
                # last microbatch's
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
                for mb in _split(batch, microbatches):
                    l_mb, metrics, g = grad_of(params, mb)
                    for a, b_ in zip(tree_leaves(grads), tree_leaves(g)):
                        a.add_(b_.to(a.dtype))
                    loss = loss + l_mb
                for a in tree_leaves(grads):
                    a.div_(microbatches)
                loss = loss / microbatches
            opt_state = adam_apply_(grads, opt_state, params, lr)
            return params, opt_state, loss, metrics

        return Case(
            fn=pin_activations(train_step),
            arg_structs=(params_struct, opt_struct, bstructs),
            in_shardings=(param_sh, opt_sh, b_sh),
            # the metrics' dict replicated as a whole (a prefix, as jax
            # takes one)
            out_shardings=(param_sh, opt_sh, _repl(mesh), _repl(mesh)),
            donate_argnums=(0, 1),
            cfg=cfg,
        )

    # inference cases ---------------------------------------------------
    seq_axes = tuple(a for a in ("pod", "data", "model")
                     if a in sizes and a not in (dp if isinstance(dp, tuple)
                                                 else (dp,)))
    crules = cache_rules(dp if dp else None, seq_axes if seq_axes else None)
    cache_struct = model.make_cache(shape.global_batch, shape.seq_len,
                                    torch.bfloat16, device=META)
    cache_sh = tree_shardings(cache_struct, mesh, rules=crules)
    logits_sh = NamedSharding(mesh, (dp if dp else None,))

    if shape.kind == "prefill":
        bstructs = input_specs(cfg, shape)
        b_sh = _batch_shardings(bstructs, mesh, dp)

        def prefill_step(params, batch, cache):
            # capacity-bounded MoE dispatch at scale (dropless would cost
            # e/k-times the expert FLOPs on a 32k prompt)
            return model.prefill(params, batch, cache,
                                 compute_dtype=compute_dtype, impl=impl,
                                 moe_dropless=False)

        return Case(
            fn=pin_activations(prefill_step),
            arg_structs=(params_struct, bstructs, cache_struct),
            in_shardings=(param_sh, b_sh, cache_sh),
            out_shardings=(logits_sh, cache_sh),
            donate_argnums=(2,),
            cfg=cfg,
        )

    # decode
    tok_struct = input_specs(cfg, shape)["token"]
    tok_sh = NamedSharding(mesh, (dp if dp else None, None))

    def decode_step(params, cache, token):
        # s=1: capacity == dropless (each token hits k distinct experts)
        return model.decode(params, cache, token, compute_dtype=compute_dtype,
                            moe_dropless=False)

    return Case(
        fn=pin_activations(decode_step),
        arg_structs=(params_struct, cache_struct, tok_struct),
        in_shardings=(param_sh, cache_sh, tok_sh),
        out_shardings=(logits_sh, cache_sh),
        donate_argnums=(1,),
        cfg=cfg,
    )


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(x.to_local().numel() * x.element_size()
               if isinstance(x, DTensor) else x.numel() * x.element_size()
               for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


class Lowered:
    """A case's step with its arguments placed as DTensors on `mesh`.
    `analyze()` traces it once (the first call) and returns what the
    counters saw: per-device FLOPs by op and eager bytes, collectives'
    output bytes and counts by kind, the reshard policy's record, the
    arguments' and the fresh outputs' local bytes, the peak of what the
    step allocates (`MemTracker`, local shards), the trace's seconds."""

    def __init__(self, case: Case, mesh, budget_s: float = float("inf")):
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.sharding.specs import to_placements
        self.case, self.mesh = case, mesh
        names = mesh.mesh_dim_names

        def place(x, sh):
            if not isinstance(x, torch.Tensor):
                return x                         # a cache's int `pos`
            return distribute_tensor(x, mesh, to_placements(sh.spec, names))
        self.args = tree_map(place, tuple(case.arg_structs),
                             tuple(case.in_shardings))
        self.dp_dims = tuple(i for i, n in enumerate(names)
                             if n in ("pod", "data"))
        self.budget_s = budget_s
        self._record = None

    def analyze(self) -> Dict:
        if self._record is not None:
            return self._record
        from torch.distributed._tools.mem_tracker import MemTracker
        from repro_torch.launch.hlo_analysis import (CollectiveCounter,
                                                     LocalCounter)
        from repro_torch.launch.reshard import (ReshardPolicy,
                                                greedy_redistribute_plans)
        mem, local, comm = MemTracker(), LocalCounter(), CollectiveCounter()
        policy = ReshardPolicy(self.dp_dims, counters=(local, comm),
                               budget_s=self.budget_s)
        t0 = time.time()
        with greedy_redistribute_plans(), mem, local, comm, policy:
            out = self.case.fn(*self.args)
        ids = {id(x) for x in tree_leaves(self.args)}
        fresh = [x for x in tree_leaves(out)
                 if isinstance(x, torch.Tensor) and id(x) not in ids]
        self._record = {
            "flops": dict(local.flops), "bytes": local.bytes,
            "coll_bytes": dict(comm.coll_bytes),
            "coll_ops": dict(comm.coll_ops),
            "argument_bytes": _local_bytes(self.args),
            "output_bytes": _local_bytes(fresh),
            "temp_peak_bytes": sum(
                d["Total"] for d in mem.get_tracker_snapshot("peak").values()),
            "trace_s": round(time.time() - t0, 2), **policy.record()}
        return self._record


def lower_case(case: Case, mesh, *, budget_s: float = float("inf")
               ) -> Lowered:
    """The counterpart of `jax.jit(case.fn, ...).lower(*arg_structs)`:
    `case`'s arguments distributed as DTensors on `mesh` (a `DeviceMesh`)
    by `case.in_shardings`; its trace stops past `budget_s` seconds."""
    return Lowered(case, mesh, budget_s)
