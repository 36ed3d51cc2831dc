"""Pluggable execution backends for the batched rollout engine (port of
`repro/api/backends.py`).

Every backend is one callable with the port's `batch_rollout` calling
convention:

    fn(ecfg, traces, policy, params, *, generator=None, num_steps=None,
       collect=False, init_state=None, device=None) -> RolloutResult

(a `torch.Generator` where the reference takes per-env `keys`), so
episodic evaluation, streaming windows (`StreamRunner(rollout_fn=...)`)
and training collection all swap engines through one seam:

* ``reference`` — the unfused engine on the compositional
  `env.step_with_queue` (`batch_rollout(fused=False)`); the oracle.
* ``fused`` — the fused engine (`batch_rollout(fused=True,
  impl=spec.fused_impl)`): one env_step launch per decision inside the
  decision's CUDA graphs on the card, the default.
* ``sharded`` — the fused engine over a 1-D device mesh
  (`launch.mesh.make_data_mesh`), driven from this one process: the
  traces and a carried `init_state` split on the batch axis, one slice a
  shard (without a carried state each shard resets its own slice); the
  params are placed once on each distinct device; every shard's
  `batch_rollout(fused=True, impl=spec.fused_impl)` is enqueued before
  anything synchronises; then every leaf of the `RolloutResult` (metrics,
  final state, transitions) is concatenated along axis 0 on the mesh's
  first device. A device may carry several shards. See
  `rollout_fn_for` for the generator rule, the one difference from the
  reference.
* ``serving`` — the real serving cluster (`repro_torch.serving.backend`):
  one physical pool (batch must be 1) whose scheduler state is a mirror
  `EnvState` advanced by the env_step kernel at batch 1, with real weight
  loads and patch-parallel prefill/decode per scheduled task. Virtual time
  equals ``fused`` at batch 1; wall-clock mode patches measured latencies
  back into rewards and observations. The returned callable is STATEFUL
  (the pool persists across calls — that is the point); build one per
  consumer via `rollout_fn_for` and `reset()` it between runs.

Equal shards on one device share one decision loop
(`actors.program._Loop`, cached per device and batch): each shard's run
copies its slice into the loop's buffers and hands out clones of its
results, in stream order, so the next shard cannot overwrite them. On
the card the loop draws from a generator of its own whose state is set
from the shard's generator before the run and handed back after.

What synchronises the host in a sharded call: the split of the caller's
generator with n > 1 shards (one read of its n seeds, before any shard is
enqueued), and the first rollout of a decision loop on the card, which
captures its CUDA graphs (a capture synchronises). A later rollout of the
same loop reads nothing from the device, so shards on several cards run
side by side; one card cannot show that.
"""
from __future__ import annotations

import math
import warnings
from contextlib import nullcontext
from typing import Dict, List, Optional

import torch

from repro_torch.api.specs import BACKENDS, ExecSpec
from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO
from repro_torch.launch import mesh as MX


def device_count(device=None) -> int:
    """Local devices the sharded backend may split over on `device`'s
    type (None: CUDA): the CUDA device count, or on the host 1 (jax's CPU
    default; any number may be asked for there, see `resolve_shards`)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def resolve_shards(batch: int, spec: ExecSpec, device=None) -> int:
    """Mesh size the sharded backend will use for a batch on `device`'s
    type: the requested device count (0 = all local), degraded to
    gcd(batch, devices) when the batch axis does not divide evenly. On
    CUDA more devices than exist is an error; on the host any count is a
    mesh of that many shards (the counterpart of jax's forced host
    devices)."""
    dev = resolve_device(device)
    want = spec.mesh_devices or device_count(dev)
    if dev.type == "cuda" and want > device_count(dev):
        raise ValueError(
            f"ExecSpec.mesh_devices={spec.mesh_devices} but only "
            f"{device_count(dev)} local devices exist (several shards on "
            "one card: pass rollout_fn_for a mesh that repeats it)")
    return math.gcd(int(batch), want)


def _concat(parts: List, dev: torch.device):
    """Leaf-wise concatenation along axis 0, on `dev`, of equal trees of
    tensors (dicts, NamedTuples, None)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], dev) for k in first}
    return type(first)(*(_concat([p[i] for p in parts], dev)
                         for i in range(len(first))))


def _split_generators(generator, mesh: MX.Mesh) -> List[torch.Generator]:
    """Child s of `split_generator(generator, n)`, on shard s's device (a
    fresh default-seeded parent on the first device when None)."""
    from repro_torch.api.simulator import split_generator
    parent = (torch.Generator(device=mesh.devices[0]) if generator is None
              else generator)
    kids = split_generator(parent, mesh.size, device=mesh.devices[0])
    return [g if d == mesh.devices[0] else
            torch.Generator(device=d).manual_seed(g.initial_seed())
            for g, d in zip(kids, mesh.devices)]


def sharded_rollout(mesh: MX.Mesh, ecfg: EV.EnvConfig, traces: Dict,
                    policy, params, *, generator=None,
                    num_steps: Optional[int] = None, collect: bool = False,
                    init_state: Optional[EV.EnvState] = None,
                    impl: str = "auto") -> RO.RolloutResult:
    """The fused engine over every device of `mesh` (its size divides the
    batch): shard s takes rows [s B/n, (s+1) B/n) and the generator of the
    rule in `rollout_fn_for`; the result gathers on `mesh.devices[0]`."""
    n = mesh.size
    B = traces["arr_time"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not divide over {n} shards")
    b = B // n
    gens = [generator] if n == 1 else _split_generators(generator, mesh)
    placed = {d: to_device(params, d) for d in mesh.distinct_devices()}
    results = []
    for s, d in enumerate(mesh.devices):
        rows = slice(s * b, (s + 1) * b)
        st = (None if init_state is None else
              EV.EnvState(*(x[rows] for x in init_state)))
        with (torch.cuda.device(d) if d.type == "cuda" else nullcontext()):
            results.append(RO.batch_rollout(
                ecfg, {k: v[rows] for k, v in traces.items()}, policy,
                placed[d], generator=gens[s], num_steps=num_steps,
                collect=collect, init_state=st, device=d, fused=True,
                impl=impl))
    return _concat(results, mesh.devices[0])


def rollout_fn_for(spec: ExecSpec = ExecSpec(), *,
                   mesh: Optional[MX.Mesh] = None):
    """Resolve an ExecSpec to a rollout callable (`batch_rollout`
    convention). The callable is safe to reuse across calls and batch
    sizes; each policy's decision program (and its CUDA graphs) is cached
    underneath by `actors.program.actor_program`.

    ``sharded`` splits over `mesh` (a `launch.mesh.Mesh`, whose devices
    may repeat) or, when None, `make_data_mesh(resolve_shards(...))` on
    the call's device. Either way a batch that does not divide degrades
    to the first gcd(batch, size) devices, with the reference's warning.

    Generators (where the port differs from the reference, whose keys
    are per environment and so split with the batch; one
    `torch.Generator` cannot be sliced by rows):
    * with one shard, the shard draws from the caller's generator, so
      ``sharded`` equals ``fused`` in every tensor;
    * with n > 1 shards, shard s draws from child s of
      `api.simulator.split_generator(generator, n)` (placed on the
      shard's device), so a sharded run equals the concatenation of n
      ``fused`` runs on the batch's slices with those generators;
    * a policy that draws nothing (fifo, greedy) equals ``fused`` on the
      whole batch for any n."""
    if not isinstance(spec, ExecSpec):
        raise ValueError("exec_spec must be the API facade's "
                         "repro_torch.api.ExecSpec, got "
                         f"{type(spec).__name__}")
    if spec.backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS}, got {spec.backend!r}")

    if spec.backend == "serving":
        # lazy: the serving stack (model zoo, executor) is heavy and only
        # needed when actually serving. Fresh state per resolution — each
        # consumer owns its own pool, persistent across its windows/rounds.
        from repro_torch.serving.backend import serving_rollout
        return serving_rollout(spec)

    if spec.backend == "sharded":
        def fn(ecfg, traces, policy, params, *, generator=None,
               num_steps=None, collect=False, init_state=None, device=None):
            B = traces["arr_time"].shape[0]
            if mesh is None:
                dev = resolve_device(device)
                want = spec.mesh_devices or device_count(dev)
                m = MX.make_data_mesh(resolve_shards(B, spec, dev),
                                      spec.mesh_axis, device=dev)
            else:
                want = mesh.size
                ndev = math.gcd(int(B), want)
                m = MX.Mesh(mesh.devices[:ndev], mesh.axis_names[:1],
                            (ndev,))
            if m.size < want:
                warnings.warn(
                    f"sharded backend: batch {B} does not divide over {want} "
                    f"devices; degrading to a {m.size}-device mesh",
                    stacklevel=2)
            return sharded_rollout(m, ecfg, traces, policy, params,
                                   generator=generator, num_steps=num_steps,
                                   collect=collect, init_state=init_state,
                                   impl=spec.fused_impl)
        fn.backend = "sharded"
        return fn

    fused = spec.backend == "fused"

    def fn(ecfg, traces, policy, params, *, generator=None, num_steps=None,
           collect=False, init_state=None, device=None):
        return RO.batch_rollout(ecfg, traces, policy, params,
                                generator=generator, num_steps=num_steps,
                                collect=collect, init_state=init_state,
                                device=device, fused=fused,
                                impl=spec.fused_impl)
    fn.backend = spec.backend
    return fn
