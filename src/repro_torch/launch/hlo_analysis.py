"""Roofline terms from a traced dry-run step (port of
`repro/launch/hlo_analysis.py`; the name is kept so a reader finds the
counterpart).

There is no HLO text. `launch.steps.lower_case` distributes a case's
arguments as DTensors over the fake process group of
`launch.mesh.make_production_mesh`, and `Lowered.analyze` runs the step
once, eagerly, under four modes (top first): `launch.reshard`'s
`ReshardPolicy`, `CollectiveCounter`, `LocalCounter` and `MemTracker`.
What the counters see is per device, like the reference's
`cost_analysis()`:

* **FLOPs** (`hlo_flops`): `torch.utils.flop_counter`'s formulas (matmuls,
  convolutions, attention) over the ops DTensor runs on each device's
  local shards. `FlopCounterMode` itself is not used: besides the local
  ops it counts the FakeTensor run by which DTensor's sharding
  propagation learns an op's output, at global shapes, once for each op
  signature not yet in its cache (so the first call of an op counts
  global + local, later ones local only). Like FlopCounterMode, and
  unlike XLA, elementwise ops add no FLOPs.
* **Bytes** (`hlo_bytes`): every local op's operands and results, once
  each, views and metadata ops excluded: what an eager run of the step
  moves through HBM with no fusion (XLA's "bytes accessed" is after
  fusion, so this one is larger).
* **Collectives**: `CommDebugMode` with each collective's output bytes a
  device added up by kind, as the reference sums each collective's
  output shape. The CPU fake group has no all-to-all: DTensor falls back
  to an all-gather and a chunk, so an all-to-all is counted as an
  all-gather of its output.
* **Memory**: the arguments' local shard bytes, exactly, plus the peak
  of what the step allocates on top of them (temporaries and outputs,
  `torch.distributed._tools.MemTracker` over the local shards, which it
  takes on meta tensors): `peak_device_bytes`. Eager frees nothing early
  that XLA's buffer assignment would, so the port's temporaries are
  larger than a compiled step's.

The per-device terms take the H100 constants of `launch.mesh`.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, LINK_BW, NUM_LINKS, \
    PEAK_FLOPS_BF16

# collective op name (native or legacy functional collectives) -> kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no data (views, metadata, waits)
_NO_TRAFFIC = {
    "view", "_unsafe_view", "alias", "as_strided", "detach", "expand",
    "permute", "select", "slice", "split", "split_with_sizes", "squeeze",
    "unsqueeze", "t", "transpose", "unbind", "chunk", "narrow", "empty",
    "empty_strided", "empty_like", "zeros", "lift_fresh", "wait_tensor",
    "_to_copy_meta", "_wrap_tensor_autograd", "unflatten", "diagonal",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
}


def _nbytes(tree) -> int:
    out = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out += t.numel() * t.element_size()
    return out


def _not_local(types) -> bool:
    """An op on DTensors, or one of the FakeTensor run by which DTensor's
    sharding propagation learns an op's output (once for each op
    signature, at global shapes): on FakeTensors, or on the meta tensors
    inside them while FakeTensorMode runs a kernel (which flags its thread
    with meta-in-TLS)."""
    return (torch._C._meta_in_tls_dispatch_include()
            or any(issubclass(t, (DTensor, FakeTensor)) for t in types))


class LocalCounter(TorchDispatchMode):
    """FLOPs and bytes of the ops run on local tensors (a device's
    shards); an op on DTensors is passed on to DTensor, and one on
    FakeTensors runs, uncounted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops: Counter = Counter()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _not_local(types):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        pkt = getattr(func, "_overloadpacket", None)
        if pkt is None:
            return out
        formula = self.registry.get(pkt)
        if formula is not None:
            self.flops[str(pkt)] += int(formula(*args, **kwargs,
                                                out_val=out))
        name = pkt.__name__.split(".")[-1]
        if name not in _NO_TRAFFIC and name not in _KIND:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def snapshot(self):
        return Counter(self.flops), self.bytes

    def restore(self, snap):
        self.flops, self.bytes = Counter(snap[0]), snap[1]


class CollectiveCounter(CommDebugMode):
    """`CommDebugMode` that also adds up each collective's output bytes
    (a device's) by kind."""

    def __init__(self):
        super().__init__()
        self.coll_bytes: Counter = Counter()
        self.coll_ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        pkt = getattr(func, "_overloadpacket", None)
        if out is not NotImplemented and pkt in self.comm_registry:
            kind = _KIND.get(pkt.__name__.split(".")[-1], pkt.__name__)
            self.coll_bytes[kind] += _nbytes(out)
            self.coll_ops[kind] += 1
        return out

    def snapshot(self):
        return (dict(self.comm_counts), Counter(self.coll_bytes),
                Counter(self.coll_ops))

    def restore(self, snap):
        self.comm_counts.clear()
        self.comm_counts.update(snap[0])
        self.coll_bytes, self.coll_ops = Counter(snap[1]), Counter(snap[2])


def collective_bytes(record: Dict) -> Dict[str, float]:
    """Per-device bytes moved by collectives, by kind, with `total` and
    `ops`, from a trace record's `coll_bytes` and `coll_ops` (what
    `CollectiveCounter` saw)."""
    out: Dict[str, float] = {k: float(v)
                             for k, v in record["coll_bytes"].items()}
    out["total"] = sum(out.values())
    out["ops"] = sum(record["coll_ops"].values())
    return out


def roofline_terms(cost: Dict, coll: Dict, *, num_links: int = NUM_LINKS
                   ) -> Dict:
    """Three roofline terms in seconds (per device), the reference's keys."""
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    bytes_coll = float(coll.get("total", 0.0))
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_hbm / HBM_BW
    t_coll = bytes_coll / (LINK_BW * num_links)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll, "hlo_flops": flops,
             "hlo_bytes": bytes_hbm, "collective_bytes": bytes_coll}
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    terms["bottleneck"] = dominant.replace("_s", "")
    return terms


def analyze(lowered) -> Dict:
    """The counterpart of the reference's `analyze_compiled`: the roofline
    terms, memory, collectives and reshards of one traced step
    (`lowered.analyze()`)."""
    rec = lowered.analyze()
    coll = collective_bytes(rec)
    out = roofline_terms({"flops": sum(rec["flops"].values()),
                          "bytes accessed": rec["bytes"]}, coll)
    out["memory"] = {"argument_bytes": rec["argument_bytes"],
                     "output_bytes": rec["output_bytes"],
                     "temp_bytes": rec["temp_peak_bytes"]}
    out["peak_device_bytes"] = rec["argument_bytes"] + rec["temp_peak_bytes"]
    out["collectives"] = coll
    out["flops_by_op"] = dict(rec["flops"])
    for key in ("reshards", "shards_dropped", "policy", "trace_s"):
        out[key] = rec[key]
    return out
