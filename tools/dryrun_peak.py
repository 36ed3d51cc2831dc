#!/usr/bin/env python3
"""Where a dry-run case's memory peak comes from, on this torch.

Run from the root of a checkout:

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch tinyllama-1.1b \
        --shape train_4k [--mesh single|multi] [--threshold 1e9] \
        [--out peak.json]

traces the case once, as `python -m repro_torch.launch.dryrun` does (its
step on meta DTensors over the fake 256- or 512-rank world), and records:
the model lines on the stack when `LocalMemTracker` reached its peak and
the largest storages then live; every op whose output on a device passes
`--threshold` bytes (DTensor ops with their operands' placements, and
local ops); every collective whose output passes it, with the op that
`ReshardPolicy` was dispatching. It prints one JSON object (and writes it
to `--out`): the record's peak, memory, FLOPs by op, reshards, dropped
shards, policy counts and collectives beside those lists. Torch
versions partition and track differently (2.11 and 2.13 give other
records), so run it under the torch the number in question came from.
Host seconds only: no device runs.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.common.config import get_config  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import reshard as RS  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402


def _model_lines(n: int):
    """The innermost n model frames on the stack, as file:line."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and "/launch/" not in f.filename]
    return [f"{f.filename.split('src/')[-1]}:{f.lineno}" for f in frames[-n:]]


def _placed(args, kwargs):
    return [(list(a.shape), [str(p) for p in a.placements])
            for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor)]


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else [out]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--threshold", type=float, default=1e9)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    thresh = args.threshold

    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    case = ST.build_case(get_config(args.arch), SHAPES[args.shape], mesh,
                         impl="ref")
    lowered = ST.lower_case(case, mesh)

    peak = {"bytes": 0, "at": None, "live": None}
    track = HA.LocalMemTracker._update_peak_stats

    def update_peak(self, state):
        track(self, state)
        now = sum(d["Total"]
                  for d in self.get_tracker_snapshot("current").values())
        if now > peak["bytes"]:
            peak.update(bytes=now, at=_model_lines(6), live=sorted(
                (w.mem_consumed for w, _ in self._WINFO.values()),
                reverse=True)[:12])
    HA.LocalMemTracker._update_peak_stats = update_peak

    dispatching = []
    big_dtensor, big_local, big_coll = (collections.Counter()
                                        for _ in range(3))
    policy_dispatch = RS.ReshardPolicy.__torch_dispatch__

    def on_dtensor_op(self, func, types, args=(), kwargs=None):
        dispatching.append(str(func))
        try:
            out = policy_dispatch(self, func, types, args, kwargs)
        finally:
            dispatching.pop()
        for o in _outputs(out):
            if isinstance(o, DTensor) and \
                    o.to_local().numel() * o.element_size() > thresh:
                big_dtensor[json.dumps(
                    [str(func), list(o.shape), [str(p) for p in o.placements],
                     _placed(args, kwargs), _model_lines(2)])] += 1
        return out
    RS.ReshardPolicy.__torch_dispatch__ = on_dtensor_op

    local_dispatch = HA.LocalCounter.__torch_dispatch__

    def on_local_op(self, func, types, args=(), kwargs=None):
        out = local_dispatch(self, func, types, args, kwargs)
        if out is NotImplemented or HA._not_local(types):
            return out
        for o in _outputs(out):
            if isinstance(o, torch.Tensor) and not isinstance(o, DTensor) \
                    and o.numel() * o.element_size() > thresh:
                big_local[json.dumps(
                    [str(func), list(o.shape), str(o.dtype), _model_lines(2),
                     dispatching[-1] if dispatching else None])] += 1
        return out
    HA.LocalCounter.__torch_dispatch__ = on_local_op

    coll_dispatch = HA.CollectiveCounter.__torch_dispatch__

    def on_collective(self, func, types, args=(), kwargs=None):
        out = coll_dispatch(self, func, types, args, kwargs)
        pkt = getattr(func, "_overloadpacket", None)
        if out is not NotImplemented and pkt in self.comm_registry and \
                HA._nbytes(out) > thresh:
            big_coll[json.dumps(
                [str(func), HA._nbytes(out), _model_lines(2),
                 dispatching[-1] if dispatching else None])] += 1
        return out
    HA.CollectiveCounter.__torch_dispatch__ = on_collective

    t0 = time.time()
    rec = HA.analyze(lowered)

    def top(counter):
        return sorted(([json.loads(k), n] for k, n in counter.items()),
                      key=lambda kv: -kv[1])[:40]
    out = {"torch": torch.__version__, "arch": args.arch,
           "shape": args.shape, "mesh": args.mesh,
           "trace_s": round(time.time() - t0, 2),
           "peak_device_bytes": rec["peak_device_bytes"],
           "memory": rec["memory"], "peak_at": peak["at"],
           "peak_live_bytes": peak["live"],
           "flops_by_op": rec["flops_by_op"], "reshards": rec["reshards"],
           "shards_dropped": rec["shards_dropped"], "policy": rec["policy"],
           "collectives": rec["collectives"],
           "large_dtensor_outputs": top(big_dtensor),
           "large_local_outputs": top(big_local),
           "large_collectives": top(big_coll)}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
