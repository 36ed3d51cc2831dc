#!/usr/bin/env python3
"""The dry-run's scaled recurrences against the full loops, on the CPU.

Run from the root of a checkout:

    PYTHONPATH=src python3 tools/dryrun_loops.py --arch xlstm-125m \
        --kind train --seq 128 [--no-remat]

traces one step of a reduced LM on a fake (2, 2) process group twice, as
`tests/test_torch_dryrun_loops.py` does: armed (`launch.steps.Lowered`
scales each recurrence from two steps, `sharding.loops`) and unarmed
(every step of every loop runs). `--arch jamba-v0.1-52b` is the test's
hybrid (a Mamba layer and an attention layer with experts), `xlstm-125m`
the reduced LM (three mLSTM blocks and an sLSTM block). It prints one
JSON object: each side's FLOPs, bytes, collective bytes and ops,
reshards, dropped shards, `loops_scaled`, `temp_peak_bytes` and trace
seconds, and the relative difference (armed - full) / full of each count.
Host seconds only: no device runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.common import config as C  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import shapes as SH  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.sharding import loops as L  # noqa: E402


def _trace(cfg, shape, mesh, remat):
    rec = HA.analyze(ST.lower_case(
        ST.build_case(cfg, shape, mesh, impl="ref", remat=remat), mesh))
    return {"flops": rec["hlo_flops"], "bytes": rec["hlo_bytes"],
            "collective_bytes": rec["collective_bytes"],
            "collective_ops": rec["collectives"]["ops"],
            "reshards": sum(rec["reshards"].values()),
            "shards_dropped": sum(rec["shards_dropped"].values()),
            "temp_peak_bytes": rec["memory"]["temp_bytes"],
            "loops_scaled": rec["loops_scaled"], "trace_s": rec["trace_s"]}


def main():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=["jamba-v0.1-52b", "xlstm-125m"],
                    default="xlstm-125m")
    ap.add_argument("--kind", choices=["train", "prefill"], default="train")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args()
    cfg = C.get_config(args.arch).reduced()
    if args.arch == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, attn_period=2, num_layers=2)
    shape = SH.ShapeSpec("s", args.kind, args.seq, 4)
    dist.init_process_group("fake", world_size=4, rank=0, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        armed = _trace(cfg, shape, mesh, not args.no_remat)
        scaled_loops = L.scaled_loops
        L.scaled_loops = lambda counters: contextlib.nullcontext(
            L.LoopScaler(counters))
        try:
            full = _trace(cfg, shape, mesh, not args.no_remat)
        finally:
            L.scaled_loops = scaled_loops
    finally:
        dist.destroy_process_group()
    rel = {k: (armed[k] - full[k]) / full[k] if full[k] else 0.0
           for k in armed if k not in ("loops_scaled", "trace_s")}
    print(json.dumps({"arch": args.arch, "kind": args.kind, "seq": args.seq,
                      "remat": not args.no_remat, "armed": armed,
                      "full": full, "relative_difference": rel}))


if __name__ == "__main__":
    main()
