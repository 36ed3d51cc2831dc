#!/usr/bin/env python3
"""Which model lines issue a dry-run case's collectives, on this torch.

Run from the root of a checkout:

    PYTHONPATH=src python3 tools/dryrun_sites.py --arch tinyllama-1.1b \
        --shape decode_32k [--mesh single|multi] [--top 40] [--out sites.json]

traces the case once, as `python -m repro_torch.launch.dryrun` does (its
step on meta DTensors over the fake 256- or 512-rank world), and binds
every collective that `hlo_analysis.CollectiveCounter` counts to the stack
that issued it: the innermost frame under `repro_torch/models/` (the model
line) and the innermost frame of the port outside `launch/` (the helper
that ran it, e.g. a line of `sharding/context.py`), with the collective's
kind and the op `ReshardPolicy` was dispatching. The tally is one of the
counter's own numbers, so `sharding.loops` scales it with the rest: the
sites add up to the record's `collective_bytes`. It prints one JSON object
(and writes it to `--out`): the record's collectives, bottleneck and
reshards, and the sites by bytes, largest first. Torch versions partition
differently (2.11 and 2.13 give other records), so run it under the torch
the number in question came from. Host seconds only: no device runs.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.common.config import get_config  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import reshard as RS  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402


def _site():
    """(the innermost model line, the innermost port line outside
    `launch/`), as file:line under `src/`."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and "/launch/" not in f.filename]
    model = [f for f in frames if "/models/" in f.filename]

    def name(f):
        return f"{f.filename.split('src/')[-1]}:{f.lineno}" if f else None
    return name(model[-1] if model else None), \
        name(frames[-1] if frames else None)


@contextlib.contextmanager
def tally_sites():
    """Within: each `CollectiveCounter` made tallies its collectives by
    (model line, port line, kind, dispatched op) in its `sites` Counter,
    as one of its snapshot's numbers. Yields the list of counters made;
    restores the classes on exit."""
    dispatching = []
    policy_dispatch = RS.ReshardPolicy.__torch_dispatch__
    cls = HA.CollectiveCounter
    saved = (cls.__init__, cls.__torch_dispatch__, cls.snapshot, cls.restore)
    made = []

    def on_dtensor_op(self, func, types, args=(), kwargs=None):
        dispatching.append(str(func))
        try:
            return policy_dispatch(self, func, types, args, kwargs)
        finally:
            dispatching.pop()

    def init(self, *a, **k):
        saved[0](self, *a, **k)
        self.sites = collections.Counter()
        made.append(self)

    def on_collective(self, func, types, args=(), kwargs=None):
        out = saved[1](self, func, types, args, kwargs)
        pkt = getattr(func, "_overloadpacket", None)
        if out is not NotImplemented and pkt in self.comm_registry:
            kind = HA._KIND.get(pkt.__name__.split(".")[-1], pkt.__name__)
            key = (*_site(), kind, dispatching[-1] if dispatching else None)
            self.sites[key + ("bytes",)] += HA._nbytes(out)
            self.sites[key + ("ops",)] += 1
        return out

    def snapshot(self):
        return saved[2](self) + (dict(self.sites),)

    def restore(self, snap):
        saved[3](self, snap[:-1])
        self.sites = collections.Counter(snap[-1])

    RS.ReshardPolicy.__torch_dispatch__ = on_dtensor_op
    cls.__init__, cls.__torch_dispatch__, cls.snapshot, cls.restore = \
        init, on_collective, snapshot, restore
    try:
        yield made
    finally:
        RS.ReshardPolicy.__torch_dispatch__ = policy_dispatch
        (cls.__init__, cls.__torch_dispatch__, cls.snapshot,
         cls.restore) = saved


def site_rows(counter):
    """A tallied counter's sites, largest bytes first: dicts of
    model_line, port_line, kind, op, bytes, ops."""
    rows = collections.defaultdict(dict)
    for (*key, what), n in counter.sites.items():
        rows[tuple(key)][what] = n
    return sorted(({**dict(zip(("model_line", "port_line", "kind", "op"),
                               key)), **v} for key, v in rows.items()),
                  key=lambda r: -r["bytes"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    case = ST.build_case(get_config(args.arch), SHAPES[args.shape], mesh,
                         impl="ref")
    lowered = ST.lower_case(case, mesh)
    t0 = time.time()
    with tally_sites() as made:
        rec = HA.analyze(lowered)
    rows = site_rows(made[-1])
    out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "trace_s": round(time.time() - t0, 2),
           "collective_bytes": rec["collective_bytes"],
           "bottleneck": rec["bottleneck"], "collectives": rec["collectives"],
           "reshards": rec["reshards"],
           "sites_bytes": sum(r["bytes"] for r in rows),
           "sites": rows[:args.top]}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
