"""Post-hoc augmentation: add analytic roofline terms to dry-run records
(port of `repro/launch/augment_roofline.py`).

    PYTHONPATH=src python -m repro_torch.launch.augment_roofline \
        [--out artifacts/dryrun_torch]

Computes the analytic model (`repro_torch.launch.roofline`) for every saved
dry-run JSON whose status is ok and merges the ``a_*`` fields in place. No
trace: the analytic terms depend only on (config, shape, mesh). The port's
`launch.dryrun` already writes them into each record; this refreshes them
after the model or the constants change.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.common.config import get_config
from repro_torch.launch.roofline import analytic_terms
from repro_torch.launch.shapes import SHAPES, adapt_config

MESH_DEVS = {"single": 256, "multi": 512}


def dp_degree_for(shape_name: str, mesh: str) -> int:
    b = SHAPES[shape_name].global_batch
    full = 16 * (2 if mesh == "multi" else 1)
    while full > 1 and b % full:
        full //= 2
    return max(full, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args()
    n = 0
    for fn in sorted(os.listdir(args.out)):
        if not fn.endswith(".json"):
            continue
        path = os.path.join(args.out, fn)
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        shape = SHAPES[rec["shape"]]
        cfg = adapt_config(get_config(rec["arch"]), shape)
        terms = analytic_terms(cfg, shape, MESH_DEVS[rec["mesh"]],
                               dp_degree_for(rec["shape"], rec["mesh"]))
        rec.update(terms)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        n += 1
    print(f"augmented {n} artifacts with analytic roofline terms")


if __name__ == "__main__":
    main()
