#!/usr/bin/env python3
"""Phase 4's decision on two checkouts in one call, on one NVIDIA GPU.

    python3 tools/ab_decision.py OTHER_CHECKOUT

runs PAIRS pairs, alternating which side runs first, of one `batch_rollout`
of the EAT actor on paper-8srv with sampler "ddpm" at B = 256 (`chip_smoke.
phase_main`: ms per decision over a 1024-decision episode) and its short
profiled rollout (`chip_smoke.phase_profile`: device-busy ms and idle
share), each in a fresh process in that checkout. It prints every run, then
per metric each side's median and quartiles and how many pairs this
checkout won (lower ms, lower idle share). OTHER_CHECKOUT is the root of
another checkout of this repository (e.g. the parent commit unpacked with
`git archive` into a directory that .gitignore lists); each builds its own
kernels into its own build/.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAIRS = 10
METRICS = ("ms_per_decision", "device_busy_ms_per_decision",
           "device_idle_share")
RUN = r'''
import json, subprocess, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import chip_smoke as C
from repro_torch.kernels import build as KB
torch.backends.cuda.matmul.allow_tf32 = False
KB.build(["env_step", "denoiser_chain"])
dev = torch.device("cuda")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
_, ms = C.phase_main(dev, card, cells=(("paper-8srv", 8, 0.1),),
                     samplers=("ddpm",))
row = C.phase_profile(dev, card)
print("decision " + json.dumps({
    "tree": sys.argv[1], "card": card,
    "ms_per_decision": ms[("paper-8srv", "ddpm")],
    **{k: row[k] for k in ("wall_ms_per_decision",
                           "device_busy_ms_per_decision",
                           "device_idle_share")},
    "top_device_us_per_decision": row["top_device_us_per_decision"]}),
    flush=True)
'''


def run(label, tree):
    r = subprocess.run([sys.executable, "-c", RUN, label], cwd=tree,
                       capture_output=True, text=True)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("decision ")]
    if r.returncode or not lines:
        sys.exit(f"{label} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    print(lines[-1], flush=True)
    return json.loads(lines[-1][len("decision "):])


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"other": Path(sys.argv[1]).resolve(), "this": ROOT}
    pairs = []
    for i in range(PAIRS):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        got = {label: run(label, trees[label]) for label in order}
        pairs.append(got)
    summary = {}
    for m in METRICS:
        side = {t: sorted(p[t][m] for p in pairs) for t in trees}
        summary[m] = {
            **{t: {"median": statistics.median(v),
                   "quartiles": statistics.quantiles(v, n=4)[::2]}
               for t, v in side.items()},
            "pairs_this_lower": sum(p["this"][m] < p["other"][m]
                                    for p in pairs),
            "pairs": len(pairs)}
    print("summary " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
