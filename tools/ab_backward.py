#!/usr/bin/env python3
"""The two backward kernels of this checkout against another one's, in one
call, on one NVIDIA GPU.

    python3 tools/ab_backward.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another checkout of this repository (e.g. the
parent commit unpacked with `git archive` into a directory that .gitignore
lists). Each side runs in fresh processes in its own checkout, through its
own wrappers (`flash_attention_bwd`, `ssm_scan_bwd`: their C interfaces may
differ), and builds its own kernels into its own build/. In ROUNDS rounds
the sides run in turns (other, this, this, other); each run makes the same
inputs from the same seed and times, by CUDA events with the host ahead of
the card (`chip_smoke.device_ms_events`):

* flash_attention_bwd at tinyllama-1.1b's 2048-token layer (B = 1, H = 32,
  KV = 4, hd = 64, causal) in fp32 and bf16 and at Jamba's hd-128 layer
  (H = 32, KV = 8) in fp32, o and lse from the side's forward kernel;
* ssm_scan_bwd at Jamba's layer (B = 1, S = 2048, I = 8192, N = 16) in
  fp32 and bf16, the chunk states from the side's forward kernel.

It prints the card, every run, and per shape each side's median.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 3
RUN = r'''
import json, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import chip_smoke as C
from repro_torch.kernels import build as KB
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssm_scan import kernel as SK
from repro_torch.models.layers import softplus
torch.backends.cuda.matmul.allow_tf32 = False
KB.build(("flash_attention", "flash_attention_bwd", "ssm_scan", "ssm_scan_bwd"))
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(24)
rnd = lambda *s: torch.randn(s, generator=g, device=dev)
out = {}
for name, (B, S, H, KV, hd), dtype in (
        ("flash tinyllama fp32", (1, 2048, 32, 4, 64), torch.float32),
        ("flash tinyllama bf16", (1, 2048, 32, 4, 64), torch.bfloat16),
        ("flash jamba hd128 fp32", (1, 2048, 32, 8, 128), torch.float32)):
    q, k, v, do = (t.to(dtype).transpose(1, 2) for t in (
        rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd), rnd(B, S, H, hd)))
    o, lse = FK.flash_attention(q, k, v, causal=True, with_lse=True)
    out[name] = C.device_ms_events(
        lambda: FK.flash_attention_bwd(q, k, v, o, lse, do, causal=True), 10)
B, S, I, N = 1, 2048, 8192, 16
dt, a = softplus(rnd(B, S, I)), -torch.exp(rnd(I, N))
bm, cm, x, h0, dhT, dy = (rnd(B, S, N), rnd(B, S, N), rnd(B, S, I),
                          rnd(B, I, N), rnd(B, I, N), rnd(B, S, I))
for dtype in (torch.float32, torch.bfloat16):
    dt_, bm_, cm_, x_, dy_ = (t.to(dtype) for t in (dt, bm, cm, x, dy))
    _, _, hc = SK.ssm_scan(dt_, a, bm_, cm_, x_, h0, with_chunks=True)
    out["ssm_scan_bwd jamba " + ("fp32" if dtype == torch.float32 else "bf16")] = \
        C.device_ms_events(lambda: SK.ssm_scan_bwd(dt_, a, bm_, cm_, x_, hc, dy_, dhT), 10)
print("AB " + json.dumps(out), flush=True)
'''


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"ab_backward: the run in {tree} failed:\n{proc.stderr[-4000:]}")
    line = [l for l in proc.stdout.splitlines() if l.startswith("AB ")][-1]
    return json.loads(line[3:])


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    times = {"other": [], "this": []}
    for r in range(ROUNDS):
        for side in ("other", "this", "this", "other"):
            res = run(other if side == "other" else ROOT)
            times[side].append(res)
            print(f"round {r} {side}: " + json.dumps(res), flush=True)
    for shape in times["this"][0]:
        row = {"card": card, "shape": shape}
        for side, runs in times.items():
            vals = [t[shape] for t in runs if t[shape] is not None]
            row[side] = {"ms": vals,
                         "median": statistics.median(vals) if vals else None}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
