#!/usr/bin/env python3
"""Where the denoiser_chain kernel's time goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit: `python3 tools/chain_steps.py`. It prints the kernel's device time
by CUDA events with the host ahead of the card (`chip_smoke.
device_ms_events`) at B in {1, 16, 256} and K in {0, 1, 10}, and at the
distiller's B = 4096, each with its largest error against the plain PyTorch
chain. The K = 0 and K = 1 rows give the fixed cost of a launch (weights
into shared memory) and of a first step; B = 1 and 16 (one cluster) against
B = 256 (16 clusters) show whether a step's time depends on the rows.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.actors import samplers as SMP  # noqa: E402
from repro_torch.core import diffusion as DF  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.denoiser import kernel as DK  # noqa: E402
from repro_torch.kernels.denoiser.ref import denoiser_chain_ref  # noqa: E402

A, F, H, T = 10, 16, 256, 10


def inputs(g, sched, p, B, K, kind="ddpm"):
    w = [t for layer in p["layers"] for t in (layer["w"], layer["b"])]
    c = SMP.chain_coeffs(sched, kind, None if kind == "ddpm" else K)
    x = torch.randn((B, A), generator=g, device="cuda")
    f_s = torch.randn((B, F), generator=g, device="cuda")
    noises = torch.randn((c.tembs.shape[0], B, A), generator=g, device="cuda")
    return (x, noises[:K].contiguous(), f_s, c.tembs[:K].contiguous(),
            c.coef_x[:K].contiguous(), c.coef_e[:K].contiguous(),
            c.coef_n[:K].contiguous(), *w)


def main():
    if not torch.cuda.is_available():
        sys.exit("chain_steps: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    KB.build(["denoiser_chain"])
    g = torch.Generator(device="cuda").manual_seed(3)
    sched = DF.vp_schedule(T, device="cuda")
    p = DF.init_denoiser(A, F, H, generator=g, device="cuda")
    cases = [(B, K, "ddpm") for B in (1, 16, 256) for K in (0, 1, T)]
    for B, K, kind in cases + [(4096, T, "ddim")]:
        args = inputs(g, sched, p, B, K, kind)
        out = DK.denoiser_chain(*args)
        err = (out - denoiser_chain_ref(*args)).abs().max().item()
        print("events " + json.dumps({
            "B": B, "K": K, "sampler": kind,
            "device_us": 1e3 * CS.device_ms_events(
                lambda: DK.denoiser_chain(*args), 200),
            "max_abs_err": err}), flush=True)


if __name__ == "__main__":
    main()
