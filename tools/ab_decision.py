#!/usr/bin/env python3
"""This checkout against another one in one call, on one NVIDIA GPU.

    python3 tools/ab_decision.py OTHER_CHECKOUT
    python3 tools/ab_decision.py --kernels OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another checkout of this repository (e.g. the
parent commit unpacked with `git archive` into a directory that .gitignore
lists).

Decision mode runs PAIRS pairs, alternating which side runs first, of one
`batch_rollout` of the EAT actor on paper-8srv with sampler "ddpm" at
B = 256 (`chip_smoke.phase_main`: ms per decision over a 1024-decision
episode) and its short profiled rollout (`chip_smoke.phase_profile`:
device-busy ms and idle share), each in a fresh process in that checkout;
each builds its own kernels into its own build/. It prints every run, then
per metric each side's median and quartiles and how many pairs this
checkout won (lower ms, lower idle share).

Kernel mode builds the other checkout's `csrc/ssm_scan.cu` and
`csrc/env_step.cu` beside this checkout's, each with the repo's nvcc flags,
into `build/ab/`, and prints ptxas's registers and spills for each. Then,
on the same inputs, it times each library's kernel by CUDA events with the
host ahead of the card (`chip_smoke.device_ms_events`), in turns (each
side once forward and once backward: other, this, this, other), ROUNDS
times over, through this checkout's wrappers with the library swapped in:

* ssm_scan at Jamba's prefill (B = 1, S = 2048, I = 8192, random h0) at
  N = 16 in fp32 and bf16, and at N = 4 in fp32 (a quarter of the
  exponentials, shuffles and B/C reads, the same dt, x and y), with the
  largest difference of y from this checkout's kernel;
* env_step at paper-8srv (phase 2's timing state) at B = 256 and at B = 2
  (one block: one env's chain of steps alone on the card), with whether
  every output equals this checkout's; a third side, "general", is this
  checkout's source built with -DENV_STEP_GENERAL_ONLY, so that envs of
  at most 32 rows take the build for wider ones.

It prints one JSON line per shape and library: the card, each round's
device ms and their median.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAIRS = 10
ROUNDS = 5
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


def decisions(trees):
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


def build_lib(src: Path, tag: str, extra=()):
    """(library, nvcc log) of one source built with the repo's flags and
    `extra`."""
    from repro_torch.kernels import build as KB
    out = KB.BUILD_DIR / "ab" / f"{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [KB.nvcc_path(), *KB._flags(src.stem), *extra, "-o", str(out),
           str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out)), r.stdout + r.stderr


def in_turns(module, libs, call, iters):
    """{side: [device ms per round]} and {side: last output} of `call` with
    `module._lib` giving each side's library in turns."""
    import chip_smoke as C
    keep = module._lib
    times, outs = {k: [] for k in libs}, {}
    try:
        for _ in range(ROUNDS):
            for side in (*libs, *reversed(libs)):
                module._lib = lambda lib=libs[side]: lib
                times[side].append(C.device_ms_events(call, iters))
                outs[side] = call()
    finally:
        module._lib = keep
    return times, outs


def report(times, card, **fields):
    for side, ms in times.items():
        print("ab " + json.dumps({
            **fields, "lib": side, "card": card, "event_device_ms": ms,
            "median_ms": statistics.median(m for m in ms if m)}), flush=True)


def kernels(trees):
    import torch
    import chip_smoke as C
    from repro_torch.kernels.env_step import kernel as EK
    from repro_torch.kernels.ssm_scan import kernel as SK
    if not torch.cuda.is_available():
        sys.exit("ab_decision --kernels: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    ssm_libs, env_libs = {}, {}
    builds = [(side, root, kern, libs, ()) for side, root in trees.items()
              for kern, libs in (("ssm_scan", ssm_libs),
                                 ("env_step", env_libs))]
    builds.append(("general", ROOT, "env_step", env_libs,
                   ("-DENV_STEP_GENERAL_ONLY",)))
    for side, root, kern, libs, extra in builds:
        lib, text = build_lib(root / "src/repro_torch/csrc" / f"{kern}.cu",
                              f"{side}-{kern}", extra)
        libs[side] = lib
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {side} {kern}: {line.strip()}")
    for lib in ssm_libs.values():
        lib.ssm_scan_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 8
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.ssm_scan_launch.restype = ctypes.c_int
    for lib in env_libs.values():
        lib.env_step_launch.argtypes = [ctypes.POINTER(EK._Cfg),
                                        ctypes.POINTER(ctypes.c_void_p),
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.env_step_launch.restype = ctypes.c_int

    g = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    B, S, I = 1, 2048, 8192
    for N, dtype in ((16, torch.float32), (16, torch.bfloat16),
                     (4, torch.float32)):
        dt = torch.nn.functional.softplus(rnd(B, S, I)).to(dtype)
        a, h0 = -torch.exp(rnd(I, N)), rnd(B, I, N)
        bm, cm, x = (rnd(*s).to(dtype) for s in ((B, S, N), (B, S, N),
                                                 (B, S, I)))
        times, outs = in_turns(
            SK, ssm_libs, lambda: SK.ssm_scan(dt, a, bm, cm, x, h0)[0], 20)
        report(times, card, kernel="ssm_scan", shape=[B, S, I], N=N,
               dtype=str(dtype).replace("torch.", ""),
               max_abs_diff_vs_this=(outs["other"].float()
                                     - outs["this"].float()).abs().max()
               .item())

    flat = lambda o: [*o[0], *o[1], o[2], o[3], o[4]]  # noqa: E731
    for envs in (256, 2):
        _, (cfg, statics, st, act, q) = C.phase_env_step(
            dev, B=envs, Es=(8,), models=(1,), decisions=1, plan_B=3,
            extra=())
        plan = EK.EnvStepPlan(cfg, statics, act.shape[0], dev)
        times, outs = in_turns(EK, env_libs, lambda: plan(st, act, q), 200)
        same = all(torch.equal(u, v) for side in ("other", "general")
                   for u, v in zip(flat(outs[side]), flat(outs["this"])))
        report(times, card, kernel="env_step", cell="paper-8srv", B=envs,
               outputs_equal_this=same)


def main():
    args = sys.argv[1:]
    mode = decisions
    if args[:1] == ["--kernels"]:
        mode, args = kernels, args[1:]
    if len(args) != 1:
        sys.exit(__doc__)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    mode({"other": Path(args[0]).resolve(), "this": ROOT})


if __name__ == "__main__":
    main()
