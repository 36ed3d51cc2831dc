#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit: `python3 chip_smoke.py`. It builds the hand-written kernels from
`src/repro_torch/csrc` into `build/` (one nvcc per source, in parallel) and
runs, one line per result:

1. the card's name and power limit, the kernels' build time, ptxas's
   registers and spills (no ssm_scan, ssm_scan_bwd or env_step
   instantiation may spill, nor the flash backward's at hd 64 and 128),
   and per kernel function the count of `wgmma`, TMA-load, `mma.sync` and
   MUFU instructions in its SASS (cuobjdump): every flash_attention and
   flash backward instantiation must issue `wgmma` and TMA loads, both
   denoiser kernels `mma.sync`, both scans MUFU (their exponentials);
2. the env_step kernel against its plain PyTorch version on random states
   (B = 256, E in {8, 12}, K = 32, l = 8, one and three models, with and
   without fault columns; E = 5, K = 30, whose rows are not 16-byte
   aligned, and E = 8, K = 40, wider than a warp, with and without
   faults), then through one `EnvStepPlan` kept over three decisions at
   B = 253, with and without faults: exact on ints, bools and the clock;
   the fault columns at K = 32 are a `FaultTimeline`'s arrays of
   `FaultSpec.chaos` (F = 16, the stream's layout), random at F = 4
   elsewhere;
3. the denoiser_chain kernel against its plain version (A = 10, H = 256;
   B in {1, 3, 16, 256, 300} x F in {12, 16, 20} x K = 10 DDPM and K = 5
   DDIM coefficients, and the distiller's K = 10 DDIM chain at N = 4096;
   F = 12 is the 4-server cell of phase 14);
4. the main path: `batch_rollout` of the EAT actor (random weights from a
   seed, the AgentConfig defaults) with samplers "ddpm" and "ddim:5" on the
   cells paper-8srv and paper-12srv (K = 32 tasks, B = 256 envs, a whole
   episode), with the kernels' launch counts, reset just before each run,
   and a short profiled rollout: device busy time and idle share. Every
   rollout of the script (phases 4, 5, 8-10, 15-19, but phase 19's
   reference backend) replays its decision as CUDA graphs
   (`actors/program.py`), and every serving decision of phase 20 the
   graph of `act`; their captures add their launches to the counts at
   every replay;
5. kernel path against plain path inside the loop: fifo closed loop,
   EAT teacher-forced, EAT closed loop on aggregate metrics;
6. a timing row per kernel: device and call time, plain-version time,
   bound and (flash_attention) `scaled_dot_product_attention`'s time, at
   the main path's shapes (ssm_scan at Jamba's 2048-token prefill); the
   redesigned kernels (all seven) also get CUDA-event device time and a
   note of what changed, flash_attention is timed at tinyllama's and
   Jamba's prefill in fp32 and bf16, SDPA beside each, and ssm_scan at
   Jamba's prefill in fp32 and bf16; the two backward kernels at phase
   22's tinyllama and Jamba layers, with SDPA's backward beside flash's
   (flash also at Jamba's hd-128 layer and both layers in bf16, the scan
   in bf16);
7. the denoiser_step kernel against its plain version (A = 10, H = 256,
   F in {16, 20}, B in {256, 300, 4096}, the timestep embedding one row
   per batch row and one row for all, and a 1-D input);
8. SAC training at full width on paper-8srv (`core.sac.train`: a uniform
   warmup round, then an actor round, 16 envs each) with the launch counts,
   ms per update_step and per collection decision, and one update_step on
   the card against the CPU from the same state, batch and draws;
9. consistency distillation of phase 8's actor (`DistillConfig()`
   defaults): the loss halves and the student tracks the teacher's DDIM
   endpoint on unseen draws;
10. the distilled main path: `batch_rollout` with sampler "distilled" at
   B = 256 on paper-8srv (phase 9's student) and paper-12srv (a random
   teacher and student), one denoiser_step launch per decision and no
   chain launch, kernel path against plain path; its profile counts the
   device events per decision, one step kernel and no embedding kernel;
11. the flash_attention kernel against its plain version, fp32 and bf16:
   tinyllama's prefill (B = 1, S = T = 2048, H = 32, KV = 4, hd = 64,
   causal), Jamba's (H = 32, KV = 8, hd = 128), a c = 4 chunk batch, hd
   128 and 256, full attention with S != T, sliding windows of 48, 40 and
   72 (the last two ending mid-tile), S = 17 / T = 33, S and T off the
   kernel's tiles, and the new families' shapes: whisper's encoder (S = T
   = 1500, 12 / 12 heads of 64, full) and cross-attention (256 queries
   against 1500 keys), olmoe's prefill (2048, 16 / 16 heads of 128,
   causal) and internvl2's (256 patches + 256 tokens, 14 / 2 heads of 64);
12. the serving main path: a `ServingEngine` of 8 servers serving
   tinyllama-1.1b at full width (1.1 B parameters, fp32) in virtual time,
   16 requests of a paper-8srv trace (prompts of 256-2048 tokens), every
   decision from phase 8's actor on `engine.observe()`, every prefill layer
   a flash_attention launch; per request the prefill and decode times, the
   QoS summary, peak device memory, the served logits and tokens against
   the plain attention on three requests of different c, each compared
   as soon as it is served, and a profiled generate at S = 2048;
13. the ssm_scan kernel against its plain version: Jamba's prefill
   (B = 1, S = 2048, I = 8192, N = 16) from a zero and a random state,
   S and I ragged, S = 1, N = 4, Jamba's prefill in bf16 and with B and C
   split from x_proj, S off the 64-step chunk (2047, 129) and shorter than
   one 8-step run (5), B = 2 with I = 520 in bf16 and at N = 4, strong
   decays (dt up to 8, A down to -e^3), and the staging's narrower paths:
   B and C split at 2-byte (bf16) and 8-byte (fp32) offsets, bf16 at
   N = 4, and I = 518 (fp32) and 517 (bf16), rows off 16 bytes;
14. the hybrid served: phase 12's function on a 4-server engine serving
   one Jamba period without experts (four copies of the period with its
   experts, 49.4 GiB each, do not fit the card) at full width
   (`jamba-v0.1-52b-8l-dense`: 8 layers, 7 Mamba + 1 attention, 2.7 B
   parameters, fp32), 16 requests of a trace at 0.05 tasks/s, every
   decision from a seeded random EAT actor for 4 servers, every Mamba
   prefill layer an ssm_scan launch and the attention layer a
   flash_attention launch; the logits and tokens against the plain scan
   and attention on two requests of different prompt length;
15. the decision graph (`actors/program.py`): on paper-8srv and
   paper-12srv at B = 256, with fifo, uniform, ddpm, ddim:5 and distilled,
   a whole episode graphed (capture ms, launches per decision) and
   graphed against eager (`graph=False`) collecting a whole episode,
   equal in every tensor; 10 alternating pairs of 256-decision runs each
   way (wall ms per decision); a profile of each way (device busy, idle
   share); the uniform run's actions replayed by `sequence_policy`
   graphed and eager (exact); a ddpm rollout on new weights, which the
   graph reads; `ActorProgram.act` at B = 1 against the eager policy;
16. the paper's comparison on `paper_scenarios()` (4, 8 and 12 servers):
   Random, FIFO, Greedy and EAT (phase 8's actor on paper-8srv, seeded
   random actors on the other two) on 256 traces per cell, Genetic and
   Harmony at their defaults on one trace per cell; mean response,
   quality, reload rate and return, ms per decision; Greedy on the card
   against Greedy on the CPU, closed loop on 8 traces;
17. PPO on paper-8srv (`train_ppo`, 3 rounds of 16 envs) with ms per
   collection decision and per `ppo_update`, one `ppo_update` on the card
   against the CPU; `sac.train` one round with `demo_episodes` and one
   with `curriculum=training_curriculum`;
18. the stream (`traffic/stream.py`) on paper-8srv: one window from a
   fresh carry against `batch_rollout` (ddpm and fifo, every tensor; the
   window's carry, stats and leftovers against the seam of the
   rollout's final state), then 256 streams x 8 windows of 128 ddpm decisions (phase 8's actor)
   with Poisson arrivals at 0.1 tasks/s, `FaultSpec.chaos`, forecast
   placement every second seam and a recording tracer: the seam ledger
   after every window, the decision graph captured in window 0 only (its
   loop in fault mode), one env_step and one chain launch per decision;
   ms per window, the split by span, ms per decision, the idle share of a
   profiled window; fifo and greedy streams on the card against the CPU
   (8 streams x 6 windows, same faults and placement); the trace under
   the strict schema; `profile_policy` for ddpm at batch 0 and 256 (the
   host clock around the synchronised decision, the reference's measure)
   and, on a line of its own, the same decisions timed by CUDA events;
19. the API facade (`repro_torch.api`) on paper-8srv at the paper's
   widths: `Simulator` episodic at B = 256 for every registered policy
   (random, fifo, greedy, EAT ddpm on phase 8's actor, EAT distilled on
   phase 9's student, PPO on phase 17's state, genetic and harmony at
   their defaults), each equal to a direct `batch_rollout` on the same
   traces and generator in every metric tensor, one env_step launch a
   decision, one chain a ddpm decision, one step a distilled one; the
   reference backend against fused (fifo and greedy exact, EAT on
   aggregates); streaming, 64 streams x 2 windows of 128 tasks with
   chaos faults, forecast placement, a recording tracer with
   `profile_decisions` and `metrics_path`, equal to a direct `run_stream`;
   `train_stream_sac` (2 rounds of 16 streams, at most 8 updates each)
   and `train_stream_ppo` (1 round), the first round's transitions equal
   to a `StreamRunner` window; `run_sweep` over the paper cells with fifo
   and greedy;
20. the serving backend (`serving/backend.py`, `runner.py`) on
   `multi_model_mix(8, 3)`, one stream: the mirror against the fused
   backend at B = 1 (fifo, greedy, EAT closed loop and teacher-forced:
   every record, carry and transition equal); executed in virtual time
   at full width with tinyllama-1.1b, qwen2-1.5b and llama3.2-3b (fp32,
   256-token prompts, 16 tasks): the MDP equal to the mirror's, one chain
   launch a decision, one flash_attention launch an attention layer of
   every executed prefill, per task the load and generate ms, the span
   split and peak memory; wall-clock mode (tinyllama-1.1b, 8 tasks) with
   injected executor errors, retries counted and the patched reward and
   obs held to the CPU; `serve_stream` one window;
21. the rest of the model zoo served (ROADMAP Queue 1 item 13): (a) the
   serving backend at its default, `ExecSpec(backend="serving")` with no
   `serving_archs` (the reference's ten `ASSIGNED_ARCHS`, reduced), on an
   8-server env with ten models through `api.evaluate_batch`, phase 8's
   actor deciding, the trace's first ten tasks carrying model ids 0-9:
   every arch served, each arch's first served request held to the plain
   attention and scan, one flash_attention launch per attention layer
   (whisper: per encoder layer and per decoder self- and cross-attention)
   and one ssm_scan launch per Mamba layer of every prefill; (b) cell
   serve-olmoe-2srv: phase 12's function on a 2-server engine serving
   olmoe-1b-7b at full width (6.9 B parameters, fp32, 64 experts, top-8)
   at 0.025 tasks/s, gangs of 1 or 2, 16 requests, a seeded random EAT
   actor for 2 servers, two requests of different c held to the plain
   attention, a profiled generate at S = 2048; (c) whisper-small,
   internvl2-1b, xlstm-125m and one Jamba period with its experts
   (`jamba-v0.1-52b-8l`, 49.4 GiB) at full width, one copy each, through
   `ModelExecutor.generate` on prompts of 256 and 1024 tokens: load,
   prefill and decode ms, launches per prefill against what the model's
   structure gives (36, 24, 0, and 1 flash + 7 ssm_scan), every request
   held to the plain attention and scan;
22. training through the model zoo (ROADMAP Queue 1 item 13's training
   part), run after phase 7, before the long phases: (a) the flash
   backward kernel (`csrc/flash_attention_bwd.cu`) against
   `attention_bwd_ref` on the same q, k, v, dO and the forward kernel's o
   and lse (its lse against the plain log-sum-exp), fp32 and bf16, at
   tinyllama's and Jamba's 2048-token layers, a sliding window of 512,
   whisper's cross-attention (448 tokens against 1500 frames), hd 256
   and S, T off the tiles, two calls equal bit for bit on each; (b) the
   forward scan's chunk states against
   the plain scan's, and the scan backward kernel (`csrc/
   ssm_scan_bwd.cu`) against `ssm_scan_bwd_ref` at Jamba's layer in fp32
   and bf16, a ragged S = 2000, B and C split from x_proj, and N = 4, two
   calls equal bit for bit on each; (c)
   one loss and gradient on the kernels against the plain versions
   (`impl="ref"`), every leaf, at full width with the depth cut:
   tinyllama-1.1b to 2 layers and the Jamba cut to one Mamba and one
   attention layer, batch 1 x 2048; (d) the slice's full-width path,
   `launch.train`'s `train_lm` on tinyllama-1.1b (fp32, batch 4 x 2048,
   4 steps): ms a step (beside the step before the backward kernels'
   redesign), loss and grad norm per step, peak memory, 22 +
   22 flash launches a step, and one profiled step whose recorded kernel
   events equal the launches counted; (e) `train_lm` on the Jamba cut at
   full width (2.7 B parameters, batch 1 x 2048, 2 steps): ms a step
   (likewise), 7 + 7 scan and 1 + 1 flash launches a step; (f) the ten ASSIGNED_ARCHS reduced,
   two train steps each, kernels against the plain versions on the
   loss and grad norm; (g) env_step, denoiser_chain and denoiser_step
   raise on CUDA inputs that require grad (they have no backward);
23. the multi-device and launch layer (ROADMAP item 15): (a) the
   sharded backend (`ExecSpec(backend="sharded")`) on paper-8srv at
   B = 256, fifo and ddpm, a whole episode collected: one shard equal to
   fused in every tensor, a mesh of 4 shards on the one card equal to the
   four fused runs of 64 with `split_generator`'s children (and to fused
   on all 256 for fifo), one env_step launch a decision a shard; ms a
   decision of fused, 1 and 4 shards in rotating rounds; (b)
   `launch.steps.build_case` for tinyllama-1.1b at full width on a
   1-device mesh (bf16 compute, remat, fp32 params): a train step at
   batch 4 x 2048 with microbatches 1 and 2 from the same params (loss
   within 2e-3 relative, every param within 5e-3), 44 + 22 flash launches
   a microbatch, ms a step, peak memory, idle share, then a prefill at
   1 x 2048 and a decode step; (c) `launch.serve.run`, the serving CLI's
   loop, at full width with qwen2-1.5b and tinyllama-1.1b on 4 servers,
   12 tasks, fifo and eat: every task completes, one flash launch per
   attention layer of every prefill, and the fifo run's records and tokens
   equal to the same run on the plain attention;
24. the dry-run and the roofline (ROADMAP item 15's analysis), last: (a)
   `python -m repro_torch.launch.dryrun` for xlstm-125m at decode_32k on
   the 512-rank mesh and tinyllama-1.1b at train_4k on the 256-rank mesh,
   side by side in subprocesses on the host (meta tensors over a fake
   process group: no kernel, no device memory), each an ok record;
   (b) `launch.roofline.analytic_terms` at one device for 23b's train
   step, prefill and decode step, each bound beside 23b's measured ms
   (a measured time below its bound fails);
then the phase 6 rows (the two backward kernels among them), a `kernels`
JSON line after the card's `nvidia-smi` line, and
`{"ok": true, "device": {...}}` as the last line.

A failing phase raises and the script exits non-zero; nothing is caught.
Without CUDA it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, fp32 rate
# outside the tensor cores, dense TF32 and bf16 rates of the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12
BF16_FLOP_PER_S = 989e12
CHAIN_ATOL = 1e-4     # ~10x the fp32-vs-fp64 gap of the plain chain
STEP_ATOL = 1e-5      # one MLP pass: fp32 sums in another order, a tanh
ENV_ATOL = 1e-5       # quality / obs / reward (exp and a reordered sum)
LOSS_RTOL = 1e-4      # one SAC update, card against CPU
# served prefill logits, kernels against the plain attention and scan,
# relative to the largest |logit|: each attention layer differs by ~1e-6 of
# its unit-scale output (phase 11), each scan by ~1e-7 of max|y| (phase
# 13), and fp32 sums over d_model add ~1e-6 more per layer; tinyllama's 22
# layers or a Jamba period's 8 compound that to ~1e-5 at most. 1e-3 leaves
# that 100x of room while a wrong mask, GQA map, tile edge or state carry
# moves the logits by O(1).
LOGIT_RTOL = 1e-3
KERNELS = ("env_step", "denoiser_chain", "denoiser_step", "flash_attention",
           "ssm_scan", "flash_attention_bwd", "ssm_scan_bwd")
# the redesigned kernels and what changed (their earlier times are in
# PERF.md section 6)
REDESIGNED = {
    "env_step": ("kernel: one round of loads per env into shared memory, "
                 "no reads back, a one-warp build for envs of <= 32 rows, 2 "
                 "envs per block; call: EnvStepPlan"),
    "denoiser_chain": ("8-CTA cluster, resident weights, 3xTF32 mma, "
                       "bulk-copy exchanges"),
    "denoiser_step": ("one step of the chain's cluster (mlp_common.cuh), "
                      "x, temb and f_s read in place, no concat"),
    "flash_attention": ("TMA ring + producer warp, wgmma with Q and P from "
                        "registers, 3xTF32 for fp32, bf16 native"),
    "ssm_scan": ("S split over a block's threads: 32 channels x 8 segments, "
                 "runs folded, shuffle scan with the chunk carry, one "
                 "ex2.approx per state and step, cp.async ring"),
    "flash_attention_bwd": ("both kernels on wgmma with TMA rings (3xTF32 "
                            "for fp32, bf16 native), S^T and dP^T taken "
                            "transposed in the dK / dV kernel, one CTA per "
                            "query head with per-head partials summed in "
                            "head order by the last CTA"),
    "ssm_scan_bwd": ("the forward's block (32 channels x 8 segments): "
                     "states rebuilt by the forward's fold and scan, G by "
                     "the same scan from the right, one ex2.approx per "
                     "state and step, dB / dC reduce-scattered, I / 32 "
                     "partials summed by a second launch")}
# exponentials per second on the special-function units: 16 per clock per
# SM (Hopper white paper: 4 per SM sub-partition), 132 SMs, 1.98 GHz boost
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# ssm_scan against its plain version, relative to max(1, max|y|): fp32 at
# tests/test_kernels.py's 2e-5 (the same recurrence, y's sum over N in
# another order); bf16 at 1e-2: the plain version forms dt*x in bf16 (as
# the reference does, 2^-9 relative) where the kernel keeps it in fp32, and
# the two y round to bf16 apart by at most one ulp (2^-8 relative)
SSM_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# (case, B, S, I, N, dtype, random h0, dt_rank: B and C split from a
# (B, S, dt_rank + 2N) tensor as x_proj gives them, or 0 for contiguous,
# dt_max: 0 for dt = softplus(randn) and A = -exp(randn) as in the model,
# else strong decays, dt uniform in [0, dt_max) and A = -exp(U(-3, 3)))
SSM_CASES = (
    ("jamba prefill, zero h0", 1, 2048, 8192, 16, torch.float32, False, 0, 0),
    ("jamba prefill, random h0", 1, 2048, 8192, 16, torch.float32, True, 0,
     0),
    ("S and I ragged", 2, 300, 520, 16, torch.float32, True, 0, 0),
    ("one step", 1, 1, 64, 16, torch.float32, True, 0, 0),
    ("N = 4", 1, 7, 16, 4, torch.float32, True, 0, 0),
    ("jamba prefill bf16", 1, 2048, 8192, 16, torch.bfloat16, True, 0, 0),
    ("jamba prefill, B and C split from x_proj", 1, 2048, 8192, 16,
     torch.float32, True, 256, 0),
    ("S = 2047, off the chunk", 1, 2047, 8192, 16, torch.float32, True, 0, 0),
    ("S = 129, one step past two chunks", 2, 129, 1024, 16, torch.float32,
     True, 0, 0),
    ("S = 5, shorter than a run", 1, 5, 256, 16, torch.float32, True, 0, 0),
    ("B = 2, I = 520, bf16", 2, 300, 520, 16, torch.bfloat16, True, 0, 0),
    ("B = 2, I = 520, N = 4, B and C split", 2, 300, 520, 4, torch.float32,
     True, 3, 0),
    ("strong decays", 1, 2048, 1024, 16, torch.float32, True, 0, 8.0),
    # the staging's narrower paths: 2-byte loads of B and C (bf16 split at
    # an odd offset), 8-byte copies of B and C (fp32 split at 8 bytes) and
    # of bf16 rows of N = 4, and rows of dt, x and y off 16 bytes (y stored
    # element by element; dt and x by 8-byte copies in fp32, 2-byte loads
    # in bf16)
    ("bf16, B and C split at dt_rank 3", 2, 300, 520, 16, torch.bfloat16,
     True, 3, 0),
    ("B and C split at dt_rank 2", 2, 300, 520, 16, torch.float32, True, 2,
     0),
    ("bf16, N = 4", 2, 300, 520, 4, torch.bfloat16, True, 0, 0),
    ("I = 518, rows off 16 bytes", 2, 129, 518, 16, torch.float32, True, 0,
     0),
    ("bf16, I = 517, rows on 2 bytes", 1, 300, 517, 16, torch.bfloat16,
     True, 0, 0),
)
# phase 14's config: one period of Jamba (7 Mamba + 1 attention layer) at
# full width with dense FFNs, registered in the port's registry at run time
JAMBA_CUT = "jamba-v0.1-52b-8l-dense"
# flash_attention against its plain version: the tolerances of
# tests/test_kernels.py (fp32 2e-5; bf16 3e-2 against fp32 attention of the
# same bf16 inputs), rtol = atol
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# (case, B, S, T, H, KV, hd, causal, window); the kernel's tiles are 128
# query rows (64 at hd 256) by 64 keys (32 for fp32 at hd 128 and 256)
FA_CASES = (
    ("tinyllama prefill", 1, 2048, 2048, 32, 4, 64, True, 0),
    ("jamba prefill", 1, 2048, 2048, 32, 8, 128, True, 0),
    ("c=4 chunk batch", 4, 512, 512, 32, 4, 64, True, 0),
    ("hd 128 (qwen2 heads)", 2, 300, 300, 12, 2, 128, True, 0),
    ("hd 256 (gemma heads)", 1, 200, 200, 16, 16, 256, True, 0),
    ("full, S != T", 2, 96, 160, 8, 4, 64, False, 0),
    ("window 48, tiles of 64", 1, 256, 256, 8, 2, 64, True, 48),
    ("S=17 T=33", 1, 17, 33, 4, 1, 64, False, 0),
    ("S, T off the tiles, causal", 2, 200, 333, 8, 2, 64, True, 0),
    ("S, T off the tiles, hd 128 full", 1, 77, 150, 4, 2, 128, False, 0),
    ("window 40 ends mid-tile", 1, 300, 300, 8, 2, 64, True, 40),
    ("window 72 ends mid-tile, hd 128", 1, 300, 300, 8, 2, 128, True, 72),
    ("whisper encoder", 1, 1500, 1500, 12, 12, 64, False, 0),
    ("whisper cross-attention", 1, 256, 1500, 12, 12, 64, False, 0),
    ("olmoe prefill", 1, 2048, 2048, 16, 16, 128, True, 0),
    ("internvl2 prefill", 1, 512, 512, 14, 2, 64, True, 0),
)
CELLS = (("paper-8srv", 8, 0.1), ("paper-12srv", 12, 0.15))
# phase 22: the backward kernels against their plain versions, relative to
# each gradient's largest magnitude. Flash: fp32 2e-4 (the kernel sums its
# fp32 products in tile order, the plain version in einsum order, over up
# to T = 2048 keys; the forward's o and lse that both start from come from
# the kernel); bf16 3e-2 (the gradients round to bf16, 2^-8, and the plain
# version computes from the same bf16 inputs in fp32). Scan: fp32 1e-4
# (the kernel's ex2.approx, ~2 ulp, against exp, through a recurrence of
# up to 2048 steps); bf16 3e-2 (the plain version forms dt * x in bf16, the
# kernel in fp32, and the gradients round to bf16). The chunk states at the
# forward's SSM_TOL.
FA_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
SSM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LSE_TOL = 1e-5        # of max(1, max|lse|): fp32 log-sum-exp of each row
# (case, B, S, T, H, KV, hd, causal, window): the training shapes
FA_BWD_CASES = (
    ("tinyllama layer", 1, 2048, 2048, 32, 4, 64, True, 0),
    ("jamba layer, hd 128", 1, 2048, 2048, 32, 8, 128, True, 0),
    ("sliding window 512", 1, 2048, 2048, 32, 4, 64, True, 512),
    ("whisper cross-attention", 1, 448, 1500, 12, 12, 64, False, 0),
    ("hd 256", 1, 512, 512, 16, 16, 256, True, 0),
    ("S, T off the tiles, causal", 2, 200, 333, 8, 2, 64, True, 0),
)
# (case, B, S, I, N, dtype, dt_rank: B and C split from x_proj, or 0)
SSM_BWD_CASES = (
    ("jamba layer", 1, 2048, 8192, 16, torch.float32, 0),
    ("jamba layer bf16", 1, 2048, 8192, 16, torch.bfloat16, 0),
    ("S = 2000, a ragged last chunk", 1, 2000, 8192, 16, torch.float32, 0),
    ("B and C split from x_proj", 1, 2048, 8192, 16, torch.float32, 256),
    ("B = 2, I = 520, N = 4, split", 2, 300, 520, 4, torch.float32, 3),
)
# one train step, kernels against the plain versions: the loss relative,
# each gradient leaf relative to its largest magnitude
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-3
TRAIN_ARCH = "tinyllama-1.1b"
# the backward kernels: not Pallas kernels, the backward of two that are
BACKWARD_OF = {
    "flash_attention_bwd": ("not a Pallas kernel: the backward of "
                            "src/repro/kernels/flash_attention/kernel.py:83, "
                            "the reference's custom VJP flash_bwd"),
    "ssm_scan_bwd": ("not a Pallas kernel: the backward of "
                     "src/repro/kernels/ssm_scan/kernel.py:61, autodiff "
                     "through the reference's checkpointed chunks")}


def log(*parts):
    print(*parts, flush=True)


# SASS instructions that show a kernel on the card's own units: `wgmma`
# (HGMMA), TMA loads (UTMALDG), `mma.sync` (HMMA) and the special-function
# unit (MUFU); which kernel functions must issue which (every instantiation
# of the flash kernel, both cluster kernels, the scan)
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "MUFU")
SASS_NEEDS = {"flash_attention_kernel": ("HGMMA", "UTMALDG"),
              "chain_cluster_kernel": ("HMMA",),
              "step_cluster_kernel": ("HMMA",),
              "ssm_scan_kernel": ("MUFU",),
              "ssm_scan_bwd_kernel": ("MUFU",),
              "flash_bwd_": ("HGMMA", "UTMALDG")}
# kernels whose instantiations may not spill (ptxas -v, phase 1), and
# kernels of which only the functions whose names hold a tag may not (the
# flash backward at hd 64 and 128; hd 256 has narrower plans)
NO_SPILLS = ("ssm_scan", "env_step", "ssm_scan_bwd")
NO_SPILLS_AT = {"flash_attention_bwd": ("Li64E", "Li128E")}


def sass_counts(name):
    """{kernel function (mangled): {instruction: count}} of SASS_OPS in the
    built library of kernel `name`, read with the toolkit's cuobjdump."""
    from repro_torch.kernels import build as KB
    tool = Path(KB.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(KB.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    counts, fn = {}, None
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in pattern.findall(line):
                counts[fn][op] += 1
    return counts


def check_ptxas(names):
    """Logs ptxas's registers and spills per kernel function from each
    library's build log and fails where a kernel of NO_SPILLS, or a
    function of NO_SPILLS_AT, spills."""
    from repro_torch.kernels import build as KB
    for name in names:
        fn = None
        for line in KB.build_log_path(name).read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            if "registers" in line or "spill" in line:
                log(f"phase 1 ptxas {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            guarded = name in NO_SPILLS or any(
                tag in (fn or "") for tag in NO_SPILLS_AT.get(name, ()))
            if m and guarded:
                assert m.group(1) == m.group(2) == "0", (name, fn, line)


def check_sass(names):
    """Logs SASS_OPS per kernel function and fails where a kernel of
    SASS_NEEDS lacks an instruction it must issue."""
    for name in names:
        for fn, ops in sass_counts(name).items():
            log(f"phase 1 sass {name}: {fn[:120]} {json.dumps(ops)}")
            for kernel, need in SASS_NEEDS.items():
                if kernel in fn:
                    assert all(ops[op] > 0 for op in need), (fn, ops, need)


# ----------------------------------------------------------------- inputs
def np_traces(rng, B, K, E, num_models, faults, F=4, rate=0.2,
              timeline=None):
    """Random traces; with `faults`, random fault arrays of F intervals, or
    where `timeline` (a `FaultTimeline` over B streams and E servers) is
    given, its first window's arrays at stream epochs drawn from `rng` (F
    is then the spec's `max_down_events`; crashes that began before an
    epoch give negative starts)."""
    support = np.array([c for c in (1, 2, 4, 8) if c <= E])
    probs = np.array([0.35, 0.35, 0.2, 0.1])[:len(support)]
    gaps = (rng.exponential(size=(B, K)) / rate).astype(np.float32)
    tr = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
          "c": rng.choice(support, (B, K), p=probs / probs.sum()).astype(np.int32),
          "model": rng.integers(0, num_models, (B, K)).astype(np.int32),
          "noise": (0.004 * rng.standard_normal((B, K))).astype(np.float32)}
    if faults and timeline is not None:
        from repro_torch.faults import fault_horizon
        t0 = np.sort(rng.uniform(0.0, 2000.0, B))
        tr.update(timeline.window_arrays(
            0, t0, fault_horizon(float(tr["arr_time"][:, -1].max()),
                                 timeline.spec)))
    elif faults:
        ds = rng.uniform(0.0, 80.0, (B, E, F)).astype(np.float32)
        de = (ds + rng.uniform(1.0, 30.0, (B, E, F))).astype(np.float32)
        pad = rng.random((B, E, F)) < 0.4
        tr["f_down_start"] = np.where(pad, 1e30, ds).astype(np.float32)
        tr["f_down_end"] = np.where(pad, 1e30, de).astype(np.float32)
        tr["f_slow"] = rng.uniform(1.0, 2.0, (B, E)).astype(np.float32)
        tr["f_cold"] = (rng.random((B, 1)) < 0.5).astype(np.float32)
    return tr


def np_states(rng, B, E, K, num_models):
    """Random env states as in tests/test_env_step_kernel.py::_random_state:
    warm and cold servers, intact and broken gangs, carried labels in
    [K, K+E), tasks in every status."""
    out = []
    for _ in range(B):
        t = np.float32(rng.uniform(0.0, 60.0))
        free = np.where(rng.random(E) < 0.5, 0.0,
                        t + rng.uniform(-20.0, 40.0, E)).astype(np.float32)
        gang, gsize, model = (-np.ones(E, np.int32), np.zeros(E, np.int32),
                              -np.ones(E, np.int32))
        servers, i = rng.permutation(E), 0
        while i < E and rng.random() < 0.8:
            c = min(int(rng.choice([1, 2, 4, 8])), E - i)
            members = servers[i:i + c]
            gang[members] = int(rng.integers(0, K + E))
            gsize[members] = c if rng.random() < 0.8 else int(rng.integers(1, 9))
            model[members] = int(rng.integers(0, num_models))
            i += c
        status = rng.choice([0, 0, 1, 2], K).astype(np.int32)
        tstart = np.where(status >= 1, rng.uniform(0, t, K), 0).astype(np.float32)
        tfin = np.where(status >= 1, tstart + rng.uniform(1, 50, K),
                        0).astype(np.float32)
        out.append(dict(
            time=t, server_free_at=free, server_model=model, server_gang=gang,
            server_gang_size=gsize, task_status=status, task_start=tstart,
            task_finish=tfin, task_steps=rng.integers(0, 50, K).astype(np.int32),
            task_quality=rng.uniform(0, 0.3, K).astype(np.float32),
            task_reload=rng.integers(0, 2, K).astype(np.int32),
            steps_taken=np.int32(rng.integers(0, 100))))
    return {k: np.stack([s[k] for s in out]) for k in out[0]}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def to_dev(d, dev):
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in d.items()}


# ----------------------------------------------------------------- timing
def time_ms(fn, iters, warmup=3):
    """Mean ms of one call over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_events(fn, iters=200, warmup=3):
    """Mean device ms per call of `fn` by CUDA events with the host ahead
    of the card: a spin kernel (`torch.cuda._sleep`, sized at twice the
    host's time to enqueue the calls) holds the stream while the host
    enqueues all `iters` calls, so the events time the device work back to
    back and none of the host's. None when the spin ended before the last
    call was enqueued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1000000)   # ~2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if ahead else None


def kernel_device_ms(fn, name, iters=20, per_call=1):
    """(mean device ms per call of the kernels whose names hold `name`,
    launches the profiler recorded) over `iters` calls under
    torch.profiler, a call being `per_call` such launches; (None, 0) when
    it records none. The mean is over the recorded device events: late in
    a long process the profiler can record fewer launches than were made,
    and `key_averages()`'s total over `iters` then under-counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type != torch.autograd.DeviceType.CPU and name in e.name]
    return (per_call * sum(us) / len(us) / 1e3, len(us)) if us else (None, 0)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _wrappers():
    """{name: wrapper} of the seven kernels: the five whose `launches`
    counters the decision graphs keep true through replays, and the two
    backward kernels."""
    from repro_torch.actors.program import kernel_wrappers
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bwd
    return {w.__name__: w for w in (*kernel_wrappers(), flash_attention_bwd,
                                    ssm_scan_bwd)}


def reset_counts():
    """Every kernel's launch count to 0, just before a main-path run."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


@contextlib.contextmanager
def uncounted():
    """Launches inside (a kernel held to its plain version in the middle of
    a main-path run) leave the counts as they were."""
    saved = read_counts()
    yield
    for name, fn in _wrappers().items():
        fn.launches = saved[name]


# ----------------------------------------------------------------- phases
def _env_step_same(got, want, ctx):
    """The kernel's outputs against the plain version's: exact on every
    integer, boolean and the clock; quality, obs and reward within ENV_ATOL.
    Returns the largest float error."""
    from repro_torch.core import env as EV
    worst = 0.0
    for name in EV.EnvState._fields:
        g, w = getattr(got[0], name), getattr(want[0], name)
        assert g.dtype == w.dtype, f"{ctx}: {name} dtype"
        if name == "task_quality":
            err = (g - w).abs().max().item()
            assert err <= ENV_ATOL, f"{ctx}: {name} {err}"
            worst = max(worst, err)
        else:
            assert torch.equal(g, w), f"{ctx}: {name} differs"
    for name in EV.QueueView._fields:
        assert torch.equal(getattr(got[1], name),
                           getattr(want[1], name)), f"{ctx}: q.{name}"
    assert torch.equal(got[4], want[4]), f"{ctx}: done"
    for name, g, w in (("obs", got[2], want[2]), ("reward", got[3], want[3])):
        err = (g - w).abs().max().item()
        assert err <= ENV_ATOL * max(1.0, w.abs().max().item()), \
            f"{ctx}: {name} err {err}"
        worst = max(worst, err)
    return worst


def _env_actions(rng, B, A, l, step, decisions):
    a = rng.uniform(size=(B, A)).astype(np.float32)
    a[::2, 0] = 0.1
    if step == decisions - 1:   # NaN actions: defined path
        a[0::8, 2 + step % l] = np.nan
        a[2::8, 2:] = np.nan
        a[4::8, 1] = np.nan
        a[1::8, :] = np.nan
    return a


def phase_env_step(dev, B=256, K=32, l=8, Es=(8, 12), models=(1, 3),
                   decisions=3, plan_B=253, extra=((5, 30), (8, 40))):
    """env_step kernel vs plain version through `env_step_fused` (a plan
    built per call) on every E in `Es` x models at K tasks, and on each
    (E, K) of `extra` with one model: E = 5, K = 30 gives rows of 20 and
    120 bytes, off 16-byte boundaries, and K = 40 > 32 runs the kernel's
    instantiation for envs wider than a warp; then through one
    `EnvStepPlan` kept across decisions at B = `plan_B` (not a multiple of
    the kernel's 2 envs per block), with and without faults; returns (max
    float error, timing inputs at the paper-8srv main-path shape). The
    fault cases at K tasks take their arrays from a `FaultTimeline` of
    `FaultSpec.chaos` (F = 16 intervals, the stream's layout, as phase 18
    runs it); those of `extra` take random ones at F = 4, denser in
    downtime."""
    from repro_torch.core import env as EV
    from repro_torch.faults import FaultSpec, FaultTimeline
    from repro_torch.kernels.env_step import kernel as EKK
    from repro_torch.kernels.env_step import ops as EK
    worst, timing = 0.0, None
    shapes = [(E, K, nm, E * 10 + nm) for E in Es for nm in models] \
        + [(E, Ku, 1, 1000 + E * 10 + Ku) for E, Ku in extra]
    for E, Ku, nm, seed in shapes:
        for faults in (False, True):
            rng = np.random.default_rng(seed + 100 * faults)
            ms = (1.0, 0.5, 2.0)[:nm] if nm > 1 else ()
            cfg = EV.EnvConfig(num_servers=E, max_tasks=Ku, queue_window=l,
                               num_models=nm, model_scale=ms)
            tl = FaultTimeline(FaultSpec.chaos(seed), E, B) \
                if faults and Ku == K else None
            tr = to_dev(np_traces(rng, B, Ku, E, nm, faults, timeline=tl),
                        dev)
            st = EV.EnvState(**to_dev(np_states(rng, B, E, Ku, nm), dev))
            statics = EV.decision_statics(cfg, tr)
            q = EV.visible_queue(cfg, tr, st)
            for step in range(decisions):
                a = torch.from_numpy(_env_actions(
                    rng, B, cfg.action_dim, l, step, decisions)).to(dev)
                if (E, Ku, nm, faults, step) == (Es[0], K, 1, False, 0):
                    timing = (cfg, statics, st, a, q)
                got = EK.env_step_fused(cfg, statics, st, a, q)
                want = EK.env_step_fused(cfg, statics, st, a, q, impl="ref")
                sync(dev)
                worst = max(worst, _env_step_same(
                    got, want, f"env_step E={E} K={Ku} nm={nm} "
                    f"faults={faults} step={step}"))
                st, q = want[0], want[1]
    for faults in (False, True):
        rng = np.random.default_rng(7 + faults)
        E = Es[0]
        cfg = EV.EnvConfig(num_servers=E, max_tasks=K, queue_window=l)
        tl = FaultTimeline(FaultSpec.chaos(7), E, plan_B) if faults \
            else None
        tr = to_dev(np_traces(rng, plan_B, K, E, 1, faults, timeline=tl),
                    dev)
        st = EV.EnvState(**to_dev(np_states(rng, plan_B, E, K, 1), dev))
        statics = EV.decision_statics(cfg, tr)
        q = EV.visible_queue(cfg, tr, st)
        plan = EKK.EnvStepPlan(cfg, statics, plan_B, dev)
        kept = []
        for step in range(decisions):
            a = torch.from_numpy(_env_actions(
                rng, plan_B, cfg.action_dim, l, step, decisions)).to(dev)
            got = plan(st, a, q)
            want = EK.env_step_fused(cfg, statics, st, a, q, impl="ref")
            sync(dev)
            worst = max(worst, _env_step_same(
                got, want, f"EnvStepPlan B={plan_B} faults={faults} "
                f"step={step}"))
            kept.append((got, want))
            st, q = got[0], got[1]     # the plan's own outputs feed it
        # outputs kept from earlier decisions were not overwritten
        for step, (got, want) in enumerate(kept):
            _env_step_same(got, want, f"EnvStepPlan kept step {step}")
    log(f"phase 2 env_step kernel == plain: {len(shapes) * 2} cases x "
        f"{decisions} decisions at B={B} l={l} (K={K}, and (E, K) in "
        f"{list(extra)}), NaN actions in the last, fault arrays from a "
        f"FaultTimeline of FaultSpec.chaos at F=16 for K={K} (random at F=4 "
        f"for the extra shapes), "
        f"and one EnvStepPlan per fault mode kept over {decisions} decisions "
        f"at B={plan_B}; ints, bools and clock exact, max float err "
        f"{worst:.3g} (tol {ENV_ATOL})")
    return worst, timing


def phase_chain(dev, Bs=(1, 3, 16, 256, 300), A=10, Fs=(16, 20, 12), H=256,
                T=10, distill_n=4096, timing_B=256):
    """denoiser_chain kernel vs plain version on every B in `Bs` x F in `Fs`
    x (ddpm K = T, ddim K = 5), and the distiller's full-grid DDIM chain
    (K = T) at its N = `distill_n` (`DistillConfig().dataset`); returns
    (max error, timing inputs at the paper-8srv DDPM main-path shape,
    B = `timing_B`, F = Fs[0])."""
    from repro_torch.actors import samplers as SMP
    from repro_torch.core import diffusion as DF
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.denoiser.ref import denoiser_chain_ref
    g = torch.Generator(device=dev).manual_seed(3)
    sched = DF.vp_schedule(T, device=dev)
    worst, timing, n = 0.0, None, 0
    cases = [(B, F, kind, K) for F in Fs for B in Bs
             for kind, K in (("ddpm", None), ("ddim", 5))]
    cases.append((distill_n, Fs[0], "ddim", T))
    params = {F: DF.init_denoiser(A, F, H, generator=g, device=dev)
              for F in Fs}
    for B, F, kind, K in cases:
        w = [t for layer in params[F]["layers"] for t in (layer["w"], layer["b"])]
        x = torch.randn((B, A), generator=g, device=dev)
        f_s = torch.randn((B, F), generator=g, device=dev)
        c = SMP.chain_coeffs(sched, kind, K)
        Ks = c.tembs.shape[0]
        noises = (torch.randn((Ks, B, A), generator=g, device=dev)
                  if kind == "ddpm" else torch.zeros((Ks, B, A), device=dev))
        args = (x, noises, f_s, c.tembs, c.coef_x, c.coef_e, c.coef_n, *w)
        got = DK.denoiser_chain(*args)
        want = denoiser_chain_ref(*args)
        err = (got - want).abs().max().item()
        assert got.shape == (B, A) and bool(torch.isfinite(got).all())
        assert err <= CHAIN_ATOL, f"chain B={B} F={F} {kind} K={Ks}: err {err}"
        worst, n = max(worst, err), n + 1
        if (B, F, kind) == (timing_B, Fs[0], "ddpm"):
            timing = args
    log(f"phase 3 denoiser_chain kernel ~ plain: {n} cases, B in {list(Bs)} "
        f"x F in {list(Fs)} x (ddpm K={T}, ddim K=5), and the distiller's "
        f"ddim K={T} chain at N={distill_n}, A={A} H={H}; max abs err "
        f"{worst:.3g} (tol {CHAIN_ATOL})")
    return worst, timing


def cell_env(E):
    """The paper's cell on E servers: K = 32 tasks, l = 8 queue slots."""
    from repro_torch.core import env as EV
    return EV.EnvConfig(num_servers=E, queue_window=8, max_tasks=32)


def cell_traces(dev, E, rate):
    """`trace_fn(generator, B)`: B fresh traces of the cell on `dev`."""
    from repro_torch.core.workload import TraceConfig, make_trace_batch
    tc = TraceConfig(num_tasks=32, arrival_rate=rate, max_servers=E)
    return lambda gen, batch: make_trace_batch(tc, batch, generator=gen,
                                               device=dev)


def cell_setup(dev, name, E, rate, B, seed=0):
    traces = cell_traces(dev, E, rate)(
        torch.Generator(device=dev).manual_seed(seed), B)
    return cell_env(E), traces


def phase_main(dev, card, B=256, cells=CELLS, samplers=("ddpm", "ddim:5"),
               acfg=None):
    """The main path, each run with every launch count set to 0 just before
    it; returns ({kernel: launches summed over the runs}, {(cell, sampler):
    ms per decision})."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    acfg = acfg or AG.AgentConfig()
    launches, ms = {}, {}
    for name, E, rate in cells:
        ecfg, traces = cell_setup(dev, name, E, rate, B)
        params = AG.init_actor(
            ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
        for sampler in samplers:
            policy = actor_policy(ecfg, acfg, sampler=sampler, device=dev)
            gen = torch.Generator(device=dev).manual_seed(2)
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            res = RO.batch_rollout(ecfg, traces, policy, params, generator=gen,
                                   num_steps=ecfg.max_steps, device=dev)
            sync(dev)
            secs = time.perf_counter() - t0
            counts = read_counts()
            n_env, n_chain = counts["env_step"], counts["denoiser_chain"]
            assert counts["denoiser_step"] == 0, counts
            m = res.metrics
            for k, v in m.items():
                assert v.shape == (B,) and bool(torch.isfinite(v.float()).all()), k
            longest = int(m["episode_len"].max())
            assert n_env > 0 and n_chain > 0, (name, sampler, n_env, n_chain)
            assert n_env == n_chain, (n_env, n_chain)
            assert longest <= n_env <= ecfg.max_steps, (longest, n_env)
            assert int(m["num_scheduled"].sum()) > 0
            add_counts(launches, counts)
            ms[(name, sampler)] = 1e3 * secs / n_env
            row = {"card": card, "cell": name, "sampler": sampler, "B": B,
                   "decisions": n_env, "ms_per_decision": 1e3 * secs / n_env,
                   "launches": counts,
                   "metrics": {k: float(v.float().mean()) for k, v in m.items()}}
            log("phase 4 main path " + json.dumps(row))
    return launches, ms


# device kernels a distilled decision may launch for its student, by a
# piece of their names: the step kernel once, and no timestep embedding
# (sin, cos) or concatenation any more
STUDENT_KERNELS = ("step_cluster_kernel", "sin_kernel", "cos_kernel",
                   "CatArrayBatchedCopy")


def phase_profile(dev, card, B=256, steps=64, acfg=None, sampler="ddpm",
                  params=None, phase=4):
    """Where a decision's time goes on the main path (paper-8srv): a short
    rollout under torch.profiler. Device busy time is the sum of the
    device-side events (one stream, so they do not overlap); the idle share
    is 1 - busy / wall. `params` defaults to a random actor. A distilled
    rollout also counts STUDENT_KERNELS per decision: one step kernel and
    no sin or cos kernel (on the card)."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    acfg = acfg or AG.AgentConfig()
    ecfg, traces = cell_setup(dev, "paper-8srv", 8, 0.1, B)
    if params is None:
        params = AG.init_actor(
            ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
    policy = actor_policy(ecfg, acfg, sampler=sampler, device=dev)

    def run():
        RO.batch_rollout(ecfg, traces, policy, params, num_steps=steps,
                         generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    names = STUDENT_KERNELS if sampler == "distilled" else ()
    row = {"card": card, "cell": "paper-8srv", "sampler": sampler, "B": B,
           "decisions": steps,
           **profile_device(dev, run, steps, "decision", names)}
    if names and dev.type == "cuda":
        n = row["launches_per_decision"]
        assert n["step_cluster_kernel"] == 1.0, n
        assert n["sin_kernel"] == n["cos_kernel"] == 0, n
    log(f"phase {phase} profile " + json.dumps(row))
    return row


def profile_device(dev, run, units, unit, names=()):
    """Wall and device time of `run()` (`units` units of work) under
    torch.profiler, after one warm run. Device busy time is the sum of
    the device-side events (one stream, so they do not overlap); the idle
    share is 1 - busy / wall. Returns the per-unit numbers, with the
    device events whose names hold each piece of `names` counted."""
    from torch.profiler import ProfilerActivity, profile
    run()
    sync(dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall = time.perf_counter() - t0
    by_name, n_dev = {}, 0        # kernel names cut to 60 characters
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            n_dev += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {f"wall_ms_per_{unit}": 1e3 * wall / units,
           f"device_busy_ms_per_{unit}": busy_us / 1e3 / units,
           "device_idle_share": 1.0 - busy_us / 1e6 / wall,
           f"device_events_per_{unit}": n_dev / units,
           f"top_device_us_per_{unit}": {n: us / units for n, us in top}}
    if names:
        out[f"launches_per_{unit}"] = {
            p: sum(1 for e in prof.events()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and p in e.name) / units for p in names}
    return out


def _same_state(a, b, ctx):
    """Exact on every field but quality (exp from two builds, 1 ulp)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "task_quality":
            err = (x - y).abs().max().item()
            assert err <= ENV_ATOL, f"{ctx}: {f} err {err}"
        else:
            assert torch.equal(x, y), f"{ctx}: {f} differs"


def _same_metrics(a, b, ctx):
    for k in a:
        if k in ("avg_quality", "episode_return"):
            err = (a[k] - b[k]).abs().max().item()
            assert err <= ENV_ATOL * max(1.0, a[k].abs().max().item()), \
                f"{ctx}: {k} err {err}"
        else:
            assert torch.equal(a[k], b[k]), f"{ctx}: {k} differs"


def actor_loop_parity(dev, ecfg, traces, acfg, params, name, sampler,
                      phase, B=256):
    """The actor's kernel path against its plain path inside the loop:
    the kernel path's actions replayed through the plain env give the same
    trajectory (teacher-forced), and the two closed loops agree on the
    aggregate episode metrics within 5 %."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import rollout as RO
    kw = dict(num_steps=ecfg.max_steps, device=dev)

    def run(impl, collect=False):
        pol = actor_policy(ecfg, acfg, sampler=sampler, device=dev, impl=impl)
        return RO.batch_rollout(
            ecfg, traces, pol, params, collect=collect, impl=impl,
            generator=torch.Generator(device=dev).manual_seed(2), **kw)
    k = run("auto", collect=True)
    t = RO.batch_rollout(ecfg, traces, RO.sequence_policy(ecfg),
                         {"seq": k.transitions.action}, impl="ref",
                         collect=True, **kw)
    ctx = f"{sampler} teacher {name}"
    _same_state(k.final_state, t.final_state, ctx)
    _same_metrics(k.metrics, t.metrics, ctx)
    for f in ("valid", "done"):
        assert torch.equal(getattr(k.transitions, f),
                           getattr(t.transitions, f)), f"{ctx} {f}"
    obs_err = (k.transitions.next_obs - t.transitions.next_obs).abs().max().item()
    assert obs_err <= ENV_ATOL, f"{ctx} obs err {obs_err}"
    log(f"phase {phase} {sampler} teacher-forced {name}: the kernel path's "
        f"{k.transitions.action.shape[1]} decisions replayed through the "
        f"plain env give the same trajectory (obs err {obs_err:.3g})")

    p = run("ref")
    same = torch.ones(B, dtype=torch.bool, device=dev)
    for f in k.final_state._fields:
        x, y = getattr(k.final_state, f), getattr(p.final_state, f)
        same &= (x == y).reshape(B, -1).all(1)
    agg = {}
    for key in ("avg_response", "avg_quality", "num_scheduled",
                "episode_return"):
        a = k.metrics[key].double().mean().item()
        b = p.metrics[key].double().mean().item()
        agg[key] = (a, b)
        assert abs(a - b) <= 0.05 * max(abs(b), 1e-6), (name, key, a, b)
    log(f"phase {phase} {sampler} closed loop {name}: kernel vs plain means "
        + json.dumps({k_: [round(a, 6), round(b, 6)] for k_, (a, b) in agg.items()})
        + f" within 5%; envs with identical final state "
        f"{int(same.sum())}/{B}")


def phase_loop_parity(dev, B=256, cells=CELLS, acfg=None):
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    acfg = acfg or AG.AgentConfig()
    for name, E, rate in cells:
        ecfg, traces = cell_setup(dev, name, E, rate, B)
        kw = dict(num_steps=ecfg.max_steps, device=dev)
        fifo = RO.fifo_policy(ecfg)
        k = RO.batch_rollout(ecfg, traces, fifo, {}, **kw)
        p = RO.batch_rollout(ecfg, traces, fifo, {}, impl="ref", **kw)
        _same_state(k.final_state, p.final_state, f"fifo {name}")
        _same_metrics(k.metrics, p.metrics, f"fifo {name}")
        log(f"phase 5 fifo {name}: kernel path == plain path (final EnvState "
            f"and metrics; quality and return within {ENV_ATOL})")
        params = AG.init_actor(
            ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
        actor_loop_parity(dev, ecfg, traces, acfg, params, name, "ddpm", 5, B)


def phase_step(dev, A=10, H=256, Fs=(16, 20), Bs=(256, 300, 4096), T=10):
    """denoiser_step kernel vs plain version, with the embedding one row
    per batch row and one row for all (the distilled sampler's, stride 0);
    returns (max error, timing inputs at the paper-8srv distilled main-path
    shape, B = 256, F = 16, one embedding row)."""
    from repro_torch.actors import samplers as SMP
    from repro_torch.core import diffusion as DF
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.denoiser import ops as KOPS
    from repro_torch.kernels.denoiser.ref import denoiser_ref
    g = torch.Generator(device=dev).manual_seed(4)
    worst, timing, n = 0.0, None, 0
    for F in Fs:
        p = DF.init_denoiser(A, F, H, generator=g, device=dev)
        w = [t for layer in p["layers"] for t in (layer["w"], layer["b"])]
        for B in Bs:
            x = torch.randn((B, A), generator=g, device=dev)
            f_s = torch.randn((B, F), generator=g, device=dev)
            i = torch.randint(1, T + 1, (B,), generator=g, device=dev)
            row = SMP.step_embedding(T, 16, dev)
            for temb in (DF.timestep_embedding(i), row):
                got = DK.denoiser_step(x, temb, f_s, *w)
                inp = torch.cat([x, temb.expand(B, -1), f_s], dim=-1)
                want = denoiser_ref(inp, *w)
                sync(dev)
                err = (got - want).abs().max().item()
                kind = "per row" if temb.dim() == 2 else "one row"
                assert got.shape == (B, A) and bool(torch.isfinite(got).all())
                assert err <= STEP_ATOL, \
                    f"denoiser_step F={F} B={B} temb {kind}: err {err}"
                worst, n = max(worst, err), n + 1
            if (F, B) == (Fs[0], Bs[0]):
                timing = (x, row, f_s, *w)
        # one decision, unbatched, through the ops door
        got = KOPS.denoise_eps_fused(p, x[0], i[0], f_s[0])
        want = DF.denoise_eps(p, x[0], i[0], f_s[0])
        err = (got - want).abs().max().item()
        assert got.shape == (A,) and err <= STEP_ATOL, f"1-D F={F}: {err}"
        worst, n = max(worst, err), n + 1
    log(f"phase 7 denoiser_step kernel ~ plain: {n} cases, F in {list(Fs)}, "
        f"B in {list(Bs)}, the embedding per row and one row for all, and a "
        f"1-D input, A={A} H={H}; max abs err {worst:.3g} (tol {STEP_ATOL})")
    return worst, timing


def phase_train(dev, card, num_envs=16, num_episodes=32, upd_iters=10):
    """SAC at full width on paper-8srv: `sac.train` with every launch count
    set to 0 just before it; then ms per update_step (CUDA events over
    back-to-back updates on one batch), ms per collection decision, and
    one update_step on the card against the CPU from the same state, batch
    and draws (`card_vs_cpu`: each metric on the card, on the CPU, and
    their relative difference). Returns (train state, launches in
    train)."""
    from repro_torch.common.device import to_device
    from repro_torch.core import agent as AG
    from repro_torch.core import sac as SAC
    from repro_torch.core.replay import ReplayBuffer
    ecfg = cell_env(8)
    acfg = AG.AgentConfig()
    scfg = SAC.SACConfig(batch_size=512, warmup_steps=256, update_every=8)
    trace_fn = cell_traces(dev, 8, 0.1)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    ts, hist = SAC.train(ecfg, acfg, scfg, trace_fn, num_episodes,
                         num_envs=num_envs, log_every=0, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    rounds = {h["round"]: h for h in hist}
    updates = sum(r["updates"] for r in rounds.values())
    losses = {k: rounds[max(rounds)][k] for k in
              ("critic_loss", "actor_loss", "q_mean", "entropy", "q_batch")}
    assert updates > 0 and int(ts.step) == updates, (updates, int(ts.step))
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert counts["env_step"] > 0 and counts["denoiser_chain"] > 0, counts
    assert counts["denoiser_step"] == 0, counts
    assert [rounds[r]["warmup"] for r in sorted(rounds)][:2] == [True, False]

    # collection alone: one actor round of num_envs episodes
    gen = torch.Generator(device=dev).manual_seed(7)
    buf = ReplayBuffer(1 << 16, ecfg.obs_shape, ecfg.action_dim)
    traces = trace_fn(gen, num_envs)
    sync(dev)
    t1 = time.perf_counter()
    _, n_new = SAC.collect_batch(ecfg, acfg, ts.actor, traces, gen, buf,
                                 device=dev)
    sync(dev)
    collect_ms = 1e3 * (time.perf_counter() - t1) / ecfg.max_steps
    rng = np.random.default_rng(0)
    batch = SAC._sample_batch(buf, rng, scfg.batch_size, dev)
    state = {"ts": ts}

    def one_update():
        state["ts"], _ = SAC.update_step(state["ts"], batch, ecfg=ecfg,
                                         acfg=acfg, scfg=scfg, generator=gen)
    upd_ms = time_ms(one_update, upd_iters, warmup=2)

    def run_updates():
        for _ in range(upd_iters):
            one_update()
    upd_profile = profile_device(dev, run_updates, upd_iters, "update")

    # one update on the card and on the CPU from the same state and draws
    cpu = torch.device("cpu")
    B, A, T = scfg.batch_size, ecfg.action_dim, acfg.T
    g = torch.Generator().manual_seed(11)
    draws = {"next_x_T": torch.randn((B, A), generator=g),
             "next_noises": torch.randn((T, B, A), generator=g),
             "next_eps": torch.randn((B, A), generator=g),
             "x_T": torch.randn((B, A), generator=g),
             "noises": torch.randn((T, B, A), generator=g),
             "eps": torch.randn((B, A), generator=g)}
    _, m_dev = SAC.update_step(ts, batch, ecfg=ecfg, acfg=acfg, scfg=scfg,
                               draws=to_device(draws, dev))
    _, m_cpu = SAC.update_step(to_device(ts, cpu), to_device(batch, cpu),
                               ecfg=ecfg, acfg=acfg, scfg=scfg, draws=draws)
    pairs = {}
    for k in m_cpu:
        assert (m_dev[k].device.type, m_cpu[k].device.type) == (dev.type, "cpu")
        a, b = float(m_dev[k]), float(m_cpu[k])
        pairs[k] = [a, b, abs(a - b) / max(abs(b), 1e-12)]
        assert abs(a - b) <= LOSS_RTOL * abs(b) + (
            0.0 if k.endswith("loss") else 1e-6), (k, a, b)
    row = {"card": card, "cell": "paper-8srv", "num_envs": num_envs,
           "episodes": num_episodes, "rounds": len(rounds),
           "train_s": secs, "updates": updates, "losses": losses,
           "launches": counts, "ms_per_update_step": upd_ms,
           "update_batch": scfg.batch_size,
           "ms_per_collection_decision": collect_ms,
           "collection_envs": num_envs, "transitions_collected": n_new,
           "card_vs_cpu": pairs, "update_profile": upd_profile}
    log("phase 8 sac train " + json.dumps(row))
    return ts, counts


def phase_distill(dev, card, teacher, student_iters=20):
    """Distillation of phase 8's actor at the DistillConfig() defaults:
    the teacher's observations (collect_obs: deterministic ddpm rollouts),
    then distill_actor on them, each with every launch count set to 0 just
    before it. Returns (teacher plus student, launches)."""
    from repro_torch.actors import samplers as SMP
    from repro_torch.actors.policies import init_student
    from repro_torch.core import agent as AG
    from repro_torch.core import diffusion as DF
    from repro_torch.training import distill as DS
    from repro_torch.training.optimizer import adam_init
    ecfg = cell_env(8)
    acfg = AG.AgentConfig()
    dcfg = DS.DistillConfig(log_every=100)
    gen = torch.Generator(device=dev).manual_seed(5)
    launches = {}
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    obs = DS.collect_obs(teacher, ecfg, acfg, episodes=dcfg.collect_episodes,
                         num_steps=dcfg.collect_steps, generator=gen,
                         device=dev)
    sync(dev)
    collect_s = time.perf_counter() - t0
    c_collect = read_counts()
    add_counts(launches, c_collect)
    reset_counts()
    t0 = time.perf_counter()
    params, hist = DS.distill_actor(teacher, ecfg, acfg, dcfg, obs=obs,
                                    generator=gen, device=dev)
    sync(dev)
    distill_s = time.perf_counter() - t0
    c_distill = read_counts()
    add_counts(launches, c_distill)
    assert c_collect["env_step"] > 0 and \
        c_collect["denoiser_chain"] == c_collect["env_step"], c_collect
    assert c_distill["denoiser_chain"] == 1, c_distill   # all the targets
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"], hist

    # the student on 32 unseen x_T draws against the DDIM endpoint
    sched = DF.vp_schedule(acfg.T, device=dev)
    f_s = AG._encode(teacher, acfg, obs[:1]).expand(32, -1).contiguous()
    x_T = torch.randn((32, ecfg.action_dim), generator=gen, device=dev)
    want = SMP.chain_sample(teacher["denoiser"], sched, f_s, ecfg.action_dim,
                            kind="ddim", K=acfg.T, x_T=x_T, impl="ref")
    got = SMP.distilled_sample(params["student"], f_s, ecfg.action_dim,
                               acfg.T, x_T=x_T, impl="ref")
    fresh = SMP.distilled_sample(
        init_student(ecfg, acfg, generator=gen, device=dev), f_s,
        ecfg.action_dim, acfg.T, x_T=x_T, impl="ref")
    err = (got - want).abs().mean().item()
    err_fresh = (fresh - want).abs().mean().item()
    assert err < 0.6 * err_fresh, (err, err_fresh)

    # ms per student step on a batch of the targets
    fs_b, x0_b, xT_b = DS._teacher_targets(teacher, obs[:dcfg.batch],
                                           ecfg=ecfg, acfg=acfg,
                                           generator=gen)
    state = {"s": params["student"], "o": adam_init(params["student"])}

    def one_step():
        state["s"], state["o"], _ = DS._student_step(
            state["s"], state["o"], fs_b, x0_b, xT_b, acfg=acfg, lr=dcfg.lr)
    step_ms = time_ms(one_step, student_iters, warmup=2)

    def run_steps():
        for _ in range(student_iters):
            one_step()
    step_profile = profile_device(dev, run_steps, student_iters, "step")
    row = {"card": card, "cell": "paper-8srv", "obs": int(obs.shape[0]),
           "collect_s": collect_s, "distill_s": distill_s,
           "steps": dcfg.steps, "batch": dcfg.batch, "dataset": dcfg.dataset,
           "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
           "student_mae": err, "fresh_student_mae": err_fresh,
           "ms_per_student_step": step_ms, "student_step_profile": step_profile,
           "launches_collect": c_collect, "launches_distill": c_distill,
           "chain_launches_for_targets": c_distill["denoiser_chain"]}
    log("phase 9 distill " + json.dumps(row))
    return params, launches


def phase_distilled(dev, card, params8, ddpm_ms, B=256, cells=CELLS):
    """The distilled main path: batch_rollout with sampler "distilled" on
    each cell, every launch count set to 0 just before it; then the kernel
    path against the plain path. Returns launches summed over the runs."""
    from repro_torch.actors.policies import actor_policy, init_student
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    acfg = AG.AgentConfig()
    launches = {}
    for name, E, rate in cells:
        ecfg, traces = cell_setup(dev, name, E, rate, B)
        if name == "paper-8srv":
            params = params8
        else:
            g = torch.Generator(device=dev).manual_seed(1)
            params = AG.init_actor(ecfg, acfg, generator=g, device=dev)
            params["student"] = init_student(ecfg, acfg, generator=g,
                                             device=dev)
        policy = actor_policy(ecfg, acfg, sampler="distilled", device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = RO.batch_rollout(ecfg, traces, policy, params, generator=gen,
                               num_steps=ecfg.max_steps, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
        counts = read_counts()
        m = res.metrics
        for k, v in m.items():
            assert v.shape == (B,) and bool(torch.isfinite(v.float()).all()), k
        decisions = counts["env_step"]
        assert decisions == ecfg.max_steps, counts
        assert counts["denoiser_step"] == decisions, counts
        assert counts["denoiser_chain"] == 0, counts
        assert int(m["num_scheduled"].sum()) > 0
        add_counts(launches, counts)
        row = {"card": card, "cell": name, "sampler": "distilled", "B": B,
               "decisions": decisions,
               "ms_per_decision": 1e3 * secs / decisions,
               "ddpm_ms_per_decision": ddpm_ms.get((name, "ddpm")),
               "launches": counts,
               "metrics": {k: float(v.float().mean()) for k, v in m.items()}}
        log("phase 10 distilled main path " + json.dumps(row))
        actor_loop_parity(dev, ecfg, traces, acfg, params, name, "distilled",
                          10, B)
    return launches


# ------------------------------------------------- phases 15-17 (item 12, 4, 6)
GRAPH_SAMPLERS = ("fifo", "uniform", "ddpm", "ddim:5", "distilled")


def _rollouts_equal(a, b):
    """Every tensor of two rollout results equal (state, metrics, and the
    transitions when both collected)."""
    return all(torch.equal(getattr(a.final_state, f),
                           getattr(b.final_state, f))
               for f in a.final_state._fields) and _outputs_equal(a, b)


def _outputs_equal(a, b):
    """The metrics, and the transitions when both collected, of two
    rollouts (or windows) equal in every tensor."""
    pairs = [(a.metrics[k], b.metrics[k]) for k in a.metrics]
    if a.transitions is not None:
        pairs += [(getattr(a.transitions, f), getattr(b.transitions, f))
                  for f in a.transitions._fields[:-1]]
        pairs += [(v, b.transitions.extras[k])
                  for k, v in a.transitions.extras.items()]
    return all(torch.equal(x, y) for x, y in pairs)


def _graph_policy(dev, ecfg, acfg, sampler, actor):
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import rollout as RO
    if sampler == "fifo":
        return RO.fifo_policy(ecfg), {}
    if sampler == "uniform":
        return RO.uniform_policy(ecfg), {}
    return actor_policy(ecfg, acfg, sampler=sampler, device=dev), actor


def phase_graph(dev, card, params8, B=256, cells=CELLS,
                samplers=GRAPH_SAMPLERS, pairs=10, pair_steps=256,
                profile_steps=64, act_calls=50):
    """The decision graph (ROADMAP Queue 1 item 12): per cell and sampler,
    a whole episode graphed (the default; its first run builds the loop and
    captures the two graphs: capture ms) with every launch count set to 0
    just before it, then graphed against eager (`graph=False`, here only to
    measure it) collecting a whole episode: equal in every tensor (exact
    for fifo, uniform and sequence; for the actor samplers a difference is
    reported and held to phase 5's 5 % on the aggregate metrics); `pairs`
    alternating pairs of `pair_steps`-decision runs for wall ms per
    decision each way; and a profile of each way (device busy ms, idle
    share, events per decision). Per cell: the uniform run's actions
    replayed by `sequence_policy` graphed and eager (exact), a ddpm
    rollout on new weights (the second rollout reads them); on paper-8srv
    `ActorProgram.act` at B = 1 against the policy's eager call. Returns
    launches summed over the counted runs."""
    from repro_torch.actors.policies import actor_policy, init_student
    from repro_torch.actors.program import actor_program
    from repro_torch.core import agent as AG
    from repro_torch.core import env as EV
    from repro_torch.core import rollout as RO
    acfg = AG.AgentConfig()
    launches = {}
    for name, E, rate in cells:
        ecfg, traces = cell_setup(dev, name, E, rate, B)
        if name == "paper-8srv":
            actor = params8
        else:
            g = torch.Generator(device=dev).manual_seed(1)
            actor = AG.init_actor(ecfg, acfg, generator=g, device=dev)
            actor["student"] = init_student(ecfg, acfg, generator=g,
                                            device=dev)
        collected = {}
        for sampler in samplers:
            pol, params = _graph_policy(dev, ecfg, acfg, sampler, actor)
            prog = actor_program(ecfg, pol)

            def run(graph, steps=ecfg.max_steps, collect=False, p=params):
                return RO.batch_rollout(
                    ecfg, traces, pol, p, num_steps=steps, collect=collect,
                    generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev, graph=graph)
            cap0, n0 = prog.capture_seconds, prog.captures
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            first = run(True)
            sync(dev)
            first_s = time.perf_counter() - t0
            counts = read_counts()
            T = ecfg.max_steps
            assert counts["env_step"] == T, counts
            if sampler in ("ddpm", "ddim:5"):
                assert counts["denoiser_chain"] == T, counts
            if sampler == "distilled":
                assert counts["denoiser_step"] == T, counts
            add_counts(launches, counts)
            # 2 on a loop's first run (0 where an earlier phase captured it)
            captured = prog.captures - n0
            assert captured in ((0, 2) if dev.type == "cuda" else (0,)), \
                captured
            g = run(True, collect=True)
            e = run(False, collect=True)
            exact = _rollouts_equal(g, e)
            diff = {}
            if not exact:
                assert sampler not in ("fifo", "uniform"), \
                    f"{name} {sampler}: graphed != eager"
                for k in ("avg_response", "avg_quality", "num_scheduled",
                          "episode_return"):
                    a = g.metrics[k].double().mean().item()
                    b = e.metrics[k].double().mean().item()
                    diff[k] = [a, b]
                    assert abs(a - b) <= 0.05 * max(abs(b), 1e-6), (name, k)
                diff["envs_same_final_state"] = int(torch.stack([
                    (getattr(g.final_state, f) == getattr(e.final_state, f)
                     ).reshape(B, -1).all(1) for f in EV.EnvState._fields]
                ).all(0).sum())
            collected[sampler] = g
            graphed, eager = [], []
            for i in range(pairs):
                for graph in ((True, False) if i % 2 == 0 else (False, True)):
                    sync(dev)
                    t0 = time.perf_counter()
                    run(graph, steps=pair_steps)
                    sync(dev)
                    ms = 1e3 * (time.perf_counter() - t0) / pair_steps
                    (graphed if graph else eager).append(ms)
            prof = {way: profile_device(
                dev, lambda: run(way == "graphed", steps=profile_steps),
                profile_steps, "decision")
                for way in ("graphed", "eager")}
            row = {"card": card, "cell": name, "sampler": sampler, "B": B,
                   "decisions": T, "first_run_ms_per_decision":
                       1e3 * first_s / T,
                   "capture_ms": 1e3 * (prog.capture_seconds - cap0),
                   "graphs_captured": captured,
                   "launches_per_decision": {k: v / T for k, v in
                                             counts.items() if v},
                   "graphed_equals_eager": exact, "difference": diff,
                   "pair_steps": pair_steps,
                   "graphed_ms_per_decision": graphed,
                   "eager_ms_per_decision": eager,
                   "graphed_median": float(np.median(graphed)),
                   "eager_median": float(np.median(eager)),
                   "pairs_graphed_faster": sum(a < b for a, b in
                                               zip(graphed, eager)),
                   # the profiler's own host work inflates its wall time:
                   # the idle share against the pairs' median wall too
                   "idle_share_at_median_wall": {
                       "graphed": 1.0 - prof["graphed"][
                           "device_busy_ms_per_decision"] / np.median(graphed),
                       "eager": 1.0 - prof["eager"][
                           "device_busy_ms_per_decision"] / np.median(eager)},
                   "profile": prof,
                   "metrics": {k: float(v.float().mean())
                               for k, v in first.metrics.items()}}
            log("phase 15 decision graph " + json.dumps(row))
        # the uniform run's actions replayed graphed and eager: exact
        seq = {"seq": collected["uniform"].transitions.action}
        pol = RO.sequence_policy(ecfg)
        runs = [RO.batch_rollout(ecfg, traces, pol, seq, collect=True,
                                 device=dev, graph=graph)
                for graph in (True, False)]
        assert _rollouts_equal(*runs), f"{name} sequence: graphed != eager"
        assert torch.equal(runs[0].final_state.task_status,
                           collected["uniform"].final_state.task_status)
        # new weights between two rollouts: the second reads them
        pol = actor_policy(ecfg, acfg, sampler="ddpm", device=dev)
        fresh = AG.init_actor(
            ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(3),
            device=dev)
        kw = dict(collect=True, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(2))
        new_g = RO.batch_rollout(ecfg, traces, pol, fresh, **kw)
        kw["generator"] = torch.Generator(device=dev).manual_seed(2)
        new_e = RO.batch_rollout(ecfg, traces, pol, fresh, graph=False, **kw)
        same_new = _rollouts_equal(new_g, new_e)
        moved = not torch.equal(new_g.transitions.action,
                                collected["ddpm"].transitions.action)
        assert moved, f"{name}: the rollout on new weights did not move"
        log(f"phase 15 {name}: sequence replay graphed == eager (exact); "
            f"ddpm on new weights: graphed == eager {same_new}, actions "
            f"differ from the old weights' {moved}")
        if name == "paper-8srv":
            log("phase 15 act " + json.dumps(
                phase_act(dev, card, ecfg, acfg, traces, actor, act_calls,
                          pairs)))
    return launches


def phase_act(dev, card, ecfg, acfg, traces, actor, calls, pairs):
    """`ActorProgram.act` at B = 1 (the serving seam, ddpm) against the
    policy's eager call: equal outputs on the same draws, then ms per
    decision with the action brought to the host, in alternating pairs."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.actors.program import actor_program
    from repro_torch.core import env as EV
    pol = actor_policy(ecfg, acfg, sampler="ddpm", device=dev)
    prog = actor_program(ecfg, pol)
    tr = {k: v[:1] for k, v in traces.items()}
    state = EV.reset(ecfg, 1, device=dev)
    obs = EV.observe(ecfg, tr, state)
    g1 = torch.Generator(device=dev).manual_seed(4)
    g2 = torch.Generator(device=dev).manual_seed(4)
    for _ in range(3):
        a, _ = prog.act(tr, state, obs, g1, actor)
        b, _ = pol(actor, g2, tr, state, obs)
        assert torch.equal(a, b), "act != policy"
    graphed, eager = [], []
    gen = torch.Generator(device=dev).manual_seed(5)
    for i in range(pairs):
        for graph in ((True, False) if i % 2 == 0 else (False, True)):
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(calls):
                a, _ = (prog.act(tr, state, obs, gen, actor) if graph
                        else pol(actor, gen, tr, state, obs))
                a.cpu()
            (graphed if graph else eager).append(
                1e3 * (time.perf_counter() - t0) / calls)
    return {"card": card, "cell": "paper-8srv", "sampler": "ddpm", "B": 1,
            "calls": calls, "graphed_ms_per_call": graphed,
            "eager_ms_per_call": eager,
            "graphed_median": float(np.median(graphed)),
            "eager_median": float(np.median(eager))}


def phase_paper(dev, card, actor8, B=256, small_B=8, gcfg=None, hcfg=None):
    """The paper's comparison (§VI, Tables IX-XI) on `paper_scenarios()`:
    Random, FIFO, Greedy and EAT on B traces per cell through
    `run_scenario` (each with every launch count set to 0 just before it;
    EAT is phase 8's short-trained actor on paper-8srv and a seeded random
    actor on the 4- and 12-server cells, whose observation widths differ),
    then Genetic and Harmony at their defaults on the cell's first trace,
    and Greedy on the card against Greedy on the CPU, closed loop on
    `small_B` traces: equal actions and final state. Returns launches."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import agent as AG
    from repro_torch.core import baselines as BL
    from repro_torch.core import rollout as RO
    from repro_torch.core import scenarios as SC
    gcfg = gcfg or BL.GeneticConfig()
    hcfg = hcfg or BL.HarmonyConfig()
    acfg = AG.AgentConfig()
    launches, table = {}, []
    for sc in SC.paper_scenarios():
        ecfg = sc.ecfg
        traces = SC.make_scenario_trace_batch(
            sc, B, generator=torch.Generator(device=dev).manual_seed(6),
            device=dev)
        eat = (actor8 if sc.name == "paper-8srv" else AG.init_actor(
            ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(1),
            device=dev))
        for pname, pol, params in (
                ("random", RO.uniform_policy(ecfg), {}),
                ("fifo", RO.fifo_policy(ecfg), {}),
                ("greedy", RO.greedy_policy(ecfg), {}),
                ("eat", actor_policy(ecfg, acfg, sampler="ddpm", device=dev),
                 eat)):
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            m = SC.run_scenario(sc, pol, torch.Generator(device=dev).manual_seed(7),
                                params=params, traces=traces, device=dev)
            secs = time.perf_counter() - t0
            counts = read_counts()
            assert counts["env_step"] == ecfg.max_steps, counts
            add_counts(launches, counts)
            table.append(_paper_row(card, sc.name, pname, B, m,
                                    1e3 * secs / ecfg.max_steps, counts))
        trace0 = {k: v[0] for k, v in traces.items()}
        for pname, fn, cfg in (("genetic", BL.genetic_schedule, gcfg),
                               ("harmony", BL.harmony_schedule, hcfg)):
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            best, fit = fn(ecfg, trace0, cfg,
                           generator=torch.Generator(device=dev).manual_seed(8),
                           device=dev)
            res = RO.batch_rollout(ecfg, {k: v[:1] for k, v in traces.items()},
                                   RO.sequence_policy(ecfg),
                                   {"seq": best[None]}, num_steps=cfg.seq_len,
                                   device=dev)
            sync(dev)
            secs = time.perf_counter() - t0
            counts = read_counts()
            add_counts(launches, counts)
            m = {k: v.cpu().numpy() for k, v in res.metrics.items()}
            m.update({f"mean_{k}": float(v.mean()) for k, v in m.items()})
            assert abs(m["mean_episode_return"] - float(fit)) <= 1e-5 * max(
                1.0, abs(float(fit))), (pname, m["mean_episode_return"], fit)
            row = _paper_row(card, sc.name, pname, 1, m,
                             1e3 * secs / max(counts["env_step"], 1), counts)
            row["schedule_s"] = secs
            row["config"] = dataclasses.asdict(cfg)
            table.append(row)
        small = {k: v[:small_B] for k, v in traces.items()}
        kw = dict(collect=True)
        card_g = RO.batch_rollout(ecfg, small, RO.greedy_policy(ecfg), {},
                                  device=dev, **kw)
        cpu_g = RO.batch_rollout(ecfg, small, RO.greedy_policy(ecfg), {},
                                 device="cpu", **kw)
        assert torch.equal(card_g.transitions.action.cpu(),
                           cpu_g.transitions.action), f"{sc.name} greedy actions"
        _same_state(type(cpu_g.final_state)(
            *(x.cpu() for x in card_g.final_state)), cpu_g.final_state,
                    f"{sc.name} greedy card vs cpu")
        log(f"phase 16 {sc.name}: greedy on the card == greedy on the CPU "
            f"(closed loop, {small_B} traces, {ecfg.max_steps} decisions: "
            f"actions and final state)")
    for row in table:
        log("phase 16 paper " + json.dumps(row))
    return launches, table


def _paper_row(card, cell, policy, B, m, ms, counts):
    return {"card": card, "cell": cell, "policy": policy, "B": B,
            "mean_avg_response": m["mean_avg_response"],
            "mean_avg_quality": m["mean_avg_quality"],
            "mean_reload_rate": m["mean_reload_rate"],
            "mean_episode_return": m["mean_episode_return"],
            "mean_num_scheduled": m["mean_num_scheduled"],
            "ms_per_decision": ms,
            "launches": {k: v for k, v in counts.items() if v}}


def phase_ppo(dev, card, num_envs=16, rounds=3, upd_iters=10,
              warmup_steps=256):
    """PPO (ROADMAP Queue 1 item 6) on paper-8srv: `train_ppo` for `rounds`
    rounds of `num_envs` envs (a depth cut) with every launch count set to
    0 just before it; ms per collection decision and per `ppo_update`
    (CUDA events) on a minibatch of the pooled data; one `ppo_update` on
    the card against the CPU from the same state and batch within
    LOSS_RTOL. Then the SAC remainder: `sac.train` one round with
    `demo_episodes` and one with `curriculum=training_curriculum`. Returns
    (launches, the PPO state)."""
    from repro_torch.common.device import to_device
    from repro_torch.core import agent as AG
    from repro_torch.core import ppo as PPO
    from repro_torch.core import rollout as RO
    from repro_torch.core import sac as SAC
    from repro_torch.core import scenarios as SC
    ecfg = cell_env(8)
    pcfg = PPO.PPOConfig()
    trace_fn = cell_traces(dev, 8, 0.1)
    launches = {}
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    st, hist = PPO.train_ppo(ecfg, pcfg, trace_fn, num_envs * rounds,
                             num_envs=num_envs, log_every=0, device=dev)
    sync(dev)
    train_s = time.perf_counter() - t0
    counts = read_counts()
    assert counts["env_step"] == rounds * ecfg.max_steps, counts
    add_counts(launches, counts)
    updates = sum({h["round"]: h["updates"] for h in hist}.values())
    assert updates > 0 and int(st.step) == updates, (updates, int(st.step))
    gen = torch.Generator(device=dev).manual_seed(9)
    traces = trace_fn(gen, num_envs)
    sync(dev)
    t0 = time.perf_counter()
    res = RO.batch_rollout(ecfg, traces, PPO.ppo_policy(ecfg), st.params,
                           generator=gen, collect=True, device=dev)
    sync(dev)
    collect_ms = 1e3 * (time.perf_counter() - t0) / ecfg.max_steps
    data = PPO.pool_gae(res.transitions, pcfg)
    mb = max(1, len(data["adv"]) // pcfg.minibatches)
    idx = np.random.default_rng(0).permutation(len(data["adv"]))[:mb]
    batch = {k: torch.from_numpy(v[idx]).to(dev) for k, v in data.items()}
    state = {"st": st}

    def one_update():
        state["st"], _ = PPO.ppo_update(state["st"], batch, ecfg=ecfg,
                                        pcfg=pcfg)
    upd_ms = time_ms(one_update, upd_iters, warmup=2)
    cpu = torch.device("cpu")
    _, m_dev = PPO.ppo_update(st, batch, ecfg=ecfg, pcfg=pcfg)
    _, m_cpu = PPO.ppo_update(to_device(st, cpu), to_device(batch, cpu),
                              ecfg=ecfg, pcfg=pcfg)
    pairs = {}
    for k in m_cpu:
        a, b = float(m_dev[k]), float(m_cpu[k])
        pairs[k] = [a, b, abs(a - b) / max(abs(b), 1e-12)]
        assert abs(a - b) <= LOSS_RTOL * abs(b) + 1e-7, (k, a, b)
    log("phase 17 ppo " + json.dumps({
        "card": card, "cell": "paper-8srv", "num_envs": num_envs,
        "rounds": rounds, "train_s": train_s, "updates": updates,
        "launches": counts, "ms_per_collection_decision": collect_ms,
        "ms_per_ppo_update": upd_ms, "update_batch": mb,
        "card_vs_cpu": pairs,
        "last_round_return": float(np.mean([h["episode_return"] for h in
                                            hist[-num_envs:]]))}))
    acfg = AG.AgentConfig()
    scfg = SAC.SACConfig(batch_size=512, warmup_steps=warmup_steps,
                         update_every=64)
    for what, kw in (("demo_episodes", {"demo_episodes": num_envs}),
                     ("curriculum", {"curriculum":
                                     SC.training_curriculum(ecfg)})):
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        ts, hist = SAC.train(ecfg, acfg, scfg, trace_fn, num_envs,
                             num_envs=num_envs, log_every=0, device=dev, **kw)
        sync(dev)
        counts = read_counts()
        add_counts(launches, counts)
        ups = hist[0]["updates"]
        assert ups > 0 and int(ts.step) == ups, (what, ups)
        assert np.isfinite(hist[0]["critic_loss"]) and counts["env_step"] > 0
        log("phase 17 sac " + json.dumps({
            "card": card, "with": what, "round_s": time.perf_counter() - t0,
            "warmup_round": hist[0]["warmup"], "updates": ups,
            "critic_loss": hist[0]["critic_loss"], "launches": counts}))
    return launches, st


# the stream's spans (telemetry/schema.py KNOWN_SPANS) phase 18's trace
# must hold
STREAM_SPANS = ("window", "build_window", "window_rollout", "window_seam",
                "fault_requeue", "placement_decide")
# stream stats that are float sums over K (another reduction order on the
# card than on the CPU); every other stat is held exactly
STREAM_FLOAT_STATS = ("sum_resp", "sum_quality", "sum_steps", "busy_time")


def _ledger_ok(runner):
    s = runner.result().summary
    assert s["tasks_injected"] == (
        s["tasks_scheduled"] + s["tasks_dropped"]
        + s["tasks_failed_pending_retry"] + s["tasks_leftover"]), s
    assert s["tasks_dropped"] == (s["tasks_dropped_shed"]
                                  + s["tasks_dropped_retry_exhausted"]), s


def _stream_source(dev, B, seed, E=8, rate=0.1):
    """The paper's arrivals for a stream: Poisson at `rate` and the
    TraceConfig marginals, drawn on `dev` from a seeded generator."""
    from repro_torch.core.workload import TraceConfig
    from repro_torch.traffic.arrivals import PoissonArrivals
    from repro_torch.traffic.stream import ProcessTaskSource
    return ProcessTaskSource(
        PoissonArrivals(rate=rate),
        TraceConfig(num_tasks=32, arrival_rate=rate, max_servers=E),
        torch.Generator(device=dev).manual_seed(seed), num_streams=B,
        device=dev)


def _same_stream(a, b, stats_a, stats_b, ctx):
    """Two runners after the same windows (`stats_*`: their windows'
    `WindowResult.stats`): the window records and every stat exact but the
    float sums over K (STREAM_FLOAT_STATS and the records' mean latency and
    return: ENV_ATOL relative), the carry, the epochs, the leftovers, the
    retry buffers and the fault and placement counters exact."""
    for w, (x, y) in enumerate(zip(stats_a, stats_b)):
        for k in x:
            if k in STREAM_FLOAT_STATS:
                err = np.abs(x[k] - y[k]).max()
                assert err <= ENV_ATOL * max(1.0, np.abs(y[k]).max()), \
                    (ctx, w, k, err)
            else:
                assert np.array_equal(x[k], y[k]), (ctx, w, k)
    for x, y in zip(a.per_window, b.per_window):
        for k in x:
            if k in ("mean_latency", "episode_return_mean"):
                assert abs(x[k] - y[k]) <= ENV_ATOL * max(1.0, abs(y[k])), \
                    (ctx, x["window"], k, x[k], y[k])
            else:
                assert x[k] == y[k], (ctx, x["window"], k, x[k], y[k])
    for f in a.carry._fields:
        assert torch.equal(getattr(a.carry, f).cpu(),
                           getattr(b.carry, f).cpu()), (ctx, f)
    assert np.array_equal(a.t0, b.t0), ctx
    for x, y in zip(a.leftovers, b.leftovers):
        assert all(np.array_equal(x[c], y[c]) for c in x), (ctx, "leftovers")
    for x, y in zip(a._retry, b._retry):
        assert all(np.array_equal(x[c], y[c]) for c in x), (ctx, "retry")
    assert a.fault_counters() == b.fault_counters(), ctx
    assert a.placement_counters() == b.placement_counters(), ctx


def phase_stream(dev, card, actor, B=256, windows=8, small_B=8,
                 small_windows=6, acfg=None, profile_iters=50, seed=0):
    """The stream (ROADMAP Queue 1 items 8-11) on paper-8srv: each window a
    fused `batch_rollout` of T = min(4K, max_steps) = 128 decisions from
    the carried state, with faults, placement and a recording tracer.

    1. One window from a fresh carry (no faults, no placement) equals
       `batch_rollout` on the same traces and generator state in every
       tensor, ddpm and fifo (collected transitions included), and the
       window's carry, stats and leftovers are `_window_seam` of the
       rollout's final state.
    2. The main run: B streams, `windows` windows, Poisson arrivals at the
       paper's 0.1 tasks/s (`ProcessTaskSource`), `actor` with sampler
       "ddpm", `FaultSpec.chaos(seed)`, `PlacementSpec("forecast",
       interval=2)`, a `Tracer` writing build/stream_trace.json; every
       launch count set to 0 just before it. Every window keeps the seam
       ledger; the program's loop (with fault statics: the fault
       instantiation of the env_step kernel) is built once and its graphs
       captured in window 0 only; one env_step and one chain launch per
       decision. Printed: ms per window (window 0 with its capture, the
       median of the rest), the split by span (`span_durations`), ms per
       decision inside `window_rollout`, and two more windows, the second
       under torch.profiler (device busy, idle share).
    3. Card against CPU: fifo and greedy on `small_B` streams x
       `small_windows` windows with chaos faults and forecast placement,
       the same draws on both (`_same_stream`).
    4. The trace passes `validate_trace(strict_names=True)` and holds
       STREAM_SPANS.
    5. `profile_policy`'s decision latencies for ddpm at batch 0 and B.
    Returns the main run's launches."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.actors.program import actor_program
    from repro_torch.core import agent as AG
    from repro_torch.core import env as EV
    from repro_torch.core import rollout as RO
    from repro_torch.faults import FaultSpec
    from repro_torch.placement import PlacementSpec
    from repro_torch.telemetry import profile as PR
    from repro_torch.telemetry import schema as SCH
    from repro_torch.telemetry import trace as TRC
    from repro_torch.traffic import stream as ST
    acfg = acfg or AG.AgentConfig()
    ecfg = cell_env(8)
    ddpm = actor_policy(ecfg, acfg, sampler="ddpm", device=dev)
    T = min(4 * ecfg.max_tasks, ecfg.max_steps)

    # 1. one window from a fresh carry == batch_rollout
    traces = cell_traces(dev, 8, 0.1)(
        torch.Generator(device=dev).manual_seed(seed + 1), B)
    for name, pol, params in (("ddpm", ddpm, actor),
                              ("fifo", RO.fifo_policy(ecfg), {})):
        g1 = torch.Generator(device=dev).manual_seed(seed + 2)
        g2 = torch.Generator(device=dev).manual_seed(seed + 2)
        want = RO.batch_rollout(ecfg, traces, pol, params, generator=g1,
                                num_steps=T, collect=True, device=dev)
        runner = ST.StreamRunner(ecfg, pol, params,
                                 ST.TraceTaskSource(traces), g2,
                                 ST.StreamConfig(num_streams=B), device=dev)
        got = runner.run_window(collect=True)
        assert _outputs_equal(want, got), \
            f"one window != batch_rollout, {name}"
        assert torch.equal(g1.get_state(), g2.get_state()), name
        # the window's carry, stats and leftovers: the seam of the
        # rollout's final state
        stats, carry, lcols, n_left = ST._window_seam(
            ecfg, traces, want.final_state, runner._edges, runner._sla)
        assert all(torch.equal(getattr(runner.carry, f), getattr(carry, f))
                   for f in carry._fields), (name, "carry")
        assert all(np.array_equal(got.stats[k], v.cpu().numpy())
                   for k, v in stats.items()), (name, "stats")
        n_left = n_left.cpu().numpy()
        assert all(np.array_equal(v, lcols[c][b, :n_left[b]].cpu().numpy())
                   for b, left in enumerate(runner.leftovers)
                   for c, v in left.items()), (name, "leftovers")
    log(f"phase 18 one window from a fresh carry == batch_rollout (B = {B}, "
        f"T = {T}; ddpm and fifo; metrics, transitions and the generator; "
        f"the window's carry, stats and leftovers == the seam of the "
        f"rollout's final state)")

    # 2. the main run
    path = ROOT / "build" / "stream_trace.json"
    tracer = TRC.Tracer(TRC.TraceConfig(enabled=True, path=str(path)))
    scfg = ST.StreamConfig(num_windows=windows, num_streams=B,
                           faults=FaultSpec.chaos(seed),
                           placement=PlacementSpec(policy="forecast",
                                                   interval=2))
    runner = ST.StreamRunner(
        ecfg, ddpm, actor, _stream_source(dev, B, seed + 3),
        torch.Generator(device=dev).manual_seed(seed + 4), scfg,
        tracer=tracer, device=dev)
    prog = actor_program(ecfg, ddpm)
    loops0 = set(prog._loops)
    captures_before = prog.captures
    wall_ms = []
    sync(dev)
    reset_counts()
    for w in range(windows):
        t0 = time.perf_counter()
        runner.run_window()
        sync(dev)
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        _ledger_ok(runner)
        if w == 0:
            after0 = (prog.captures, prog.loops_built)
            captured0 = prog.captures - captures_before
    counts = read_counts()
    assert (prog.captures, prog.loops_built) == after0, \
        ("a window after the first captured or built", after0,
         prog.captures, prog.loops_built)
    new = [k for k in prog._loops if k not in loops0]
    assert len(new) == 1 and EV.has_faults(prog._loops[new[0]].st), new
    if dev.type == "cuda":
        assert counts["env_step"] == counts["denoiser_chain"] == \
            windows * T, counts
    s = runner.result().summary
    assert s["tasks_failed"] > 0 and s["tasks_scheduled"] > 0, s
    pc = runner.placement_counters()
    assert pc["placement_decisions"] == windows // 2, pc
    tracer.write()
    errors = SCH.validate_trace(str(path), strict_names=True)
    assert not errors, errors[:5]
    events = json.load(open(path))["traceEvents"]
    assert set(STREAM_SPANS) <= {e["name"] for e in events}, \
        {e["name"] for e in events}

    def split(ws):
        return {k: 1e3 * v["total_s"] / len(ws) for k, v in SCH.span_durations(
            [e for e in events if e.get("args", {}).get("window") in ws]
        ).items()}
    rest = list(range(1, windows))
    roll = sorted(1e3 * e["dur"] / 1e6 for e in events
                  if e["name"] == "window_rollout" and e["args"]["window"] >= 1)
    row = {"card": card, "cell": "paper-8srv", "sampler": "ddpm",
           "streams": B, "windows": windows, "decisions_per_window": T,
           "faults": "chaos", "placement": "forecast, interval 2",
           "launches": {k: v for k, v in counts.items() if v},
           "ms_per_window": wall_ms,
           "window0_ms": wall_ms[0],
           "median_ms_per_window_1_on": float(np.median(wall_ms[1:])),
           "span_ms_per_window_1_on": split(rest),
           "span_ms_window0": split([0]),
           "ms_per_decision_in_window_rollout": float(np.median(roll)) / T,
           "captures_in_window0": captured0, "loops_built": len(new),
           "ledger": {k: s[k] for k in (
               "tasks_injected", "tasks_scheduled", "tasks_dropped",
               "tasks_failed_pending_retry", "tasks_leftover",
               "tasks_failed", "tasks_retried")},
           "fault_counters": runner.fault_counters(),
           "placement": {k: v for k, v in pc.items() if k != "per_model"},
           "latency_p50_p95": [s["latency_p50"], s["latency_p95"]]}
    # two more windows, the second under the profiler: the idle share
    row["profiled_window"] = profile_device(
        dev, lambda: runner.run_window(), 1, "window")
    _ledger_ok(runner)
    log("phase 18 stream " + json.dumps(row))

    # 3. card against CPU, fifo and greedy under faults and placement
    cpu = torch.device("cpu")
    for name, pol in (("fifo", RO.fifo_policy(ecfg)),
                      ("greedy", RO.greedy_policy(ecfg))):
        runs, stats = [], []
        for d in (dev, cpu):
            small = ST.StreamConfig(num_windows=small_windows,
                                    num_streams=small_B,
                                    faults=FaultSpec.chaos(seed),
                                    placement=PlacementSpec(
                                        policy="forecast", interval=2))
            r = ST.StreamRunner(ecfg, pol, {},
                                _stream_source(cpu, small_B, seed + 5),
                                torch.Generator(device=d).manual_seed(0),
                                small, device=d)
            stats.append([r.run_window().stats
                          for _ in range(small_windows)])
            runs.append(r)
        _same_stream(*runs, *stats, f"{name} card vs cpu")
        sm = runs[0].result().summary
        log(f"phase 18 {name} stream on the card == on the CPU "
            f"({small_B} streams x {small_windows} windows, chaos faults, "
            f"forecast placement): scheduled {sm['tasks_scheduled']}, "
            f"failed {sm['tasks_failed']}, placement "
            f"{runs[0].placement_counters()['placement_gangs_planned']} "
            f"gangs planned")

    # 5. decision latency of the ddpm actor through its act graph: the
    # host clock around the synchronised call (profile_policy, the
    # reference's measure), and CUDA events around the call
    lat, ev = {}, {}
    for batch in (0, B):
        out = PR.profile_policy(ecfg, ddpm, actor,
                                torch.Generator(device=dev).manual_seed(6),
                                iters=profile_iters, batch=batch, device=dev)
        lat[f"batch {batch}"] = {k: out[k] for k in (
            "decision_latency_p50_s", "decision_latency_p95_s",
            "decision_latency_mean_s")}
        if dev.type == "cuda":
            ev[f"batch {batch}"] = act_event_latency(
                dev, ecfg, ddpm, actor, batch, profile_iters)
    log("phase 18 decision latency, host clock " + json.dumps(
        {"card": card, "sampler": "ddpm", **lat}))
    log("phase 18 decision latency, CUDA events around act " + json.dumps(
        {"card": card, "sampler": "ddpm", **ev}))
    return counts


def act_event_latency(dev, ecfg, policy, params, batch, iters, seed=6):
    """Decision latency by CUDA events recorded around each
    `ActorProgram.act` call on the current stream, on the inputs
    `profile_policy` builds (a seeded trace, the reset state, `batch` envs
    or one), the graph captured and warmed first; the p50, p95 and mean of
    the same histogram."""
    from repro_torch.actors.program import actor_program
    from repro_torch.core import env as EV
    from repro_torch.core.workload import TraceConfig, make_trace
    from repro_torch.telemetry import profile as PR
    from repro_torch.telemetry.metrics import LatencyHistogram
    trace = make_trace(TraceConfig(num_tasks=ecfg.max_tasks,
                                   max_servers=ecfg.num_servers,
                                   num_models=ecfg.num_models),
                       generator=torch.Generator(dev).manual_seed(0),
                       device=dev)
    n = max(batch, 1)
    btrace = {k: v.expand((n,) + v.shape).contiguous()
              for k, v in trace.items()}
    st = EV.reset(ecfg, n, device=dev)
    _, obs = EV.reset_view(ecfg, btrace, st)
    prog = actor_program(ecfg, policy)
    gen = torch.Generator(dev).manual_seed(seed)
    for _ in range(3):
        prog.act(btrace, st, obs, gen, params)
    sync(dev)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    hist, total = LatencyHistogram(PR.DECISION_EDGES), 0.0
    for _ in range(iters):
        start.record()
        prog.act(btrace, st, obs, gen, params)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        hist.add_values([dt])
        total += dt
    return {"decision_latency_p50_s": hist.percentile(0.50),
            "decision_latency_p95_s": hist.percentile(0.95),
            "decision_latency_mean_s": total / iters}


# ------------------------------------------------- phases 19-20 (items 7, 8, 14)
# the dense archs phase 20 serves (by env model id) at full width: three
# copies of each fit the card beside each other
SERVE_ARCHS = ("tinyllama-1.1b", "qwen2-1.5b", "llama3.2-3b")


def _run_counted(dev, fn):
    """(fn(), launches, seconds): every launch count set to 0 just before
    `fn` and read just after, the device synchronised on both sides."""
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, read_counts(), time.perf_counter() - t0


def _same_windows(a, b, ctx):
    """Two streaming SimResults: window records, final carry and (when
    both collected) every window's transitions equal."""
    assert a.per_window == b.per_window, (ctx, a.per_window, b.per_window)
    for f in a.raw.final_carry._fields:
        assert torch.equal(getattr(a.raw.final_carry, f),
                           getattr(b.raw.final_carry, f)), (ctx, f)
    if a.raw.transitions is not None:
        for w, (x, y) in enumerate(zip(a.raw.transitions,
                                       b.raw.transitions)):
            for f in x._fields[:-1]:
                assert torch.equal(getattr(x, f), getattr(y, f)), (ctx, w, f)
            for k, v in x.extras.items():
                assert torch.equal(v, y.extras[k]), (ctx, w, k)


def phase_facade(dev, card, actor, distilled, ppo_params, B=256,
                 stream_B=64, windows=2, window_tasks=128, train_streams=16,
                 train_rounds=2, max_updates=8, sweep_streams=32,
                 offline=None, acfg=None, seed=0):
    """The API facade (ROADMAP Queue 1 items 7 and 8) at the paper's widths
    on paper-8srv, through the entry points a user calls:

    1. Episodic `Simulator(WorkloadSpec.episodic(paper-8srv, batch=B))` on
       the fused backend for random, fifo, greedy, EAT ddpm (phase 8's
       actor), EAT distilled (phase 9's student), PPO (phase 17's state),
       genetic and harmony (`offline`: their options, None = defaults),
       every launch count set to 0 just before each run: each run's
       per-episode metrics equal a direct `batch_rollout` on the traces
       and generator its documented rule gives (`split_generator`), in
       every tensor; one env_step launch per decision, one chain per ddpm
       decision, one step per distilled one. The reference backend on the
       card: no env_step launch; fifo and greedy equal to fused (ints and
       clock exact, quality and return ENV_ATOL), EAT ddpm on aggregates
       within phase 5's 5 %.
    2. Streaming: `stream_B` streams x `windows` windows of `window_tasks`
       tasks with `FaultSpec.chaos`, forecast placement and a recording
       `TraceConfig` with `profile_decisions` and `metrics_path` (under
       build/): equal to a direct `run_stream` on the same draws in every
       record and the final carry; the metrics files written, the trace
       under the strict schema.
    3. `train_stream_sac` (`train_rounds` rounds of `train_streams`
       streams, at most `max_updates` updates a round), then
       `train_stream_ppo` one round: ms, transitions and updates per
       round; the first round's transitions equal a `StreamRunner(collect=
       True)` window on the generators the trainer derives.
    4. `run_sweep(paper_scenarios(), ["fifo", "greedy"])`: one window of
       `sweep_streams` streams each, rows in the reference's schema.
    Returns launches."""
    from repro_torch import api
    from repro_torch.api.simulator import split_generator
    from repro_torch.core import agent as AG
    from repro_torch.core import ppo as PPO
    from repro_torch.core import rollout as RO
    from repro_torch.core import sac as SAC
    from repro_torch.core import scenarios as SC
    from repro_torch.faults import FaultSpec
    from repro_torch.placement import PlacementSpec
    from repro_torch.telemetry import schema as SCH
    from repro_torch.telemetry.trace import TraceConfig
    from repro_torch.traffic import stream as ST
    from repro_torch.traffic import sweep as SW
    from repro_torch.training import stream_train as STT
    acfg = acfg or AG.AgentConfig()
    cuda = dev.type == "cuda"
    sc = SC.paper_scenarios()[1]
    assert sc.name == "paper-8srv"
    ecfg = sc.ecfg
    launches = {}
    opts = offline or {}

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    # 1. episodic, every registered policy
    eat = {"acfg": acfg}
    specs = [
        ("random", api.PolicySpec("random"), {}),
        ("fifo", api.PolicySpec("fifo"), {}),
        ("greedy", api.PolicySpec("greedy"), {}),
        ("eat ddpm", api.PolicySpec("eat", params=actor, options=eat),
         {"denoiser_chain": 1}),
        ("eat distilled", api.PolicySpec("eat", params=distilled,
                                         sampler="distilled", options=eat),
         {"denoiser_step": 1}),
        ("ppo", api.PolicySpec("ppo", params=ppo_params), {}),
        ("genetic", api.PolicySpec("genetic",
                                   options=opts.get("genetic", {})), {}),
        ("harmony", api.PolicySpec("harmony",
                                   options=opts.get("harmony", {})), {})]
    fused = api.Simulator(api.WorkloadSpec.episodic(sc, batch=B), device=dev)
    ref = api.Simulator(api.WorkloadSpec.episodic(sc, batch=B),
                        api.ExecSpec(backend="reference"), device=dev)
    T = ecfg.max_steps
    table, fused_runs = [], {}
    for label, spec, per_decision in specs:
        res, counts, secs = _run_counted(dev, lambda: fused.run(spec, seed))
        add_counts(launches, counts)
        rp = fused.resolve(spec)
        g_data, g_run, _ = split_generator(gen(seed), 3, dev)
        traces = SC.make_scenario_trace_batch(sc, B, generator=g_data,
                                              device=dev)
        want = RO.batch_rollout(ecfg, traces, rp.policy, rp.params,
                                generator=g_run, device=dev)
        for k, v in want.metrics.items():
            assert np.array_equal(res.metrics[k], v.cpu().numpy()), (label, k)
        if not cuda:
            pass                  # the plain versions count no launches
        elif label in ("genetic", "harmony"):   # + the search's fitness
            assert counts["env_step"] > T, (label, counts)     # rollouts
        else:
            assert counts["env_step"] == T, (label, counts)
        for name in ("denoiser_chain", "denoiser_step"):
            assert not cuda or counts[name] == per_decision.get(name, 0) * T, \
                (label, counts)
        fused_runs[label] = res
        table.append({"policy": label, "trained": res.trained,
                      "ms_per_decision": 1e3 * res.wall_s / T,
                      "run_s": secs,
                      "launches": {k: v for k, v in counts.items() if v},
                      **{k: res.summary[k] for k in (
                          "mean_avg_response", "mean_avg_quality",
                          "mean_reload_rate", "mean_episode_return")}})
    log("phase 19 facade episodic " + json.dumps({
        "card": card, "cell": "paper-8srv", "B": B, "decisions": T,
        "runs": table,
        "check": "every run == a direct batch_rollout on the same traces "
                 "and generator state, every metric tensor"}))
    by_label = {label: spec for label, spec, _ in specs}
    for label in ("fifo", "greedy", "eat ddpm"):
        res, counts, _ = _run_counted(
            dev, lambda: ref.run(by_label[label], seed))
        add_counts(launches, counts)
        assert counts["env_step"] == 0, counts
        f = fused_runs[label]
        if label == "eat ddpm":
            agg = {}
            for key in ("avg_response", "avg_quality", "num_scheduled",
                        "episode_return"):
                a = float(np.mean(f.metrics[key], dtype=np.float64))
                b = float(np.mean(res.metrics[key], dtype=np.float64))
                agg[key] = [a, b]
                assert abs(a - b) <= 0.05 * max(abs(b), 1e-6), (key, a, b)
            log("phase 19 reference vs fused, eat ddpm closed loop: means "
                "within 5% " + json.dumps(agg))
        else:
            ctx = f"reference vs fused {label}"
            _same_state(f.raw.final_state, res.raw.final_state, ctx)
            _same_metrics({k: torch.from_numpy(v) for k, v in
                           f.metrics.items()},
                          {k: torch.from_numpy(v) for k, v in
                           res.metrics.items()}, ctx)
            log(f"phase 19 reference vs fused, {label}: final EnvState and "
                f"metrics equal (quality and return within {ENV_ATOL}); "
                f"the reference backend launches no env_step")

    # 2. streaming with faults, placement and telemetry
    build = ROOT / "build"
    tcfg = TraceConfig(enabled=True, path=str(build / "facade_trace.json"),
                       metrics_path=str(build / "facade_metrics.prom"),
                       profile_decisions=True, profile_iters=20)
    faults = FaultSpec.chaos(seed)
    place = PlacementSpec(policy="forecast", interval=1)
    wl = api.WorkloadSpec.streaming(sc, streams=stream_B,
                                    num_windows=windows,
                                    window_tasks=window_tasks)
    sim = api.Simulator(wl, api.ExecSpec(faults=faults, placement=place,
                                         trace=tcfg), device=dev)
    spec = api.PolicySpec("eat", params=actor, options=eat)
    res, counts, secs = _run_counted(dev, lambda: sim.run(spec, seed))
    add_counts(launches, counts)
    rp = sim.resolve(spec)
    ecfg_s, tcfg_s, proc = api.resolve_cell(sc, window_tasks)
    g_data, g_run, _ = split_generator(gen(seed), 3, dev)
    want = ST.run_stream(
        ecfg_s, rp.policy, rp.params,
        ST.ProcessTaskSource(proc, tcfg_s, g_data, num_streams=stream_B,
                             device=dev), g_run,
        ST.StreamConfig(num_windows=windows, num_streams=stream_B,
                        faults=faults, placement=place), device=dev)
    assert res.per_window == want.per_window, (res.per_window,
                                               want.per_window)
    for f in want.final_carry._fields:
        assert torch.equal(getattr(res.raw.final_carry, f),
                           getattr(want.final_carry, f)), f
    T_w = min(4 * window_tasks, ecfg_s.max_steps)
    # + the decision-latency probe's graphed act calls, one chain each
    assert not cuda or counts["env_step"] == windows * T_w, counts
    assert not cuda or counts["denoiser_chain"] >= windows * T_w, counts
    for p in (tcfg.metrics_path, tcfg.metrics_path + ".jsonl"):
        assert Path(p).stat().st_size > 0, p
    errors = SCH.validate_trace(tcfg.path, strict_names=True)
    assert not errors, errors[:5]
    events = json.load(open(tcfg.path))["traceEvents"]
    spans = {k: 1e3 * v["total_s"] for k, v in
             SCH.span_durations(events).items()}
    s = res.summary
    log("phase 19 facade streaming " + json.dumps({
        "card": card, "cell": f"paper-8srv, {window_tasks}-task windows",
        "streams": stream_B, "windows": windows, "decisions_per_window": T_w,
        "faults": "chaos", "placement": "forecast, interval 1",
        "run_s": secs, "wall_s": res.wall_s, "span_ms_total": spans,
        "launches": {k: v for k, v in counts.items() if v},
        "decision_latency_host_p50_p95_s": [s["decision_latency_p50_s"],
                                            s["decision_latency_p95_s"]],
        "tasks": {k: s[k] for k in ("tasks_injected", "tasks_scheduled",
                                    "tasks_dropped", "tasks_leftover")},
        "check": "== run_stream on the same draws: every window record and "
                 "the final carry"}))

    # 3. stream training
    scfg = SAC.SACConfig()
    stcfg = STT.StreamTrainConfig(rounds=train_rounds, streams=train_streams,
                                  max_updates_per_round=max_updates)
    flats, marks = [], []

    def hook(r, flat):
        flats.append(flat)

    def mark(r, row, state):
        sync(dev)
        marks.append(time.perf_counter())
    t_start = [0.0]

    def train():
        t_start[0] = time.perf_counter()
        return STT.train_stream_sac(ecfg, acfg, scfg, stcfg, seed=seed,
                                    transition_hook=hook, callback=mark,
                                    device=dev)
    out, counts, secs = _run_counted(dev, train)
    add_counts(launches, counts)
    round_ms = [float(x) for x in 1e3 * np.diff([t_start[0]] + marks)]
    g = gen(seed)
    SAC.host_rng(g)
    SAC.init_train_state(ecfg, acfg, generator=g, device=dev)
    g_src, g_stream = split_generator(g, 2, dev)
    (_, proc8, tc8), = STT.resolve_cells(ecfg, None, None)
    runner = ST.StreamRunner(
        ecfg, SAC.warmup_policy(ecfg), {},
        ST.CurriculumTaskSource([(proc8, tc8)], g_src,
                                num_streams=train_streams, device=dev),
        g_stream, ST.StreamConfig(num_streams=train_streams), device=dev)
    first = SAC.flatten_valid_transitions(
        runner.run_window(collect=True).transitions)
    for a, b in zip(first, flats[0]):
        assert np.array_equal(a, b)
    T8 = min(4 * ecfg.max_tasks, ecfg.max_steps)
    assert not cuda or counts["env_step"] == train_rounds * T8, counts
    ppo, pcounts, psecs = _run_counted(dev, lambda: STT.train_stream_ppo(
        ecfg, PPO.PPOConfig(), STT.StreamTrainConfig(
            rounds=1, streams=train_streams,
            max_updates_per_round=max_updates), seed=seed, device=dev))
    add_counts(launches, pcounts)
    assert ppo.history[0]["updates"] > 0
    assert not cuda or pcounts["env_step"] == T8, pcounts
    log("phase 19 stream training " + json.dumps({
        "card": card, "cell": "paper-8srv (Poisson 0.1, 32-task windows)",
        "streams": train_streams, "sac_round_ms": round_ms,
        "sac_rows": [{k: r[k] for k in ("transitions", "updates", "warmup",
                                        "buffer_size", "latency_p99")}
                     for r in out.history],
        "sac_launches": {k: v for k, v in counts.items() if v},
        "ppo_round_ms": 1e3 * psecs,
        "ppo_row": {k: ppo.history[0][k] for k in ("transitions",
                                                  "updates")},
        "check": "round 0's transitions == a StreamRunner(collect=True) "
                 "window on the trainer's generators"}))

    # 4. the sweep
    rows, counts, secs = _run_counted(dev, lambda: SW.run_sweep(
        SC.paper_scenarios(), ["fifo", "greedy"], seed,
        stream=ST.StreamConfig(num_windows=1, num_streams=sweep_streams),
        verbose=False, device=dev))
    add_counts(launches, counts)
    keys = set(rows[0])
    assert all(set(r) == keys for r in rows)
    assert {"policy", "trained", "mode", "exec_backend", "cell", "wall_s",
            "arrival", "num_servers", "tasks_per_wall_s",
            "latency_p99"} <= keys
    log("phase 19 sweep " + json.dumps({
        "card": card, "streams": sweep_streams, "run_s": secs,
        "rows": [{k: r[k] for k in ("cell", "policy", "tasks_injected",
                                    "latency_p50", "latency_p99",
                                    "tasks_per_wall_s")} for r in rows]}))
    return launches


def prefill_launches(cfg):
    """{kernel: launches} of one prefill of `cfg`, chunked or not: one
    flash_attention per attention layer (the encoder-decoder: per encoder
    layer and per decoder self- and cross-attention) and one ssm_scan per
    Mamba layer."""
    from repro_torch.models.lm import n_periods, period_spec
    if cfg.family == "audio":
        return {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers,
                "ssm_scan": 0}
    spec = period_spec(cfg)
    return {name: n_periods(cfg) * sum(m == kind for m, _ in spec)
            for name, kind in (("flash_attention", "attn"),
                               ("ssm_scan", "mamba"))}


def _attn_layers(arch):
    from repro_torch.common.config import get_config
    return prefill_launches(get_config(arch))["flash_attention"]


def _task_rows(events):
    """Per executed task, from the serving trace: arch, c, reuse, steps,
    the task's ms, its weight-load ms and its prefill + decode ms (the
    spans nested in its `execute_task`)."""
    spans = [e for e in events if e.get("ph") == "X"]
    rows = []
    for e in spans:
        if e["name"] != "execute_task":
            continue
        lo, hi = e["ts"], e["ts"] + e["dur"]
        inner = [c for c in spans if c is not e and lo <= c["ts"]
                 and c["ts"] + c["dur"] <= hi]

        def ms(name):
            return sum(c["dur"] for c in inner if c["name"] == name) / 1e3
        a = e["args"]
        rows.append({"arch": a["arch"], "c": a["c"], "reuse": a["reuse"],
                     "steps": a["steps"], "task_ms": e["dur"] / 1e3,
                     "load_ms": ms("model_load"),
                     "generate_ms": ms("prefill") + ms("decode"),
                     "prefill_ms": ms("prefill")})
    return rows


def phase_serving(dev, card, actor, archs=SERVE_ARCHS, reduced=False,
                  mirror_tasks=32, exec_tasks=16, wall_tasks=8,
                  prompt_len=256, acfg=None, seed=0):
    """The stream-native serving backend (ROADMAP Queue 1 item 14) on
    `multi_model_mix(8, 3)`, one stream, through `Simulator(ExecSpec(
    backend="serving"))` and `serve_stream`:

    a. mirror (`serving_execute=False`): 2 windows of `mirror_tasks` tasks
       against the fused backend at B = 1 on the same draws and
       generator: fifo, greedy and EAT (phase 8's actor, ddpm) closed loop
       equal in every window record, the final carry and the collected
       transitions (one env_step launch per decision, one chain per EAT
       decision); EAT's fused actions replayed through `sequence_policy`
       on a `ServingStreamRunner`, equal too;
    b. executed in virtual time at full width (`archs`, fp32, prompts of
       `prompt_len` tokens), 1 window of `exec_tasks` tasks, EAT ddpm:
       final carry, records and transitions equal to the mirror's; one
       chain launch per decision, one flash_attention launch per attention
       layer of every executed prefill; per task the load and generate
       ms, arch, c and reuse (from the trace), the pool ledger,
       `serving_stats()`, the split by span, peak device memory;
    c. wall clock (warmup on), tinyllama-1.1b, `wall_tasks` tasks, with
       injected executor errors (`FaultSpec(seed=2, exec_error_prob=0.3)`):
       measured busy seconds per task, the retry, degrade and give-up
       counters; the first patched decision's reward, obs and state held
       to `wall_patch` on the CPU (ENV_ATOL, state exact);
    d. `serve_stream` through `ServingStreamRunner`, 1 window, fifo on
       tinyllama-1.1b reduced.
    `reduced=True` shrinks b and c for a rehearsal on the CPU. Returns
    launches."""
    from repro_torch import api
    from repro_torch.api.simulator import split_generator
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    from repro_torch.core import scenarios as SC
    from repro_torch.faults import FaultSpec
    from repro_torch.serving import backend as SB
    from repro_torch.serving import runner as SR
    from repro_torch.telemetry import schema as SCH
    from repro_torch.telemetry.trace import TraceConfig
    from repro_torch.traffic import stream as ST
    acfg = acfg or AG.AgentConfig()
    sc = SC.multi_model_mix(8, 3)
    launches = {}
    eat = api.PolicySpec("eat", params=actor, options={"acfg": acfg})
    mirror_spec = api.ExecSpec(backend="serving", serving_archs=archs,
                               serving_execute=False)

    # a. mirror against fused at B = 1
    wl = api.WorkloadSpec.streaming(sc, streams=1, num_windows=2,
                                    window_tasks=mirror_tasks, collect=True)
    T = min(4 * mirror_tasks, sc.ecfg.max_steps)
    fused_eat = None
    for label, spec in (("fifo", api.PolicySpec("fifo")),
                        ("greedy", api.PolicySpec("greedy")),
                        ("eat ddpm", eat)):
        f = api.Simulator(wl, device=dev).run(spec, seed)
        m, counts, secs = _run_counted(dev, lambda: api.Simulator(
            wl, mirror_spec, device=dev).run(spec, seed))
        add_counts(launches, counts)
        _same_windows(f, m, f"mirror vs fused {label}")
        if dev.type == "cuda":
            assert counts["env_step"] == 2 * T, counts
            if label == "eat ddpm":
                assert counts["denoiser_chain"] == 2 * T, counts
        if label == "eat ddpm":
            fused_eat = f
        log(f"phase 20a serving mirror == fused at B = 1, {label}, closed "
            f"loop: 2 windows of {mirror_tasks} tasks ({T} decisions each), "
            f"every record, the final carry and the transitions; "
            f"{1e3 * secs / (2 * T):.4f} ms a decision, launches "
            + json.dumps({k: v for k, v in counts.items() if v}))
    ecfg_s, tcfg_s, proc = api.resolve_cell(sc, mirror_tasks)
    g_data, g_run, _ = split_generator(
        torch.Generator(device=dev).manual_seed(seed), 3, dev)
    runner = SR.ServingStreamRunner(
        ecfg_s, RO.sequence_policy(ecfg_s), None,
        ST.ProcessTaskSource(proc, tcfg_s, g_data, device=dev), g_run,
        ST.StreamConfig(num_streams=1),
        rollout_fn=SB.ServingRollout(8, archs=archs, execute=False,
                                     device=dev), device=dev)
    for tr in fused_eat.raw.transitions:
        runner.run_window(params={"seq": tr.action})
    assert runner.per_window == fused_eat.per_window
    for f in runner.carry._fields:
        assert torch.equal(getattr(runner.carry, f),
                           getattr(fused_eat.raw.final_carry, f)), f
    log("phase 20a serving mirror, EAT teacher-forced: the fused run's "
        "actions replayed through sequence_policy == the fused run (records "
        "and final carry)")

    # b. executed, virtual time, full width
    wl16 = api.WorkloadSpec.streaming(sc, streams=1, num_windows=1,
                                      window_tasks=exec_tasks, collect=True)
    T16 = min(4 * exec_tasks, sc.ecfg.max_steps)
    mirror16 = api.Simulator(wl16, mirror_spec, device=dev).run(eat, seed)
    path = ROOT / "build" / "serve_trace.json"
    real = api.Simulator(wl16, api.ExecSpec(
        backend="serving", serving_archs=archs, serving_reduced=reduced,
        serving_prompt_len=prompt_len,
        trace=TraceConfig(enabled=True, path=str(path))), device=dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    r, counts, secs = _run_counted(dev, lambda: real.run(eat, seed))
    add_counts(launches, counts)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    _same_windows(mirror16, r, "executed vs mirror")
    events = json.load(open(path))["traceEvents"]
    assert not SCH.validate_trace(str(path), strict_names=True)
    tasks = _task_rows(events)
    stats = r.summary
    assert len(tasks) == stats["tasks_executed"] > 0
    if dev.type == "cuda":
        assert counts["denoiser_chain"] == T16, counts
        want_fa = sum(_attn_layers(t["arch"]) for t in tasks)
        assert counts["flash_attention"] == want_fa, (counts, want_fa)
    split = {k: 1e3 * v["self_total_s"] for k, v in
             SCH.span_durations(events).items()}
    log("phase 20b serving executed " + json.dumps({
        "card": card, "cell": "serve-3arch-8srv", "archs": list(archs),
        "reduced": reduced, "prompt_len": prompt_len, "tasks": exec_tasks,
        "decisions": T16, "run_s": secs, "wall_s": r.wall_s,
        "launches": {k: v for k, v in counts.items() if v},
        "attention_layers": {a: _attn_layers(a) for a in archs},
        "per_task": tasks,
        "pool": {k: stats[k] for k in ("model_loads", "model_reuses",
                                       "tasks_executed")},
        "serving_stats": {k: v for k, v in stats.items() if k.startswith(
            ("policy_", "env_advance_", "executor_", "decision_"))},
        "span_self_ms": split, "peak_device_gib": peak,
        "check": "final carry, records and transitions == the mirror's"}))
    del real, r
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # c. wall clock with injected executor errors
    wl8 = api.WorkloadSpec.streaming(sc, streams=1, num_windows=1,
                                     window_tasks=wall_tasks)
    wall = api.Simulator(wl8, api.ExecSpec(
        backend="serving", serving_archs=("tinyllama-1.1b",),
        serving_reduced=reduced, serving_wall_clock=True,
        serving_prompt_len=prompt_len,
        faults=FaultSpec(seed=2, exec_error_prob=0.3)), device=dev)
    seen = []
    plain_patch = SB.wall_patch

    def recording_patch(*args):
        out = plain_patch(*args)
        if not seen:
            seen.append((args, out))
        return out
    SB.wall_patch = recording_patch
    try:
        w, counts, secs = _run_counted(dev, lambda: wall.run("greedy", seed))
    finally:
        SB.wall_patch = plain_patch
    add_counts(launches, counts)
    inner = wall._rollout.inner
    fc = wall._rollout.fault_counters()
    assert inner.warmup and len(inner.measured_busy) == inner.tasks_executed
    assert fc["exec_retries"] > 0, fc
    cpu = torch.device("cpu")
    (ecfg_w, trace, q_pre, nstate, k, sel, busy), got = seen[0]
    want = plain_patch(ecfg_w, {k_: v.cpu() for k_, v in trace.items()},
                       type(q_pre)(*(x.cpu() for x in q_pre)),
                       type(nstate)(*(x.cpu() for x in nstate)), k,
                       sel.cpu(), busy.cpu())
    _same_state(type(nstate)(*(x.cpu() for x in got[0])), want[0],
                "wall patch card vs cpu")
    for i, name in ((2, "obs"), (3, "reward")):
        err = (got[i].cpu() - want[i]).abs().max().item()
        assert err <= ENV_ATOL * max(1.0, want[i].abs().max().item()), \
            (name, err)
    assert torch.equal(got[4].cpu(), want[4])
    log("phase 20c serving wall clock " + json.dumps({
        "card": card, "arch": "tinyllama-1.1b", "reduced": reduced,
        "tasks": wall_tasks, "run_s": secs,
        "measured_busy_s": inner.measured_busy, "fault_counters": fc,
        "latency_p50_p99": [w.summary["latency_p50"],
                            w.summary["latency_p99"]],
        "launches": {k_: v for k_, v in counts.items() if v},
        "check": "the first patched decision: state exact, reward and obs "
                 "within ENV_ATOL of wall_patch on the CPU"}))
    del wall, inner
    gc.collect()

    # d. serve_stream
    fn = api.rollout_fn_for(api.ExecSpec(
        backend="serving", serving_archs=("tinyllama-1.1b",)))
    ecfg8, tcfg8, proc8 = api.resolve_cell(sc, wall_tasks)
    res, counts, secs = _run_counted(dev, lambda: SR.serve_stream(
        ecfg8, RO.fifo_policy(ecfg8), {},
        ST.ProcessTaskSource(proc8, tcfg8,
                             torch.Generator(device=dev).manual_seed(seed),
                             device=dev),
        torch.Generator(device=dev).manual_seed(seed + 1),
        ST.StreamConfig(num_windows=1, num_streams=1), rollout_fn=fn,
        device=dev))
    add_counts(launches, counts)
    assert res.summary["tasks_executed"] == res.summary["tasks_scheduled"] > 0
    assert res.summary["wall_clock"] is False
    log("phase 20d serve_stream " + json.dumps({
        "card": card, "run_s": secs,
        "summary": {k: res.summary[k] for k in (
            "tasks_scheduled", "tasks_executed", "model_loads",
            "model_reuses", "latency_p50")},
        "launches": {k: v for k, v in counts.items() if v}}))
    return launches


def phase_flash(dev, cases=FA_CASES):
    """flash_attention kernel through the (B, S, H, hd) entry point vs its
    plain version (`flash_plain`), fp32 and bf16; returns (max error over the
    fp32 cases, {"tinyllama": ..., "jamba": ...}: the fp32 inputs of the
    two prefill cases, for timing)."""
    from repro_torch.kernels.flash_attention import ops as FA
    g = torch.Generator(device=dev).manual_seed(6)
    worst, timing = {}, {}
    for (case, B, S, T, H, KV, hd, causal, window) in cases:
        q32 = torch.randn((B, S, H, hd), generator=g, device=dev)
        k32 = torch.randn((B, T, KV, hd), generator=g, device=dev)
        v32 = torch.randn((B, T, KV, hd), generator=g, device=dev)
        errs = {}
        for dtype, tol in FA_TOL.items():
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            got = FA.attention(q, k, v, causal=causal, window=window)
            want = flash_plain(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
            sync(dev)
            assert got.dtype == dtype and got.shape == (B, S, H, hd)
            assert bool(torch.isfinite(got).all()), case
            diff = (got.float() - want).abs()
            excess = (diff - tol * (1.0 + want.abs())).max().item()
            assert excess <= 0.0, f"flash {case} {dtype}: err {diff.max()}"
            name = str(dtype).replace("torch.", "")
            errs[name] = diff.max().item()
            worst[name] = max(worst.get(name, 0.0), errs[name])
        if case in ("tinyllama prefill", "jamba prefill"):
            timing[case.split()[0]] = (q32, k32, v32)
        log(f"phase 11 flash_attention {case}: B={B} S={S} T={T} H={H} "
            f"KV={KV} hd={hd} causal={causal} window={window}; max abs err "
            + json.dumps(errs))
    log(f"phase 11 flash_attention kernel ~ plain on {len(cases)} cases: "
        f"max abs err {json.dumps(worst)} (tol fp32 {FA_TOL[torch.float32]}, "
        f"bf16 {FA_TOL[torch.bfloat16]}, rtol = atol)")
    return worst["float32"], timing


def phase_ssm(dev, cases=SSM_CASES):
    """ssm_scan kernel vs plain version (`impl="ref"`) through
    `selective_scan`, the error of y and of hT relative to max(1, max|.|)
    of the plain version's. A case with dt_rank > 0 takes B and C as splits
    of one (B, S, dt_rank + 2N) tensor, strided views as `_mamba_inner`
    gives them on the main path (dt_rank = 3 leaves their rows 4-byte
    aligned only); a case with dt_max > 0 draws strong decays; returns
    (max fp32 error of y, timing inputs at Jamba's prefill shape from a
    random state)."""
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.models.layers import softplus
    g = torch.Generator(device=dev).manual_seed(13)
    worst, timing = {}, None
    for (case, B, S, I, N, dtype, rand_h0, dt_rank, dt_max) in cases:
        rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
        if dt_max:
            uni = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa: E731
            dt, a = dt_max * uni(B, S, I), -torch.exp(6 * uni(I, N) - 3)
        else:
            dt, a = softplus(rnd(B, S, I)), -torch.exp(rnd(I, N))
        if dt_rank:
            _, bm, cm = torch.split(rnd(B, S, dt_rank + 2 * N),
                                    [dt_rank, N, N], dim=-1)
            assert bm.stride(1) == dt_rank + 2 * N, bm.stride()
            x = rnd(B, S, I)
        else:
            bm, cm, x = rnd(B, S, N), rnd(B, S, N), rnd(B, S, I)
        h0 = rnd(B, I, N) if rand_h0 else None
        args = [t.to(dtype) for t in (dt, a, bm, cm, x)]
        got = SS.selective_scan(*args, h0)
        want = SS.selective_scan(*args, h0, impl="ref")
        sync(dev)
        tol = SSM_TOL[dtype]
        errs = {}
        for name, g_, w_ in (("y", *[r[0] for r in (got, want)]),
                             ("hT", *[r[1] for r in (got, want)])):
            assert g_.dtype == w_.dtype and g_.shape == w_.shape, (case, name)
            assert bool(torch.isfinite(g_).all()), (case, name)
            err = (g_.float() - w_.float()).abs().max().item()
            scale = max(1.0, w_.float().abs().max().item())
            assert err <= tol * scale, f"ssm_scan {case} {name}: {err} > {tol} x {scale}"
            errs[name] = {"max_abs_err": err, "scale": scale}
        dname = str(dtype).replace("torch.", "")
        worst[dname] = max(worst.get(dname, 0.0), errs["y"]["max_abs_err"])
        if case == "jamba prefill, random h0":
            timing = (*args, h0)
        log(f"phase 13 ssm_scan {case}: B={B} S={S} I={I} N={N} {dname}; "
            f"tol {tol} x scale; " + json.dumps(errs))
    log(f"phase 13 ssm_scan kernel ~ plain on {len(cases)} cases: max abs "
        f"err of y {json.dumps(worst)}")
    return worst["float32"], timing


class SyncTimer:
    """A tracer for the executor's `tracer=` hook: every span waits for the
    device at its start and end and records (name, args, seconds) on the
    synchronised host clock."""
    enabled = True

    def __init__(self, dev):
        self.dev, self.spans = dev, []

    @contextlib.contextmanager
    def span(self, name, cat="phase", **args):
        sync(self.dev)
        t0 = time.perf_counter()
        yield
        sync(self.dev)
        self.spans.append((name, args, time.perf_counter() - t0))


def _logits_at(ex, arch, params, req, tokens, impl):
    """Last logits after prefilling req.prompt and decoding `tokens`."""
    model = ex.model(arch)
    logits, cache = ex.prefill(arch, params, req.prompt, req.patches,
                               req.steps, req.max_new_tokens, impl=impl)
    for t in tokens:
        tok = torch.tensor([[int(t)]], device=ex.device)
        logits, cache = model.decode(params, cache, tok, torch.float32)
    return logits[0, -1, :model.cfg.vocab_size]


def _compare_served(ex, arch, params, req, phase):
    """A served request's prefill logits and greedy tokens, kernel path
    against the plain attention and scan on the same params; logs the row."""
    lk = _logits_at(ex, arch, params, req, [], "auto")
    lr = _logits_at(ex, arch, params, req, [], "ref")
    err = (lk - lr).abs().max().item()
    scale = max(1.0, lr.abs().max().item())
    assert err <= LOGIT_RTOL * scale, (req.rid, err, scale)
    toks_ref = ex.generate(arch, params, req.prompt, req.patches, req.steps,
                           req.max_new_tokens, impl="ref")
    row = {"arch": arch, "rid": req.rid, "c": req.patches,
           "prompt": len(req.prompt),
           "steps": req.steps, "max_abs_logit_err": err,
           "max_abs_logit": scale, "tol": LOGIT_RTOL * scale,
           "tokens_equal": bool(np.array_equal(req.tokens, toks_ref))}
    if not row["tokens_equal"]:
        i = int(np.argmax(req.tokens != toks_ref))
        a_k, a_r = int(req.tokens[i]), int(toks_ref[i])
        gaps = {}
        for impl in ("auto", "ref"):
            lg = _logits_at(ex, arch, params, req, req.tokens[:i], impl)
            gaps[impl] = (lg[a_k] - lg[a_r]).item()
        row["first_fork"] = {"index": i, "kernel_token": a_k,
                             "plain_token": a_r,
                             "logit_gap_kernel_minus_plain_token": gaps}
    log(f"phase {phase} kernel vs plain " + json.dumps(row))


def phase_serve(dev, card, actor, *, phase, arch, num_servers, rate,
                n_compare, n_requests=16, max_decisions=4096,
                reduced=False, prompt_max=2048):
    """A serving main path: a ServingEngine of `num_servers` servers
    serving `arch` in virtual time, fed the first n_requests tasks of a
    trace at `rate` tasks/s on that many servers (prompts of
    prompt_max/8 - prompt_max tokens, 16 new tokens each) as the clock
    reaches them, every decision from the EAT actor `actor` (sampler
    "ddpm") on engine.observe(), every launch count set to 0 just before;
    weight loads, prefill and decode are timed on the synchronised host
    clock. The launch counts must be `prefill_launches` of each served
    prefill (one flash_attention launch per attention layer, one ssm_scan
    launch per Mamba layer) and one chain launch per decision.
    `n_compare` served requests (the first of each new c where the
    prefill is chunked, since c then changes its shapes, else the first of
    each prompt length a quarter of prompt_max from those compared) are
    held to the plain attention and scan as soon as they are served, before
    a later load can drop their weights; those launches and that time are
    left out of the run's. Then a profiled generate at
    S = prompt_max. `reduced` and `prompt_max` shrink it for a rehearsal
    on the CPU. Returns (the launches of the served run, requests
    served)."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.common.pytree import param_count
    from repro_torch.core import agent as AG
    from repro_torch.core.workload import TraceConfig, make_trace
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.executor import chunkable
    from repro_torch.telemetry.trace import NULL_TRACER
    ecfg, acfg = cell_env(num_servers), AG.AgentConfig()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(num_servers=num_servers, archs=[arch],
                        queue_window=8, reduced=reduced, time_dilation=1.0,
                        s_min=4, s_max=32, device=dev)
    ex = eng.executor
    cfg = ex.model(arch).cfg
    assert eng.observe().shape == ecfg.obs_shape, eng.observe().shape
    gen = torch.Generator(device=dev).manual_seed(12)
    tr = make_trace(TraceConfig(num_tasks=32, arrival_rate=rate,
                                max_servers=num_servers), generator=gen,
                    device=dev)
    arrive = tr["arr_time"][:n_requests].tolist()
    cs = tr["c"][:n_requests].tolist()
    rng = np.random.default_rng(12)
    lens = rng.integers(prompt_max // 8, prompt_max + 1, n_requests)
    pending = [Request(rid=i, arch=arch,
                       prompt=rng.integers(0, cfg.vocab_size, int(lens[i])),
                       patches=int(cs[i]), arrive_t=float(arrive[i]),
                       max_new_tokens=16) for i in range(n_requests)]
    policy = actor_policy(ecfg, acfg, sampler="ddpm", device=dev)
    timer = SyncTimer(dev)
    ex.tracer = timer
    compared = []             # the requests held to the plain versions
    compare_s = []            # seconds spent on them, left out of wall_s
    loads = []                # seconds of each weight load since the last

    def wanted(req):
        if len(compared) >= n_compare:
            return False
        if chunkable(cfg):        # c changes the chunked prefill's shapes
            return all(r.patches != req.patches for r in compared)
        return all(abs(len(r.prompt) - len(req.prompt)) >= prompt_max // 4
                   for r in compared)

    def generate_and_compare(req, steps, servers):
        eng.__class__._generate(eng, req, steps, servers)
        if wanted(req):
            compared.append(req)
            sync(dev)
            t = time.perf_counter()
            ex.tracer = NULL_TRACER
            with uncounted():
                _compare_served(ex, arch, servers[0].params, req, phase)
            ex.tracer = timer
            sync(dev)
            compare_s.append(time.perf_counter() - t)

    def timed_load(server, arch_):
        sync(dev)
        t = time.perf_counter()
        eng.__class__._load(eng, server, arch_)
        sync(dev)
        loads.append(time.perf_counter() - t)
    eng._generate, eng._load = generate_and_compare, timed_load
    rows, decisions = [], 0
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    while (pending or eng.queue) and decisions < max_decisions:
        while pending and pending[0].arrive_t <= eng.now():
            eng.submit(pending.pop(0))
        obs = torch.from_numpy(eng.observe()).to(dev)[None]
        a, _ = policy(actor, gen, None, None, obs)
        req = eng.try_schedule(a[0].cpu().numpy())
        decisions += 1
        if req is not None:
            (_, _, pre_s), (_, _, dec_s) = timer.spans[-2:]
            rows.append({"rid": req.rid, "c": req.patches,
                         "prompt": len(req.prompt), "steps": req.steps,
                         "reused": req.reused, "loads": len(loads),
                         "load_ms": 1e3 * sum(loads),
                         "prefill_ms": 1e3 * pre_s,
                         "decode_ms_per_token": 1e3 * dec_s / req.steps})
            loads.clear()
            log(f"phase {phase} served " + json.dumps(rows[-1]))
    sync(dev)
    secs = time.perf_counter() - t0 - sum(compare_s)
    del eng._generate, eng._load          # no cycle keeps the weights alive
    counts = read_counts()
    served = len(eng.done)
    assert served == n_requests and not pending and not eng.queue, \
        (served, len(pending), len(eng.queue), decisions)
    for r in eng.done:
        assert r.tokens is not None and len(r.tokens) == r.steps
        assert ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
    assert len(compared) == n_compare, [len(r.prompt) for r in compared]
    per_prefill = prefill_launches(cfg)
    want = {"env_step": 0, "denoiser_step": 0, "denoiser_chain": decisions,
            "flash_attention": per_prefill["flash_attention"] * served,
            "ssm_scan": per_prefill["ssm_scan"] * served,
            "flash_attention_bwd": 0, "ssm_scan_bwd": 0}
    assert counts == want, (counts, want)
    qos = eng.qos_summary()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    params = next(s.params for s in eng.pool.servers if s.params is not None)
    log(f"phase {phase} serve " + json.dumps({
        "card": card, "arch": arch, "params": param_count(params),
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "servers": num_servers, "trace_rate": rate, "requests": n_requests,
        "decisions": decisions, "wall_s": secs,
        "compare_s": sum(compare_s), "launches": counts,
        "launches_per_request": {k: counts[k] / served for k in
                                 ("flash_attention", "ssm_scan")},
        "weight_loads": eng.pool.load_count,
        "peak_device_bytes": peak, "qos_summary": qos}))

    # one full generate at S = prompt_max under torch.profiler
    prompt = rng.integers(0, cfg.vocab_size, prompt_max)
    ex.tracer = NULL_TRACER

    def run():
        ex.generate(arch, params, prompt, 1, 16, 16)
    with uncounted():
        prof = profile_device(dev, run, 1, "generate")
    log(f"phase {phase} profile " + json.dumps({
        "card": card, "arch": arch, "prompt": prompt_max, "c": 1, "steps": 16,
        **prof}))
    return counts, served


def phase_serve_tinyllama(dev, card, actor, **kw):
    """Phase 12: tinyllama-1.1b at full width on 8 servers, the paper-8srv
    trace (0.1 tasks/s), phase 8's actor deciding; three requests of
    different c held to the plain attention."""
    return phase_serve(dev, card, actor, phase=12, arch="tinyllama-1.1b",
                       num_servers=8, rate=0.1, n_compare=3, **kw)


def register_jamba_cut():
    """Register JAMBA_CUT in the port's registry: jamba-v0.1-52b with its
    depth cut to one period (8 layers) and no experts."""
    from repro_torch.common.config import get_config, register
    register(JAMBA_CUT)(lambda: dataclasses.replace(
        get_config("jamba-v0.1-52b"), name=JAMBA_CUT, num_layers=8,
        moe=None))


def phase_serve_jamba(dev, card, actor=None, **kw):
    """Phase 14, cell serve-jamba8l-4srv: JAMBA_CUT at full width on 4
    servers (without experts: four copies of the period with its experts,
    49.4 GiB each, do not fit the card), the first 16 tasks of a trace at
    0.05 tasks/s (paper-8srv's rate per server, c in {1, 2, 4}), decisions
    from an EAT actor with seeded random weights for 4 servers
    (`actor=None`); two requests of different prompt length held to the
    plain scan and attention."""
    from repro_torch.core import agent as AG
    register_jamba_cut()
    if actor is None:
        actor = AG.init_actor(
            cell_env(4), AG.AgentConfig(),
            generator=torch.Generator(device=dev).manual_seed(14), device=dev)
    return phase_serve(dev, card, actor, phase=14, arch=JAMBA_CUT,
                       num_servers=4, rate=0.05, n_compare=2, **kw)


# --------------------------------------------- phase 21 (item 13, serving)
OLMOE = "olmoe-1b-7b"
# phase 21c's config: one period of Jamba with its experts (MoE FFNs on
# layers 1, 3, 5 and 7), registered in the port's registry at run time
JAMBA_PERIOD = "jamba-v0.1-52b-8l"
ZOO_FULL = ("whisper-small", "internvl2-1b", "xlstm-125m", JAMBA_PERIOD)
ZOO_PROMPTS = (256, 1024)


def _held_request(arch, prompt, c, steps, max_new_tokens, tokens, rid):
    """A served generate call as a `Request` for `_compare_served`."""
    from repro_torch.serving import Request
    req = Request(rid=rid, arch=arch, prompt=np.asarray(prompt), patches=c,
                  arrive_t=0.0, max_new_tokens=max_new_tokens)
    req.steps, req.tokens = steps, tokens
    return req


def phase_serve_default(dev, card, actor, acfg=None, rate=0.05, seed=21):
    """Phase 21a: the serving backend at its default, `ExecSpec(backend=
    "serving")` with no `serving_archs` (the reference's ASSIGNED_ARCHS,
    reduced widths), through `api.evaluate_batch` on one trace of an
    8-server env with ten models (K = 32, `rate` tasks/s), task i carrying
    model id i % 10 (set on the numpy trace), EAT (`actor`, ddpm)
    deciding until every task is resolved. Every arch is served; each
    arch's first served request is held to the plain attention and scan on
    the card as it is served (launches and time left out); the
    flash_attention and ssm_scan launches are `prefill_launches` of each
    executed prefill. Returns launches."""
    from repro_torch import api
    from repro_torch.common.config import ASSIGNED_ARCHS, get_config
    from repro_torch.core import agent as AG
    from repro_torch.serving.executor import ModelExecutor
    acfg = acfg or AG.AgentConfig()
    n = len(ASSIGNED_ARCHS)
    # the episode ends when every task is resolved (or at 1024 decisions),
    # not at the cell's 1024 s, so each model id's tasks are all served
    ecfg = dataclasses.replace(cell_env(8), num_models=n, time_limit=1e5)
    tr = np_traces(np.random.default_rng(seed), 1, ecfg.max_tasks, 8, n,
                   False, rate=rate)
    tr["model"][0] = np.arange(ecfg.max_tasks) % n
    traces = {k: torch.from_numpy(v).to(dev) for k, v in tr.items()}
    served, compare_s = {}, []
    plain_generate = ModelExecutor.generate

    def generate(ex, arch, params, prompt, c, steps, max_new_tokens=16,
                 **kw):
        tokens = plain_generate(ex, arch, params, prompt, c, steps,
                                max_new_tokens, **kw)
        if kw.get("impl", "auto") != "auto":     # the comparison's own
            return tokens
        served[arch] = served.get(arch, 0) + 1
        if served[arch] == 1:
            sync(dev)
            t = time.perf_counter()
            with uncounted():
                _compare_served(ex, arch, params, _held_request(
                    arch, prompt, c, steps, max_new_tokens, tokens,
                    len(served) - 1), "21a")
            sync(dev)
            compare_s.append(time.perf_counter() - t)
        return tokens
    ModelExecutor.generate = generate
    try:
        metrics, counts, secs = _run_counted(dev, lambda: api.evaluate_batch(
            ecfg, traces, api.PolicySpec("eat", params=actor,
                                         options={"acfg": acfg}),
            torch.Generator(device=dev).manual_seed(seed),
            exec_spec=api.ExecSpec(backend="serving"), device=dev))
    finally:
        ModelExecutor.generate = plain_generate
    assert sorted(served) == sorted(ASSIGNED_ARCHS), (served, metrics)
    want = {}
    for arch, n in served.items():
        for name, per in prefill_launches(get_config(arch).reduced()).items():
            want[name] = want.get(name, 0) + n * per
    if dev.type == "cuda":
        for name in ("flash_attention", "ssm_scan"):
            assert counts[name] == want[name], (name, counts, want)
        # one env_step a decision until the episode is done, one chain a
        # decision of the policy
        assert counts["denoiser_chain"] >= counts["env_step"] >= int(
            metrics["episode_len"][0]) > 0, (counts, metrics)
    log("phase 21a serving default archs " + json.dumps({
        "card": card, "archs": list(ASSIGNED_ARCHS), "reduced": True,
        "servers": 8, "trace_rate": rate, "run_s": secs - sum(compare_s),
        "compare_s": sum(compare_s), "prefills_per_arch": served,
        "launches": {k: v for k, v in counts.items() if v},
        "prefill_launches_want": want,
        "metrics": {k: float(v[0]) for k, v in metrics.items()}}))
    return counts


def phase_serve_olmoe(dev, card, actor=None, **kw):
    """Phase 21b, cell serve-olmoe-2srv: olmoe-1b-7b at full width (fp32)
    on 2 servers, the first 16 tasks of a trace at 0.025 tasks/s (the
    paper's 0.0125 a server, gangs of 1 or 2), decisions from an EAT actor
    with seeded random weights for 2 servers (`actor=None`); two requests
    of different c held to the plain attention. At most two weight copies
    (25.8 GiB each) are resident."""
    from repro_torch.core import agent as AG
    if actor is None:
        actor = AG.init_actor(
            cell_env(2), AG.AgentConfig(),
            generator=torch.Generator(device=dev).manual_seed(22), device=dev)
    return phase_serve(dev, card, actor, phase="21b", arch=OLMOE,
                       num_servers=2, rate=0.025, n_compare=2, **kw)


def register_jamba_period():
    """Register JAMBA_PERIOD in the port's registry: jamba-v0.1-52b with
    its depth cut to one period (8 layers), experts kept."""
    from repro_torch.common.config import get_config, register
    register(JAMBA_PERIOD)(lambda: dataclasses.replace(
        get_config("jamba-v0.1-52b"), name=JAMBA_PERIOD, num_layers=8))


def phase_zoo(dev, card, archs=ZOO_FULL, prompts=ZOO_PROMPTS, steps=16,
              reduced=False, seed=23):
    """Phase 21c: each remaining family at full width through
    `ModelExecutor.generate`, one weight copy at a time (the last one gone
    before the next load): per prompt length the load, prefill and decode
    ms on the synchronised host clock, the launches of its prefill against
    `prefill_launches`, and the request held to the plain attention and
    scan (those launches and that time left out). `reduced` shrinks it for
    a rehearsal on the CPU. Returns launches."""
    from repro_torch.common.pytree import param_count
    from repro_torch.serving.executor import ModelExecutor
    register_jamba_period()
    timer = SyncTimer(dev)
    ex = ModelExecutor(reduced=reduced, tracer=timer, device=dev)
    rng = np.random.default_rng(seed)
    launches = {}
    for arch in archs:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t = time.perf_counter()
        params = ex.init_params(arch, torch.Generator(
            device=dev).manual_seed(seed))
        sync(dev)
        load_s = time.perf_counter() - t
        cfg = ex.model(arch).cfg
        want = prefill_launches(cfg)
        rows = []
        for i, plen in enumerate(prompts):
            prompt = rng.integers(0, cfg.vocab_size, plen)
            timer.spans.clear()
            reset_counts()
            tokens = ex.generate(arch, params, prompt, 1, steps, 16)
            counts = read_counts()
            add_counts(launches, counts)
            if dev.type == "cuda":
                got = {k: counts[k] for k in want}
                assert got == want, (arch, got, want)
            (_, _, pre_s), (_, _, dec_s) = timer.spans[-2:]
            with uncounted():
                _compare_served(ex, arch, params, _held_request(
                    arch, prompt, 1, steps, 16, tokens, i), "21c")
            rows.append({"prompt": plen, "prefill_ms": 1e3 * pre_s,
                         "decode_ms_per_token": 1e3 * dec_s / steps,
                         "launches": {k: v for k, v in counts.items() if v}})
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
        log("phase 21c zoo " + json.dumps({
            "card": card, "arch": arch, "family": cfg.family,
            "params": param_count(params), "layers": cfg.num_layers,
            "d_model": cfg.d_model, "load_ms": 1e3 * load_s,
            "prefill_launches_want": want, "per_prompt": rows,
            "peak_device_gib": peak}))
        del params
    return launches


# ------------------------------------------------------ phase 22: training
def _rel_err(got, want):
    """(max |got - want|, max |want|) in fp32."""
    want = want.float()
    return ((got.float() - want).abs().max().item(),
            want.abs().max().item())


def phase_flash_bwd(dev, cases=FA_BWD_CASES):
    """22a: flash_attention_bwd against attention_bwd_ref on the same
    inputs, fp32 and bf16: q, k, v and dO random, o and lse from the
    forward kernel (its lse also against the plain log-sum-exp); a second
    call on the same inputs gives the same bits. Returns (the largest fp32
    absolute error of a gradient, {"tinyllama", "jamba": the fp32 inputs
    of that layer for timing}); the log gives each error over its
    gradient's largest magnitude."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    g = torch.Generator(device=dev).manual_seed(22)
    worst, worst_abs, timing = {}, 0.0, {}
    for (case, B, S, T, H, KV, hd, causal, window) in cases:
        inputs32 = [torch.randn(shape, generator=g, device=dev) for shape in
                    ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                     (B, S, H, hd))]
        errs = {}
        for dtype, tol in FA_BWD_TOL.items():
            qh, kh, vh, doh = (t.to(dtype).transpose(1, 2) for t in inputs32)
            with uncounted():
                o, lse = FK.flash_attention(qh, kh, vh, causal=causal,
                                            window=window, with_lse=True)
                got = FK.flash_attention_bwd(qh, kh, vh, o, lse, doh,
                                             causal=causal, window=window)
                again = FK.flash_attention_bwd(qh, kh, vh, o, lse, doh,
                                               causal=causal, window=window)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), \
                f"flash bwd {case} {dtype}: two calls differ"
            want_lse = attention_lse_ref(qh, kh, causal=causal, window=window)
            want = attention_bwd_ref(qh.float(), kh.float(), vh.float(),
                                     o.float(), lse, doh.float(),
                                     causal=causal, window=window)
            sync(dev)
            err, scale = _rel_err(lse, want_lse)
            assert err <= LSE_TOL * max(1.0, scale), (case, dtype, "lse", err)
            name = str(dtype).replace("torch.", "")
            errs[name] = {"lse": err}
            for gname, gt, wt in zip(("dq", "dk", "dv"), got, want):
                assert gt.dtype == dtype and gt.shape == wt.shape, (case, gname)
                assert bool(torch.isfinite(gt).all()), (case, gname)
                err, scale = _rel_err(gt, wt)
                assert err <= tol * scale, \
                    f"flash bwd {case} {name} {gname}: {err} > {tol} x {scale}"
                errs[name][gname] = err / scale
                worst[name] = max(worst.get(name, 0.0), err / scale)
                if dtype == torch.float32:
                    worst_abs = max(worst_abs, err)
        if case == "tinyllama layer":
            timing["tinyllama"] = inputs32
        if case == "jamba layer, hd 128":
            timing["jamba"] = inputs32
        log(f"phase 22a flash_attention_bwd {case}: B={B} S={S} T={T} H={H} "
            f"KV={KV} hd={hd} causal={causal} window={window}; error / scale "
            + json.dumps(errs))
    log(f"phase 22a flash_attention_bwd kernel ~ plain on {len(cases)} cases:"
        f" max error / scale {json.dumps(worst)} (tol {FA_BWD_TOL[torch.float32]}"
        f" fp32, {FA_BWD_TOL[torch.bfloat16]} bf16); two calls equal bit for "
        "bit on every case")
    return worst_abs, timing


def phase_ssm_bwd(dev, cases=SSM_BWD_CASES):
    """22b: the forward kernel's chunk states against the plain scan's, then
    ssm_scan_bwd against ssm_scan_bwd_ref on the same inputs (those chunk
    states, a random dy and dhT) from a random h0; a case with dt_rank > 0
    takes B and C as x_proj's strided splits; a second call on the same
    inputs gives the same bits. Returns (the largest fp32 absolute error of
    a gradient, the fp32 inputs of Jamba's layer for timing); the log gives
    each error over its gradient's largest magnitude."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
    from repro_torch.models.layers import softplus
    g = torch.Generator(device=dev).manual_seed(23)
    worst, worst_abs, timing = {}, 0.0, None
    for (case, B, S, I, N, dtype, dt_rank) in cases:
        rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
        dt, a = softplus(rnd(B, S, I)), -torch.exp(rnd(I, N))
        if dt_rank:
            _, bm, cm = torch.split(rnd(B, S, dt_rank + 2 * N),
                                    [dt_rank, N, N], dim=-1)
        else:
            bm, cm = rnd(B, S, N), rnd(B, S, N)
        x, h0, dhT = rnd(B, S, I), rnd(B, I, N), rnd(B, I, N)
        dt, bm, cm, x = (t.to(dtype) for t in (dt, bm, cm, x))
        dy = rnd(B, S, I).to(dtype)
        with uncounted():
            _, _, hc = SK.ssm_scan(dt, a, bm, cm, x, h0, with_chunks=True)
            got = SK.ssm_scan_bwd(dt, a, bm, cm, x, hc, dy, dhT)
            again = SK.ssm_scan_bwd(dt, a, bm, cm, x, hc, dy, dhT)
        assert all(torch.equal(x_, y_) for x_, y_ in zip(got, again)), \
            f"ssm_scan bwd {case}: two calls differ"
        want_hc = ssm_scan_ref(dt, a, bm, cm, x, h0, chunk_states=True)[2]
        want = ssm_scan_bwd_ref(dt, a, bm, cm, x, hc, dy, dhT)
        sync(dev)
        name = str(dtype).replace("torch.", "")
        err, scale = _rel_err(hc, want_hc)
        assert err <= SSM_TOL[dtype] * max(1.0, scale), (case, "hc", err)
        errs = {"hc": err / max(1.0, scale)}
        tol = SSM_BWD_TOL[dtype]
        for gname, gt, wt in zip(("ddt", "da", "dbm", "dcm", "dx", "dh0"), got,
                                 want):
            assert gt.dtype == wt.dtype and gt.shape == wt.shape, (case, gname)
            assert bool(torch.isfinite(gt).all()), (case, gname)
            err, scale = _rel_err(gt, wt)
            assert err <= tol * scale, \
                f"ssm_scan bwd {case} {gname}: {err} > {tol} x {scale}"
            errs[gname] = err / scale
            worst[name] = max(worst.get(name, 0.0), err / scale)
            if dtype == torch.float32:
                worst_abs = max(worst_abs, err)
        if case == "jamba layer":
            timing = (dt, a, bm, cm, x, hc, dy, dhT)
        log(f"phase 22b ssm_scan_bwd {case}: B={B} S={S} I={I} N={N} {name}; "
            f"error / scale " + json.dumps(errs))
    log(f"phase 22b ssm_scan_bwd kernel ~ plain on {len(cases)} cases: max "
        f"error / scale {json.dumps(worst)} (tol {SSM_BWD_TOL[torch.float32]}"
        f" fp32, {SSM_BWD_TOL[torch.bfloat16]} bf16); two calls equal bit "
        "for bit on every case")
    return worst_abs, timing


def _lm_batch(cfg, B, S, dev, seed):
    """tokens, labels (one in ten -100) and the frontend's input, drawn on
    the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    labels[torch.rand((B, S), generator=g, device=dev) < 0.1] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.frontend_dim), generator=g,
            device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                                      generator=g, device=dev)
    return batch


def _mixers(cfg):
    """(attention layers, Mamba layers) of a decoder-only config; whisper's
    attention calls (encoder, decoder self and cross)."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers, 0
    from repro_torch.models.lm import n_periods, period_spec
    spec = [m for m, _ in period_spec(cfg)]
    return (n_periods(cfg) * spec.count("attn"),
            n_periods(cfg) * spec.count("mamba"))


def _same_grads(got, want, ctx):
    """The loss and every gradient leaf of two `value_and_grad` results
    within STEP_LOSS_RTOL and STEP_GRAD_TOL; returns the worst leaf's
    error / scale."""
    from repro_torch.common.pytree import tree_paths
    loss, lw = got[0].item(), want[0].item()
    assert abs(loss - lw) <= STEP_LOSS_RTOL * abs(lw), (ctx, loss, lw)
    worst = 0.0
    wflat = tree_paths(want[2])
    for key, gt in tree_paths(got[2]).items():
        err, scale = _rel_err(gt, wflat[key])
        assert bool(torch.isfinite(gt).all()), (ctx, key)
        if scale == 0.0:
            assert err == 0.0, (ctx, key, err)
            continue
        assert err <= STEP_GRAD_TOL * scale, (ctx, key, err, scale)
        worst = max(worst, err / scale)
    return worst


def phase_train_parity(dev, card, S=2048):
    """22c: one loss-and-grad on the kernels against the same on the plain
    versions (`impl="ref"`, plain autograd), at full width with the depth
    cut: tinyllama-1.1b to 2 layers, and JAMBA_CUT to one Mamba and one
    attention layer; batch 1, S tokens. The plain attention's (B, H, S, S)
    scores rule out the full depth."""
    from repro_torch.common.config import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.training.optimizer import value_and_grad
    register_jamba_cut()
    for arch, cut in ((TRAIN_ARCH, dict(num_layers=2)),
                      (JAMBA_CUT, dict(num_layers=2, attn_period=2))):
        cfg = dataclasses.replace(get_config(arch), **cut)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(22),
                            device=dev)
        batch = _lm_batch(cfg, 1, S, dev, seed=22)
        reset_counts()
        got = value_and_grad(lambda p: model.loss(p, batch), params)
        sync(dev)
        counts = read_counts()
        want = value_and_grad(lambda p: model.loss(p, batch, impl="ref"),
                              params)
        worst = _same_grads(got, want, f"22c {arch}")
        n_attn, n_mamba = _mixers(cfg)
        assert counts["flash_attention"] == counts["flash_attention_bwd"] \
            == n_attn, counts
        assert counts["ssm_scan"] == counts["ssm_scan_bwd"] == n_mamba, counts
        log(f"phase 22c train step parity {arch} cut {json.dumps(cut)} B=1 "
            f"S={S} [{card}]: loss kernels {got[0].item()} plain "
            f"{want[0].item()}; worst leaf error / scale {worst} (tol "
            f"{STEP_GRAD_TOL}); launches "
            + json.dumps({k: v for k, v in counts.items() if v}))
        del params, got, want
        gc.collect()
        torch.cuda.empty_cache()


def _train_run(dev, card, phase, cfg, batch, seq, steps):
    """`launch.train`'s `train_lm` on `cfg` (fp32, `steps` steps of `batch`
    x `seq` Markov tokens) with the counts reset just before and read just
    after, peak device memory and the synchronised ms a step. Returns
    (params, counts, row)."""
    from repro_torch.launch import train as LT
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tcfg = LT.TrainConfig(total_steps=steps, warmup=max(5, steps // 10),
                          log_every=1)
    dcfg = LT.DataConfig(vocab_size=min(cfg.vocab_size, 2048), seq_len=seq,
                         batch_size=batch, seed=0)
    reset_counts()
    t0 = time.perf_counter()
    params, history = LT.train_lm(cfg, tcfg, dcfg, seed=0, verbose=False,
                                  device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    for h in history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]), h
    later = [h["step_ms"] for h in history[1:]] or [history[0]["step_ms"]]
    row = {"card": card, "arch": cfg.name, "params": cfg.param_count(),
           "layers": cfg.num_layers, "d_model": cfg.d_model, "batch": batch,
           "seq": seq, "steps": steps, "remat": False, "dtype": "float32",
           "ms_per_step": float(np.median(later)),
           "step_ms": [h["step_ms"] for h in history],
           "loss": [h["loss"] for h in history],
           "grad_norm": [h["grad_norm"] for h in history],
           "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "run_s": secs,
           "launches_per_step": {k: v / steps for k, v in counts.items()
                                 if v}}
    log(f"phase {phase} train_lm {cfg.name} [{card}]: " + json.dumps(row))
    return params, counts, row


# ms a train step with the first backward kernels (fp32 FMAs), before
# their redesign, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
# 5): printed beside this run's
EARLIER_STEP_MS = {"22d": 1528.0, "22e": 811.0}
TRAIN_KERNELS = ("flash_attention_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkdv_kernel", "ssm_scan_kernel",
                 "ssm_scan_bwd_kernel")


def _profiled_step(dev, card, phase, cfg, params, batch, seq):
    """One train step (after a warm one) under a fresh torch.profiler
    session, synchronised before it closes: wall, device busy time, idle
    share, the ten largest device items by name, and the kernels' device
    events against the launches the wrappers counted in the same window
    (`profiled_launches`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.zoo import build_model
    from repro_torch.training import train_loop as TL
    from repro_torch.training.data import DataConfig, MarkovTokens
    from repro_torch.training.optimizer import adam_init
    tcfg = TL.TrainConfig(total_steps=10, warmup=1)
    step = TL.make_train_step(build_model(cfg), tcfg)
    data = TL.batch_to_device(MarkovTokens(DataConfig(
        vocab_size=min(cfg.vocab_size, 2048), seq_len=seq, batch_size=batch,
        seed=1)).sample_batch(), dev)
    state = adam_init(params)
    step(params, state, data)
    sync(dev)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, data)
        sync(dev)
        wall = time.perf_counter() - t0
    counts = read_counts()
    dev_events = [e for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CPU]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    seen = {k: sum(1 for e in dev_events if k in e.name)
            for k in TRAIN_KERNELS}
    by_name = {}                  # kernel names cut to 60 characters
    for e in dev_events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            e.time_range.elapsed_us()
    want = {"flash_attention_kernel": counts["flash_attention"],
            "flash_bwd_dq_kernel": counts["flash_attention_bwd"],
            "flash_bwd_dkdv_kernel": counts["flash_attention_bwd"],
            "ssm_scan_kernel": counts["ssm_scan"],
            "ssm_scan_bwd_kernel": counts["ssm_scan_bwd"]}
    row = {"card": card, "arch": cfg.name, "wall_ms": 1e3 * wall,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / 1e6 / wall,
           "device_events": len(dev_events), "profiled_launches": seen,
           "counted_launches": want,
           "top_device_ms": {n: us / 1e3 for n, us in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:10]}}
    log(f"phase {phase} profiled train step {cfg.name} [{card}]: "
        + json.dumps(row))
    assert seen == want, (seen, want)
    del state
    return row


def phase_train_tinyllama(dev, card, batch=4, seq=2048, steps=4):
    """22d, the slice's full-width path: `train_lm` on tinyllama-1.1b (1.1 B
    parameters, fp32) at batch x seq for `steps` steps: 22 flash forward
    and 22 backward launches a step, then one profiled step."""
    from repro_torch.common.config import get_config
    cfg = get_config(TRAIN_ARCH)
    params, counts, row = _train_run(dev, card, "22d", cfg, batch, seq, steps)
    n_attn, _ = _mixers(cfg)
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == n_attn * steps, counts
    log(f"phase 22d ms a step [{card}]: {row['ms_per_step']} (before the "
        f"backward kernels' redesign: {EARLIER_STEP_MS['22d']})")
    row["profile"] = _profiled_step(dev, card, "22d", cfg, params, batch, seq)
    del params
    return counts, row


def phase_train_jamba(dev, card, batch=1, seq=2048, steps=2):
    """22e: `train_lm` on JAMBA_CUT at full width (2.7 B parameters, fp32;
    its Adam state alone is ~22 GB) at batch x seq: 7 ssm_scan forward and
    7 backward launches a step, 1 flash forward and 1 backward."""
    from repro_torch.common.config import get_config
    register_jamba_cut()
    cfg = get_config(JAMBA_CUT)
    params, counts, row = _train_run(dev, card, "22e", cfg, batch, seq, steps)
    n_attn, n_mamba = _mixers(cfg)
    assert counts["ssm_scan"] == counts["ssm_scan_bwd"] == n_mamba * steps, \
        counts
    assert counts["flash_attention"] == counts["flash_attention_bwd"] \
        == n_attn * steps, counts
    log(f"phase 22e ms a step [{card}]: {row['ms_per_step']} (before the "
        f"backward kernels' redesign: {EARLIER_STEP_MS['22e']})")
    del params
    return counts, row


def phase_train_zoo(dev, card, B=2, S=96, steps=2):
    """22f: the ten ASSIGNED_ARCHS reduced, `steps` train steps each on the
    card through `Model.loss` (`make_train_step`), each step's loss and
    grad norm against the same step on the plain versions (`impl="ref"`)
    from a copy of the same params: MoE (capacity dispatch and aux),
    xLSTM, the encoder-decoder and the vision frontend on the card."""
    from repro_torch.common.config import ASSIGNED_ARCHS, get_config
    from repro_torch.common.pytree import tree_map
    from repro_torch.models.zoo import build_model
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import adam_init
    tcfg = TL.TrainConfig(lr=1e-3, warmup=1, total_steps=steps)
    total = {}
    for i, arch in enumerate(ASSIGNED_ARCHS):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        plain = dataclasses.replace(model, loss=functools.partial(
            model.loss, impl="ref"))
        params = model.init(torch.Generator(device=dev).manual_seed(i),
                            device=dev)
        copy = tree_map(torch.clone, params)
        runs = []
        for m, p in ((model, params), (plain, copy)):
            step, state, out = TL.make_train_step(m, tcfg), adam_init(p), []
            reset_counts()
            for k in range(steps):
                batch = _lm_batch(cfg, B, S, dev, seed=100 * i + k)
                p, state, loss, gnorm = step(p, state, batch)
                out.append((loss.item(), gnorm.item()))
            runs.append((out, read_counts()))
        (got, counts), (want, _) = runs
        for k, ((lg, ng), (lw, nw)) in enumerate(zip(got, want)):
            assert np.isfinite(lg) and abs(lg - lw) <= STEP_LOSS_RTOL * abs(lw), \
                (arch, k, lg, lw)
            assert abs(ng - nw) <= STEP_GRAD_TOL * abs(nw), (arch, k, ng, nw)
        n_attn, n_mamba = _mixers(cfg)
        assert counts["flash_attention"] == counts["flash_attention_bwd"] \
            == n_attn * steps, (arch, counts)
        assert counts["ssm_scan"] == counts["ssm_scan_bwd"] \
            == n_mamba * steps, (arch, counts)
        add_counts(total, counts)
        log(f"phase 22f train {cfg.name} B={B} S={S} [{card}]: loss, grad "
            f"norm kernels {json.dumps(got)} plain {json.dumps(want)}; "
            "launches " + json.dumps({k: v for k, v in counts.items() if v}))
        del params, copy
    return total


def phase_no_backward_guard(dev, env_timing, chain_timing, step_timing):
    """22g: env_step, denoiser_chain and denoiser_step have no backward, so
    each raises when given a CUDA input that requires grad (instead of
    returning an output without `grad_fn`)."""
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.env_step import kernel as EK
    cfg, statics, st, a, q = env_timing
    grad = lambda t: t.clone().requires_grad_()  # noqa: E731
    chain = list(chain_timing)
    chain[7] = grad(chain[7])
    stepi = list(step_timing)
    stepi[3] = grad(stepi[3])
    calls = {"env_step": lambda: EK.env_step(
                 cfg, statics, st._replace(time=grad(st.time)), a, q),
             "denoiser_chain": lambda: DK.denoiser_chain(*chain),
             "denoiser_step": lambda: DK.denoiser_step(*stepi)}
    with uncounted():
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as e:
                assert f"{name} kernel has no backward" in str(e), e
            else:
                raise AssertionError(f"{name} returned under grad")
    log("phase 22g env_step, denoiser_chain, denoiser_step raise on CUDA "
        "inputs that require grad")


def phase_training(dev, card, env_timing, chain_timing, step_timing):
    """Phase 22, training through the zoo: 22a-22g. Returns (errors of the
    backward kernels, their timing inputs, launches of the main paths
    22d-22f)."""
    t0 = time.perf_counter()
    errs, launches = {}, {}
    errs["flash_attention_bwd"], flash_in = phase_flash_bwd(dev)
    errs["ssm_scan_bwd"], ssm_in = phase_ssm_bwd(dev)
    phase_train_parity(dev, card)
    counts, _ = phase_train_tinyllama(dev, card)
    add_counts(launches, counts)
    counts, _ = phase_train_jamba(dev, card)
    add_counts(launches, counts)
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, phase_train_zoo(dev, card))
    phase_no_backward_guard(dev, env_timing, chain_timing, step_timing)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 22 took {time.perf_counter() - t0:.3f} s")
    return errs, (flash_in, ssm_in), launches


# ------------------------------------ phase 23 (item 15: devices, launch)
SHARDS = 4                 # 23a's mesh: this many shards on the one card
SERVE_CLI_ARCHS = ("qwen2-1.5b", "tinyllama-1.1b")


def _cat_rollouts(parts):
    """Rollout results of the batch's slices, concatenated on axis 0."""
    from repro_torch.core import env as EV
    from repro_torch.core import rollout as RO
    cat = lambda xs: torch.cat(list(xs))  # noqa: E731
    tr = None
    if parts[0].transitions is not None:
        ts = [p.transitions for p in parts]
        tr = RO.Transitions(
            *(cat(getattr(t, f) for t in ts)
              for f in RO.Transitions._fields[:-1]),
            extras={k: cat(t.extras[k] for t in ts) for k in ts[0].extras})
    return RO.RolloutResult(
        metrics={k: cat(p.metrics[k] for p in parts)
                 for k in parts[0].metrics},
        final_state=EV.EnvState(*(cat(x) for x in zip(
            *(p.final_state for p in parts)))),
        transitions=tr)


def phase_sharded(dev, card, actor, B=256, pairs=5):
    """23a: `ExecSpec(backend="sharded")` on paper-8srv at B = B, fifo and
    ddpm (`actor`), a whole episode collected. One shard (the card's one
    device) equals `fused` in every tensor; a mesh of SHARDS shards on
    this card equals the SHARDS `fused` runs of B / SHARDS envs with the
    children of `split_generator`, and for fifo `fused` on all B. Each
    sharded run is counted (counts set to 0 just before, read just after):
    one env_step launch a decision a shard, one chain a ddpm decision a
    shard. Then `pairs` rounds of fused, 1 shard and SHARDS shards in
    rotating order (host clock, synchronised, no collection): medians of
    ms per decision. Returns launches."""
    from repro_torch import api
    from repro_torch.actors.policies import actor_policy
    from repro_torch.api.simulator import split_generator
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    from repro_torch.launch.mesh import make_data_mesh
    ecfg, traces = cell_setup(dev, "paper-8srv", 8, 0.1, B)
    T, b = ecfg.max_steps, B // SHARDS
    ways = {"fused": api.rollout_fn_for(api.ExecSpec()),
            "sharded_1": api.rollout_fn_for(api.ExecSpec(backend="sharded")),
            f"sharded_{SHARDS}": api.rollout_fn_for(
                api.ExecSpec(backend="sharded"),
                mesh=make_data_mesh((dev,) * SHARDS))}
    launches = {}
    for sampler in ("fifo", "ddpm"):
        if sampler == "fifo":
            pol, params = RO.fifo_policy(ecfg), {}
        else:
            pol = actor_policy(ecfg, AG.AgentConfig(), sampler="ddpm",
                               device=dev)
            params = actor

        def run(way, collect=True, generator=None, tr=traces):
            return ways[way](ecfg, tr, pol, params, num_steps=T,
                             collect=collect, device=dev,
                             generator=generator or torch.Generator(
                                 device=dev).manual_seed(23))
        fused = run("fused")
        counts = {}
        for way, n in (("sharded_1", 1), (f"sharded_{SHARDS}", SHARDS)):
            got, c, secs = _run_counted(dev, lambda: run(way))
            assert c["env_step"] == n * T, (way, c)
            assert c["denoiser_chain"] == (n * T if sampler == "ddpm"
                                           else 0), (way, c)
            add_counts(counts, c)
            if n == 1 or sampler == "fifo":
                assert _rollouts_equal(got, fused), f"23a {sampler} {way}"
            if n > 1:
                kids = split_generator(torch.Generator(
                    device=dev).manual_seed(23), n)
                parts = [run("fused", generator=kids[s], tr={
                    k: v[s * b:(s + 1) * b] for k, v in traces.items()})
                    for s in range(n)]
                assert _rollouts_equal(got, _cat_rollouts(parts)), \
                    f"23a {sampler} {way}: not the per-shard fused runs"
        add_counts(launches, counts)
        for way in ways:                         # each loop built, captured
            run(way, collect=False)
        times = {way: [] for way in ways}
        order = list(ways)
        for i in range(pairs):
            for way in order[i % 3:] + order[:i % 3]:
                sync(dev)
                t0 = time.perf_counter()
                run(way, collect=False)
                sync(dev)
                times[way].append(1e3 * (time.perf_counter() - t0) / T)
        m = fused.metrics
        log("phase 23a sharded rollout " + json.dumps({
            "card": card, "cell": "paper-8srv", "sampler": sampler, "B": B,
            "decisions": T, "shards": [1, SHARDS],
            "sharded_1_equals_fused": True,
            f"sharded_{SHARDS}_equals_per_shard_fused": True,
            "launches": {k: v for k, v in counts.items() if v},
            "ms_per_decision": times,
            "median_ms_per_decision": {k: float(np.median(v))
                                       for k, v in times.items()},
            "metrics": {k: float(v.float().mean()) for k, v in m.items()}}))
    return launches


def phase_build_case(dev, card, B=4, S=2048):
    """23b: `launch.steps.build_case` for tinyllama-1.1b at full width on a
    1-device mesh, the reference's defaults (bf16 compute, remat, fp32
    params, Adam in place): a train step at B x S with microbatches 1 and
    2 from the same params and batch (loss within 2e-3 relative, every
    param within 5e-3: the reference test's bounds), each counted (22 + 22
    forward launches with remat, 22 backward, per microbatch); ms a step
    (median of the two steps after the first), peak memory and one
    profiled step's idle share;
    then prefill at 1 x S into a cache with room for more, and one decode
    step from it (finite logits, 22 flash launches a prefill). Returns
    launches."""
    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch import mesh as MX
    from repro_torch.launch import shapes as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models.zoo import build_model
    from repro_torch.training.optimizer import adam_init
    cfg = get_config(TRAIN_ARCH)
    n_attn, _ = _mixers(cfg)
    mesh = MX.make_debug_mesh(1, 1, device=dev)
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params0 = model.init(torch.Generator(device=dev).manual_seed(23),
                         device=dev)
    batch = _lm_batch(cfg, B, S, dev, seed=23)
    shape = SH.ShapeSpec("train_2k", "train", S, B)
    launches, out, row = {}, {}, {"card": card, "arch": cfg.name,
                                  "params": cfg.param_count(), "batch": B,
                                  "seq": S, "compute_dtype": "bfloat16",
                                  "remat": True}
    for mb in (1, 2):
        case = ST.build_case(cfg, shape, mesh, microbatches=mb)
        structs = tree_leaves(case.arg_structs[0])
        assert [tuple(x.shape) for x in structs] == \
            [tuple(x.shape) for x in tree_leaves(params0)]
        params = tree_map(torch.clone, params0)
        opt = adam_init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        (_, opt, loss, _), counts, secs = _run_counted(
            dev, lambda: case.fn(params, opt, batch))
        assert counts["flash_attention"] == 2 * n_attn * mb, counts
        assert counts["flash_attention_bwd"] == n_attn * mb, counts
        add_counts(launches, counts)
        assert np.isfinite(loss.item()), loss
        row[f"mb{mb}"] = {"loss": loss.item(), "first_step_s": secs,
                          "peak_device_gib":
                              torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                          "launches": {k: v for k, v in counts.items() if v}}
        out[mb] = (loss.item(), tree_map(torch.clone, params)
                   if mb == 1 else params)
        if mb == 1:                  # time and profile on from that step
            step_ms = []
            for _ in range(2):
                sync(dev)
                t0 = time.perf_counter()
                case.fn(params, opt, batch)
                sync(dev)
                step_ms.append(1e3 * (time.perf_counter() - t0))
            row["ms_per_step"] = float(np.median(step_ms))
            row["step_ms"] = step_ms
            with uncounted():
                row["profile"] = profile_device(
                    dev, lambda: case.fn(params, opt, batch), 1, "step")
        del opt, params
    (l1, p1), (l2, p2) = out[1], out[2]
    assert abs(l1 - l2) <= 2e-3 * abs(l1), (l1, l2)
    worst = max(float((a - b_).abs().max())
                for a, b_ in zip(tree_leaves(p1), tree_leaves(p2)))
    assert worst < 5e-3, worst
    row["mb2_vs_mb1"] = {"loss_rel": abs(l1 - l2) / abs(l1),
                         "worst_param_abs": worst}
    del out, p1, p2
    gc.collect()
    torch.cuda.empty_cache()
    pre = ST.build_case(cfg, SH.ShapeSpec("prefill_2k", "prefill", S, 1),
                        mesh)
    dec = ST.build_case(cfg, SH.ShapeSpec("decode_2k", "decode", S, 1), mesh)
    cache = model.make_cache(1, S + 64, torch.bfloat16, device=dev)
    (logits, cache), counts, pre_s = _run_counted(
        dev, lambda: pre.fn(params0, {"tokens": batch["tokens"][:1]}, cache))
    assert counts["flash_attention"] == n_attn, counts
    add_counts(launches, counts)
    nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    sync(dev)
    t0 = time.perf_counter()
    logits2, cache = dec.fn(params0, cache, nxt)
    sync(dev)
    dec_s = time.perf_counter() - t0
    for lg in (logits, logits2):
        assert lg.shape == (1, 1, cfg.padded_vocab), lg.shape
        assert bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
    assert cache["pos"] == S + 1, cache["pos"]
    row.update(prefill_ms=1e3 * pre_s, decode_ms=1e3 * dec_s,
               launches_total={k: v for k, v in launches.items() if v})
    log("phase 23b build_case " + json.dumps(row))
    del params0, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


def phase_serve_cli(dev, card, servers=4, tasks=12, archs=SERVE_CLI_ARCHS,
                    reduced=False):
    """23c: `launch.serve.run` (the serving CLI's loop) at full width on
    `servers` servers, `tasks` tasks over `archs`, fifo and eat, each
    counted: every task completes, one flash_attention launch per
    attention layer of every served prefill. Then the fifo run again with
    every generate on the plain attention (`impl="ref"`, phase 21's
    patch of `ModelExecutor.generate`, uncounted): the same done records
    and tokens. The eat decision is `sac.policy_act`, the reference's:
    the plain reverse chain, no chain kernel. Returns launches."""
    from repro_torch.common.config import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.serving.executor import ModelExecutor
    launches, done = {}, {}

    def served(policy):
        eng = SV.run(policy, servers=servers, tasks=tasks, archs=archs,
                     reduced=reduced, device=dev, verbose=False)
        return eng.done, eng.qos_summary()
    for policy in ("fifo", "eat"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        (recs, qos), counts, secs = _run_counted(dev, lambda: served(policy))
        assert len(recs) == tasks, (policy, len(recs))
        for r in recs:
            assert r.tokens is not None and len(r.tokens) == r.steps
        cfgs = {a: get_config(a) for a in archs}
        if reduced:
            cfgs = {a: c.reduced() for a, c in cfgs.items()}
        want = sum(prefill_launches(cfgs[r.arch])["flash_attention"]
                   for r in recs)
        assert counts["flash_attention"] == want, (counts, want)
        add_counts(launches, counts)
        done[policy] = recs
        log("phase 23c serve CLI " + json.dumps({
            "card": card, "policy": policy, "archs": list(archs),
            "reduced": reduced, "servers": servers, "tasks": tasks,
            "wall_s": secs, "launches": {k: v for k, v in counts.items()
                                         if v},
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None,
            "qos_summary": qos}))
    plain = ModelExecutor.generate

    def plain_generate(ex, *args, **kw):
        kw["impl"] = "ref"
        return plain(ex, *args, **kw)
    ModelExecutor.generate = plain_generate
    try:
        with uncounted():
            ref, _ = served("fifo")
    finally:
        ModelExecutor.generate = plain
    fields = ("rid", "arch", "patches", "steps", "reused", "start_t",
              "finish_t", "quality", "arrive_t")
    for a, b in zip(done["fifo"], ref):
        assert all(getattr(a, f) == getattr(b, f) for f in fields), (a, b)
        assert np.array_equal(a.tokens, b.tokens), (a.rid, a.tokens, b.tokens)
    assert len(ref) == len(done["fifo"])
    log(f"phase 23c fifo on the kernels equals the plain attention: {tasks} "
        "done records and their tokens")
    return launches


def phase_launch(dev, card, actor):
    """Phase 23, the multi-device and launch layer (ROADMAP item 15):
    23a-23c. Returns the launches of their main paths and 23b's row."""
    t0 = time.perf_counter()
    launches = {}
    add_counts(launches, phase_sharded(dev, card, actor))
    counts, row = phase_build_case(dev, card)
    add_counts(launches, counts)
    add_counts(launches, phase_serve_cli(dev, card))
    log(f"phase 23 took {time.perf_counter() - t0:.3f} s")
    return launches, row


# (arch, shape, mesh, devices, {scaled loop's site: trip count}, whether
# its peak must fit the card's 80 GiB)
# (arch, shape, mesh, devices, loops_scaled's trip counts, peak must fit
# the card, what the record must read beside: the traced bottleneck and a
# cap on its collective bytes)
DRYRUN_CASES = (
    ("xlstm-125m", "decode_32k", "multi", 512, {}, False, {}),
    ("tinyllama-1.1b", "train_4k", "single", 256,
     {"models/attention.py:_fwd": 8, "models/attention.py:_fwd_q_block": 4,
      "models/attention.py:_bwd": 4, "models/attention.py:_bwd_kv_block": 8},
     True, {}),
    ("xlstm-125m", "train_4k", "single", 256,
     {"models/blocks.py:_mlstm_scan": 4096,
      "models/blocks.py:_slstm_apply": 4096}, False, {}),
    ("jamba-v0.1-52b", "prefill_32k", "single", 256,
     {"kernels/ssm_scan/ref.py:ssm_scan_ref": 32768,
      "models/attention.py:_fwd": 64, "models/attention.py:_fwd_q_block": 32},
     True, {}),
    # decode on the cache's T shards: the cache write and the attention
    # gather no cache (6.96e10 bytes a device when they did, ~9e8 after);
    # the weights, the experts and the embedding table stay on their
    # shards (weight-stationary products, the masked lookup: the expert
    # gathers alone were ~8e8 under torch 2.11)
    ("olmoe-1b-7b", "decode_32k", "single", 256, {}, True,
     {"bottleneck": "memory", "collective_bytes": 6e8}),
    # the masked lookup: gathering the table alone moved 8.19e6
    ("tinyllama-1.1b", "long_500k", "single", 256, {}, True,
     {"bottleneck": "memory", "collective_bytes": 4e6}))
CARD_BYTES = 80 * 2 ** 30


def phase_dryrun(dev, card, row23b, cases=DRYRUN_CASES, timeout=600):
    """Phase 24, the dry-run and the roofline on the card's host.
    (a) `python -m repro_torch.launch.dryrun` in a subprocess per case
    (run side by side, on the host: meta tensors over a fake process group
    of 256 or 512 ranks, no kernel, no device memory): each must print
    "1 ok, 0 skipped, 0 errors / 1 cases" and write an ok record with the
    mesh's devices, per-device FLOPs, the analytic terms and, for xLSTM's
    train step and Jamba's prefill, each recurrence scaled from two
    counted steps to its trip count (`loops_scaled`, `sharding.loops`):
    the mLSTM and sLSTM loops forward and backward, the Mamba scan's plain
    version over 32k tokens, and the plain blocked attention's query and
    KV block loops (tinyllama-1.1b's train step and Jamba's prefill). Each
    row has `peak_device_bytes`; those two cases' and olmoe-1b-7b decode's
    must fit the card's 80 GiB. olmoe's decode step runs on the KV cache's
    T shards (`sharding.context.write_slot`, `on_seq_shards`) and keeps its
    weights and experts on their shards (`launch.reshard.matmul_partition`'s
    weight-stationary products): its traced bottleneck must be memory and
    its collectives under 6e8 bytes a device. tinyllama-1.1b's long_500k
    step looks its token up on each device's rows of the table
    (`sharding.context.lookup_rows`): memory, and under 4e6 bytes, below
    the table gather's 8.19e6 alone. That proves this torch has the fake
    group, the counting modes, the scaled loops, the split softmax's
    all-reduces, the byte-costed partition and the masked lookup. (b) The
    analytic roofline (`launch.roofline.analytic_terms` at n_dev = 1, dp =
    1, the H100 constants) of phase 23b's three tinyllama-1.1b shapes
    beside the times 23b measured: a train step at 4 x 2048, a prefill at
    1 x 2048, one decode step at 2048. The bound is the larger of the compute and
    memory terms (one device moves no collective); a measured time below
    its bound fails the phase: the constants or the count would be
    wrong."""
    import os
    from repro_torch.common.config import get_config
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.roofline import analytic_terms
    t0 = time.perf_counter()
    out = ROOT / "build" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [(case, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         case[0], "--shape", case[1], "--mesh", case[2], "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for case in cases]
    rows = []
    for (arch, shape, mesh, n_dev, loops, fits, want), proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            proc.kill()
        path = out / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        assert proc.returncode == 0 and \
            "1 ok, 0 skipped, 0 errors / 1 cases" in stdout, \
            (arch, shape, stdout[-2000:], stderr[-2000:],
             rec.get("traceback"))
        assert rec["status"] == "ok" and rec["devices"] == n_dev, rec
        assert rec["hlo_flops"] > 0 and "a_compute_s" in rec, rec
        assert {site: v["trip_count"] for site, v in
                rec["loops_scaled"].items()} == loops, rec["loops_scaled"]
        assert not fits or rec["peak_device_bytes"] <= CARD_BYTES, \
            (arch, shape, rec["peak_device_bytes"])
        assert rec["bottleneck"] == want.get("bottleneck",
                                             rec["bottleneck"]) and \
            rec["collective_bytes"] <= want.get("collective_bytes",
                                                float("inf")), \
            (arch, shape, rec["bottleneck"], rec["collective_bytes"], want)
        rows.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "devices", "trace_s", "hlo_flops",
            "hlo_bytes", "collective_bytes", "bottleneck",
            "useful_flop_ratio", "a_bottleneck", "peak_device_bytes",
            "reshards", "loops_scaled")})
    log("phase 24a dryrun " + json.dumps(rows))
    cfg = get_config(TRAIN_ARCH)
    S, B = row23b["seq"], row23b["batch"]
    bounds = []
    for name, shape, key in (
            ("train", SH.ShapeSpec("train_2k", "train", S, B), "ms_per_step"),
            ("prefill", SH.ShapeSpec("prefill_2k", "prefill", S, 1),
             "prefill_ms"),
            ("decode", SH.ShapeSpec("decode_2k", "decode", S, 1),
             "decode_ms")):
        terms = analytic_terms(cfg, shape, 1, 1)
        bound_ms = 1e3 * max(terms["a_compute_s"], terms["a_memory_s"])
        measured = row23b[key]
        bounds.append({"card": card, "step": name, "batch": shape.global_batch,
                       "seq": S, "measured_ms": measured,
                       "bound_ms": bound_ms,
                       "compute_ms": 1e3 * terms["a_compute_s"],
                       "memory_ms": 1e3 * terms["a_memory_s"],
                       "measured_over_bound": measured / bound_ms})
        assert measured >= bound_ms, (name, measured, bound_ms)
    log("phase 24b roofline " + json.dumps(bounds))
    log(f"phase 24 took {time.perf_counter() - t0:.3f} s")


def flash_plain(q, k, v, *, causal=True, window=0):
    """The flash kernel's plain version (`kernels/flash_attention/ref.py::
    attention_ref`, the naive oracle the kernel is held and timed against)
    in the (B, S, H, hd) layout of `ops.attention`."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def _sdpa_call(q, k, v):
    """One PyTorch call computing flash_attention's function on the same
    (B, S, H, hd) tensors: `scaled_dot_product_attention` on head-major
    views, causal, GQA by `enable_gqa`; a torch without `enable_gqa` gets
    K/V repeated to H heads outside the timed call."""
    import torch.nn.functional as F
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
    except TypeError:
        g = qh.shape[1] // kh.shape[1]
        kr, vr = (t.repeat_interleave(g, dim=1) for t in (kh, vh))
        return lambda: F.scaled_dot_product_attention(qh, kr, vr,
                                                      is_causal=True)


def _sdpa_bwd_call(q, k, v, do):
    """One PyTorch call computing flash_attention_bwd's function on the same
    tensors: autograd's backward of `scaled_dot_product_attention` (causal,
    GQA by `enable_gqa`), its forward run once outside the timed call."""
    import torch.nn.functional as F
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                             enable_gqa=True)
        ins = (qh, kh, vh)
    except TypeError:
        g = qh.shape[1] // kh.shape[1]
        kr, vr = (t.repeat_interleave(g, dim=1).detach().requires_grad_()
                  for t in (kh, vh))
        out = F.scaled_dot_product_attention(qh, kr, vr, is_causal=True)
        ins = (qh, kr, vr)
    doh = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, ins, doh, retain_graph=True)


def flash_bwd_work(q, k, v):
    """(bytes, FLOPs, bound terms in seconds) of the causal attention
    backward on (B, S, H, hd) q and (B, T, KV, hd) k, v: q, k, v, o, dO
    and lse read and dq, dk, dv written once; five products, 10 hd FLOPs,
    and one exponential per unmasked (query, key) pair."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    pairs = B * H * sum(min(i + 1, T) for i in range(S))
    flops = 10 * hd * pairs
    nb = nbytes(q, k, v, q, q, q, k, v) + B * H * S * 4
    if q.dtype == torch.float32:
        ops = {"fp32_operations": flops / FP32_FLOP_PER_S,
               "tf32x3_operations": 3 * flops / TF32_FLOP_PER_S}
    else:
        ops = {"bf16_operations": flops / BF16_FLOP_PER_S}
    return nb, flops, {"bytes": nb / HBM_BYTES_PER_S,
                       "exponentials": pairs / SFU_EXP_PER_S, **ops}


def ssm_bwd_work(dt, a, bm, cm, x, hc, dy, dhT):
    """(bytes, bound terms in seconds) of the scan's backward: dt, A, B, C,
    x, the chunk states, dy and dhT read once, ddt, dA, dB, dC, dx and dh0
    written once; one exponential per state and step at the SFU rate (the
    forward's, taken again) and 12 fp32 operations per state and step."""
    B, S, I = dt.shape
    states = B * S * I * a.shape[1]
    nb = nbytes(dt, a, bm, cm, x, hc, dy, dhT) + nbytes(dt, a, bm, cm, x, dhT)
    return nb, {"bytes": nb / HBM_BYTES_PER_S,
                "exponentials": states / SFU_EXP_PER_S,
                "fp32_operations": 12 * states / FP32_FLOP_PER_S}


def measure(env_timing, chain_timing, step_timing, flash_timing, ssm_timing,
            train_timing, errs, launches, per_request, card):
    """One row per kernel at the main path's shapes. `ms` is the kernel's
    device time per launch, the mean over the launches torch.profiler
    recorded (`profiled_launches` of 20; CUDA events around back-to-back
    wrapper calls when it recorded none); `call_ms` is the wrapper call,
    host work included; `plain_ms` is the plain PyTorch version on the
    same inputs. The bound counts each input
    element the function needs read once (an array it gathers from counts
    only the elements it gathers) and each output written once at the HBM
    rate, and the matrix products' FLOPs on the fastest unit that can do
    them (`bound_of`): for fp32 the lesser of the fp32 FMA rate and three
    times the FLOPs (3xTF32) at the dense TF32 rate, for bf16 the bf16
    tensor-core rate. No single PyTorch call computes env_step or the
    denoisers (`library_ms` null); for flash_attention it is
    `scaled_dot_product_attention` on the same tensors, and its bound
    counts 4·hd FLOPs and one exponential (at the SFU rate) per unmasked
    (query, key) pair (`flash_work`); its `variants` time tinyllama's and
    Jamba's prefill shapes in fp32 and bf16, SDPA beside each. ssm_scan's
    operations are its S·I·N exponentials at the SFU rate and its 6 fp32
    operations per state and step (`bound_terms_ms` gives each term); no
    single PyTorch call computes it. `launches` is each kernel's count
    summed over the main-path runs (phases 4, 8, 9, 10, 12, 14, 15-21
    and 23, graph replays included),
    `launches_per_request` a serving kernel's per served request in phases
    12 and 14. The redesigned kernels (all seven) also carry
    `event_device_ms` (CUDA events with the host ahead of the card,
    `device_ms_events`) and, as text, what changed. The two backward
    kernels (phase 22's training path) are timed at tinyllama's 2048-token
    layer (flash_attention_bwd, fp32) and Jamba's (ssm_scan_bwd, fp32),
    each two launches a call (dQ then dK / dV; the scan, then its sum over
    blocks), so their profiler `ms` sums both, with their plain versions
    and, for flash, autograd's backward of `scaled_dot_product_attention`
    as the library call (its forward outside the timing); their `variants`
    add flash at Jamba's hd-128 layer in fp32 and both layers in bf16, SDPA
    beside each, and the scan in bf16; their `launches` are phase 22's main
    paths (22d-22f). Their bounds count five products and one exponential a pair
    (flash, `flash_bwd_work`) and the bytes, one exponential and 12 fp32
    operations per state and step (scan, `ssm_bwd_work`). The env_step row times
    the call the main path makes, an `EnvStepPlan`'s, and the denoiser_step
    row the distilled decision's call, one embedding row for all; the
    ssm_scan row's `variants` time Jamba's prefill in fp32 and bf16."""
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.denoiser.ref import denoiser_chain_ref, denoiser_ref
    from repro_torch.kernels.env_step import ops as EKO
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.kernels.env_step import kernel as EKK
    cfg, statics, st, a, q = env_timing
    plan = EKK.EnvStepPlan(cfg, statics, a.shape[0], a.device)
    env_k = lambda: plan(st, a, q)  # noqa: E731
    env_p = lambda: EKO.env_step_fused(cfg, statics, st, a, q, impl="ref")  # noqa: E731
    out = env_k()
    # Bytes the decision needs: the state, queue and action in full, the
    # arrival times in full, and the other statics where the kernel reads
    # them: noise, step_base, init_base and scale at the decided task only,
    # c at it and at the next queue's l slots, model likewise when its obs
    # column is live (num_models > 1), else at the decided task only.
    B, l = a.shape[0], cfg.queue_window
    gathered = 4 + (l + 1) + (l + 1 if cfg.num_models > 1 else 1)
    env_bytes = nbytes(*st, statics["arr_time"], a, *q, *out[0], *out[1],
                       out[2], out[3], out[4]) + B * gathered * 4
    chain_k = lambda: DK.denoiser_chain(*chain_timing)  # noqa: E731
    chain_p = lambda: denoiser_chain_ref(*chain_timing)  # noqa: E731
    x, tembs = chain_timing[0], chain_timing[3]
    w1, w2, w3 = chain_timing[7], chain_timing[9], chain_timing[11]
    chain_flops = 2 * x.shape[0] * tembs.shape[0] * (
        w1.numel() + w2.numel() + w3.numel())
    chain_bytes = nbytes(*chain_timing, x)          # inputs + the (B, A) output
    step_k = lambda: DK.denoiser_step(*step_timing)  # noqa: E731
    stx, stt, stf, sw1, sb1, sw2, sb2, sw3, sb3 = step_timing
    step_p = lambda: denoiser_ref(  # noqa: E731
        torch.cat([stx, stt.expand(stx.shape[0], -1), stf], dim=-1),
        sw1, sb1, sw2, sb2, sw3, sb3)
    step_flops = 2 * stx.shape[0] * (sw1.numel() + sw2.numel() + sw3.numel())
    step_bytes = nbytes(*step_timing, stx)      # inputs + the (B, A) output
    fq, fk, fv = flash_timing["tinyllama"]      # (B, S, H, hd), (B, T, KV, hd)
    flash_k = lambda: FA.attention(fq, fk, fv, causal=True)  # noqa: E731
    flash_p = lambda: flash_plain(fq, fk, fv)  # noqa: E731
    flash_nb, flash_flops, flash_terms = flash_work(fq, fk, fv)
    flash_lib = _sdpa_call(fq, fk, fv)
    # the launch floor: device time of a one-element kernel, and the time
    # per call of back-to-back launches of it (host launch rate)
    one = torch.zeros(1, device=x.device)
    floor_fn = lambda: one.add_(1.0)  # noqa: E731
    floor = {"device_ms": kernel_device_ms(floor_fn, "elementwise")[0],
             "call_ms": time_ms(floor_fn, 200)}
    (dt, sa, sbm, scm, sx, sh0) = ssm_timing
    sB, sS, sI = dt.shape
    sN = sa.shape[1]
    ssm_k = lambda: SS.selective_scan(dt, sa, sbm, scm, sx, sh0)  # noqa: E731
    ssm_p = lambda: SS.selective_scan(dt, sa, sbm, scm, sx, sh0,  # noqa: E731
                                      impl="ref")
    states = sB * sS * sI * sN                      # one exp per state and step
    ssm_flops = 6 * states
    ssm_bytes, ssm_terms = ssm_work(dt, sa, sbm, scm, sx, sh0)
    fp32 = lambda f: {"fp32_operations": f / FP32_FLOP_PER_S}  # noqa: E731
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    flash_in, ssm_in = train_timing
    bq, bk, bv, bdo = flash_in["tinyllama"]     # fp32, (B, S, H, hd) ...
    bqh, bkh, bvh, bdoh = (t.transpose(1, 2) for t in flash_in["tinyllama"])
    with uncounted():
        bo, blse = FK.flash_attention(bqh, bkh, bvh, causal=True,
                                      with_lse=True)
    fbwd_k = lambda: FK.flash_attention_bwd(  # noqa: E731
        bqh, bkh, bvh, bo, blse, bdoh, causal=True)
    fbwd_p = lambda: attention_bwd_ref(  # noqa: E731
        bqh, bkh, bvh, bo, blse, bdoh, causal=True)
    fbwd_nb, fbwd_flops, fbwd_terms = flash_bwd_work(bq, bk, bv)
    sbwd_k = lambda: SK.ssm_scan_bwd(*ssm_in)  # noqa: E731
    sbwd_p = lambda: ssm_scan_bwd_ref(*ssm_in)  # noqa: E731
    sbwd_nb, sbwd_terms = ssm_bwd_work(*ssm_in)
    sbwd_states = ssm_in[0].numel() * ssm_in[1].shape[1]
    rows = []
    for (name, src, replaces, k_fn, p_fn, lib_fn, nb, flops, ops_s, kname,
         it) in (
            ("env_step", "src/repro_torch/csrc/env_step.cu",
             "src/repro/kernels/env_step/kernel.py:290", env_k, env_p, None,
             env_bytes, 0, fp32(0), "env_step_kernel", 200),
            ("denoiser_chain", "src/repro_torch/csrc/denoiser_chain.cu",
             "src/repro/kernels/denoiser/kernel.py:115", chain_k, chain_p,
             None, chain_bytes, chain_flops,
             {**fp32(chain_flops),
              "tf32x3_operations": 3 * chain_flops / TF32_FLOP_PER_S},
             "chain_cluster_kernel", 200),
            ("denoiser_step", "src/repro_torch/csrc/denoiser_step.cu",
             "src/repro/kernels/denoiser/kernel.py:50", step_k, step_p, None,
             step_bytes, step_flops,
             {**fp32(step_flops),
              "tf32x3_operations": 3 * step_flops / TF32_FLOP_PER_S},
             "step_cluster_kernel", 200),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:83", flash_k,
             flash_p, flash_lib, flash_nb, flash_flops, flash_terms,
             "flash_attention_kernel", 20),
            ("ssm_scan", "src/repro_torch/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:61", ssm_k, ssm_p, None,
             ssm_bytes, ssm_flops,
             {k: v for k, v in ssm_terms.items() if k != "bytes"},
             "ssm_scan_kernel", 20),
            ("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/models/attention.py:126", fbwd_k, fbwd_p,
             _sdpa_bwd_call(bq, bk, bv, bdo), fbwd_nb, fbwd_flops,
             {k: v for k, v in fbwd_terms.items() if k != "bytes"},
             "flash_bwd_", 10),
            ("ssm_scan_bwd", "src/repro_torch/csrc/ssm_scan_bwd.cu",
             "src/repro/models/blocks.py:284", sbwd_k, sbwd_p, None,
             sbwd_nb, 12 * sbwd_states,
             {k: v for k, v in sbwd_terms.items() if k != "bytes"},
             "ssm_scan_bwd_", 10)):
        call_ms = time_ms(k_fn, it)
        dev_ms, seen = kernel_device_ms(
            k_fn, kname, per_call=2 if name in BACKWARD_OF else 1)
        plain_ms = (time_ms(p_fn, 2, warmup=1) if name in BACKWARD_OF
                    else time_ms(p_fn, max(it // 4, 5)))
        terms = {"bytes": nb / HBM_BYTES_PER_S, **ops_s}
        bound, top = bound_of(terms)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "launches_per_request": per_request.get(name),
                     "max_abs_err": errs[name],
                     "ms": call_ms if dev_ms is None else dev_ms,
                     "ms_from": "events" if dev_ms is None else "profiler",
                     "profiled_launches": seen,
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": 1e3 * bound,
                     "bound_by": top,
                     "bound_terms_ms": {k: 1e3 * v for k, v in terms.items()},
                     "bytes": nb, "flops": flops, "launch_floor": floor,
                     "library_ms": (None if lib_fn is None
                                    else time_ms(lib_fn, it))})
        if name in REDESIGNED:
            rows[-1].update({"event_device_ms": device_ms_events(k_fn, it),
                             "redesigned": REDESIGNED[name]})
        if name in BACKWARD_OF:
            rows[-1]["note"] = BACKWARD_OF[name]
        if name == "flash_attention":
            rows[-1]["variants"] = flash_variants(flash_timing)
        if name == "ssm_scan":
            rows[-1]["variants"] = ssm_variants(ssm_timing)
        if name == "flash_attention_bwd":
            # SDPA's backward by CUDA events too: its call time carries
            # autograd's host work, which hides its device time in bf16
            rows[-1]["library_event_device_ms"] = device_ms_events(lib_fn, it)
            rows[-1]["variants"] = flash_bwd_variants(flash_in)
        if name == "ssm_scan_bwd":
            rows[-1]["variants"] = ssm_bwd_variants(ssm_in)
        log(f"phase 6 timing {name} [{card}]: " + json.dumps(rows[-1]))
    return rows


def bound_of(terms):
    """(seconds, "bytes" or "operations") of the least time the card could
    take: the products take the least time of the units that can do them
    (fp32 FMAs or 3xTF32 on the tensor cores); the other terms are all
    needed, so the bound is the largest."""
    alts = ("fp32_operations", "tf32x3_operations")
    need = {k: v for k, v in terms.items() if k not in alts}
    if any(k in terms for k in alts):
        need["operations"] = min(terms[k] for k in alts if k in terms)
    top = max(need, key=need.get)
    return need[top], "bytes" if top == "bytes" else "operations"


def flash_work(q, k, v):
    """(bytes, FLOPs, bound terms in seconds) of causal attention on
    (B, S, H, hd) q and (B, T, KV, hd) k, v: q, k, v read and o written
    once; 4 hd FLOPs and one exponential per unmasked (query, key) pair;
    the products on the fastest unit for the dtype (fp32: fp32 FMAs or
    3xTF32; bf16: the bf16 tensor cores)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    pairs = B * H * sum(min(i + 1, T) for i in range(S))
    flops = 4 * hd * pairs
    nb = nbytes(q, k, v, q)
    if q.dtype == torch.float32:
        ops = {"fp32_operations": flops / FP32_FLOP_PER_S,
               "tf32x3_operations": 3 * flops / TF32_FLOP_PER_S}
    else:
        ops = {"bf16_operations": flops / BF16_FLOP_PER_S}
    return nb, flops, {"bytes": nb / HBM_BYTES_PER_S,
                       "exponentials": pairs / SFU_EXP_PER_S, **ops}


def ssm_work(dt, a, bm, cm, x, h0):
    """(bytes, bound terms in seconds) of the selective scan: dt, A, B, C,
    x and h0 read once, y (dt's dtype) and hT written once; one
    exponential per state and step at the SFU rate and 6 fp32 operations
    per state and step."""
    B, S, I = dt.shape
    states = B * S * I * a.shape[1]
    nb = nbytes(dt, a, bm, cm, x, h0, dt, h0)
    return nb, {"bytes": nb / HBM_BYTES_PER_S,
                "exponentials": states / SFU_EXP_PER_S,
                "fp32_operations": 6 * states / FP32_FLOP_PER_S}


def ssm_variants(inputs, it=20):
    """ssm_scan at Jamba's prefill (`inputs`: fp32 dt, A, B, C, x, h0) in
    fp32 and bf16 (dt, B, C and x cast; A and h0 stay fp32): device ms
    (CUDA events with the host ahead), call ms, the plain version's ms and
    the bound with its terms."""
    from repro_torch.kernels.ssm_scan import ops as SS
    dt32, a, bm32, cm32, x32, h0 = inputs
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dt, bm, cm, x = (t.to(dtype) for t in (dt32, bm32, cm32, x32))
        k_fn = lambda: SS.selective_scan(dt, a, bm, cm, x, h0)  # noqa: E731
        p_fn = lambda: SS.selective_scan(dt, a, bm, cm, x, h0,  # noqa: E731
                                         impl="ref")
        nb, terms = ssm_work(dt, a, bm, cm, x, h0)
        bound, top = bound_of(terms)
        out.append({
            "dtype": str(dtype).replace("torch.", ""), "shape": list(dt.shape),
            "N": a.shape[1], "event_device_ms": device_ms_events(k_fn, it),
            "call_ms": time_ms(k_fn, it), "plain_ms": time_ms(p_fn, 3),
            "bound_ms": 1e3 * bound, "bound_by": top,
            "bound_terms_ms": {n: 1e3 * v for n, v in terms.items()},
            "bytes": nb})
    return out


def flash_bwd_variants(shapes, it=10):
    """flash_attention_bwd at Jamba's hd-128 layer in fp32 and at both
    layers of `shapes` ({"tinyllama", "jamba": fp32 q, k, v, dO}) in bf16
    (tinyllama's fp32 layer is the row itself): o and lse from the forward
    kernel, device ms (CUDA events with the host ahead), call ms, the plain
    version's ms, autograd's backward of `scaled_dot_product_attention` on
    the same tensors (call ms and CUDA-event device ms), and the bound with
    its terms."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    out = []
    for shape, dtype in (("jamba", torch.float32),
                         ("tinyllama", torch.bfloat16),
                         ("jamba", torch.bfloat16)):
        q, k, v, do = (t.to(dtype) for t in shapes[shape])
        qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
        with uncounted():
            o, lse = FK.flash_attention(qh, kh, vh, causal=True,
                                        with_lse=True)
        k_fn = lambda: FK.flash_attention_bwd(  # noqa: E731
            qh, kh, vh, o, lse, doh, causal=True)
        p_fn = lambda: attention_bwd_ref(  # noqa: E731
            qh, kh, vh, o, lse, doh, causal=True)
        nb, flops, terms = flash_bwd_work(q, k, v)
        bound, top = bound_of(terms)
        lib_fn = _sdpa_bwd_call(q, k, v, do)
        with uncounted():
            out.append({
                "shape": shape, "dtype": str(dtype).replace("torch.", ""),
                "q": list(q.shape), "kv": list(k.shape),
                "event_device_ms": device_ms_events(k_fn, it),
                "call_ms": time_ms(k_fn, it),
                "plain_ms": time_ms(p_fn, 2, warmup=1),
                "library_ms": time_ms(lib_fn, it),
                "library_event_device_ms": device_ms_events(lib_fn, it),
                "bound_ms": 1e3 * bound, "bound_by": top,
                "bound_terms_ms": {n: 1e3 * x for n, x in terms.items()},
                "flops": flops, "bytes": nb})
    return out


def ssm_bwd_variants(inputs, it=10):
    """ssm_scan_bwd at Jamba's layer in bf16 (`inputs`: the fp32 row's dt,
    A, B, C, x, chunk states, dy, dhT; dt, B, C, x and dy cast, the chunk
    states those of the bf16 forward from the same h0 = 0): device ms (CUDA
    events with the host ahead), call ms, the plain version's ms and the
    bound with its terms."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    dt32, a, bm32, cm32, x32, _, dy32, dhT = inputs
    dt, bm, cm, x, dy = (t.to(torch.bfloat16)
                         for t in (dt32, bm32, cm32, x32, dy32))
    with uncounted():
        _, _, hc = SK.ssm_scan(dt, a, bm, cm, x, torch.zeros_like(dhT),
                               with_chunks=True)
    args = (dt, a, bm, cm, x, hc, dy, dhT)
    k_fn = lambda: SK.ssm_scan_bwd(*args)  # noqa: E731
    nb, terms = ssm_bwd_work(*args)
    bound, top = bound_of(terms)
    with uncounted():
        return [{"dtype": "bfloat16", "shape": list(dt.shape),
                 "N": a.shape[1], "event_device_ms": device_ms_events(k_fn, it),
                 "call_ms": time_ms(k_fn, it),
                 "plain_ms": time_ms(lambda: ssm_scan_bwd_ref(*args), 1,
                                     warmup=0),
                 "bound_ms": 1e3 * bound, "bound_by": top,
                 "bound_terms_ms": {n: 1e3 * v for n, v in terms.items()},
                 "bytes": nb}]


def flash_variants(shapes, it=20):
    """flash_attention at each prefill shape of `shapes` (fp32 inputs), in
    fp32 and bf16: device ms (CUDA events with the host ahead), call ms,
    the plain version's and `scaled_dot_product_attention`'s ms on the same
    inputs, and the bound with its terms."""
    from repro_torch.kernels.flash_attention import ops as FA
    out = []
    for shape, inputs in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in inputs)
            k_fn = lambda: FA.attention(q, k, v, causal=True)  # noqa: E731
            p_fn = lambda: flash_plain(q, k, v)  # noqa: E731
            nb, flops, terms = flash_work(q, k, v)
            bound, top = bound_of(terms)
            out.append({
                "shape": shape, "dtype": str(dtype).replace("torch.", ""),
                "q": list(q.shape), "kv": list(k.shape),
                "event_device_ms": device_ms_events(k_fn, it),
                "call_ms": time_ms(k_fn, it),
                "plain_ms": time_ms(p_fn, 5),
                "library_ms": time_ms(_sdpa_call(q, k, v), it),
                "bound_ms": 1e3 * bound, "bound_by": top,
                "bound_terms_ms": {n: 1e3 * x for n, x in terms.items()},
                "flops": flops, "bytes": nb})
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs on a "
                 "GPU machine")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as KB
    # The plain versions that the kernels are held against run in full
    # fp32: TF32 keeps about three decimal digits (matmul and cuDNN both).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase 1 card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    report = KB.build(KERNELS)
    log(f"phase 1 built {sorted(report)} in parallel in "
        f"{time.perf_counter() - t0:.3f} s")
    check_ptxas(KERNELS)
    check_sass(KERNELS)

    t0 = time.perf_counter()
    errs = {}
    errs["env_step"], env_timing = phase_env_step(dev)
    errs["denoiser_chain"], chain_timing = phase_chain(dev)
    errs["denoiser_step"], step_timing = phase_step(dev)
    launches, ddpm_ms = phase_main(dev, card)
    phase_profile(dev, card)
    phase_loop_parity(dev)
    log(f"phases 2-5 and 7 took {time.perf_counter() - t0:.3f} s")
    train_errs, train_timing, counts = phase_training(
        dev, card, env_timing, chain_timing, step_timing)
    errs.update(train_errs)
    add_counts(launches, counts)
    t0 = time.perf_counter()
    ts, counts = phase_train(dev, card)
    add_counts(launches, counts)
    params8, counts = phase_distill(dev, card, ts.actor)
    add_counts(launches, counts)
    add_counts(launches, phase_distilled(dev, card, params8, ddpm_ms))
    phase_profile(dev, card, sampler="distilled", params=params8, phase=10)
    log(f"phases 8-10 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    add_counts(launches, phase_graph(dev, card, params8))
    log(f"phase 15 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    add_counts(launches, phase_paper(dev, card, ts.actor)[0])
    log(f"phase 16 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    counts, ppo_state = phase_ppo(dev, card)
    add_counts(launches, counts)
    log(f"phase 17 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    add_counts(launches, phase_stream(dev, card, ts.actor))
    log(f"phase 18 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    add_counts(launches, phase_facade(dev, card, ts.actor, params8,
                                      ppo_state.params))
    log(f"phase 19 took {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    add_counts(launches, phase_serving(dev, card, ts.actor))
    log(f"phase 20 took {time.perf_counter() - t0:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    errs["flash_attention"], flash_timing = phase_flash(dev)
    per_request = {}

    def serve(phase, run, actor):
        counts, served = run(dev, card, actor)
        add_counts(launches, counts)
        for name in ("flash_attention", "ssm_scan"):
            per_request.setdefault(name, {})[f"phase {phase}"] = \
                counts[name] / served
    serve(12, phase_serve_tinyllama, ts.actor)
    log(f"phases 11-12 took {time.perf_counter() - t0:.3f} s")
    gc.collect()              # phase 12's engine and weights are gone, so
    torch.cuda.empty_cache()  # phase 14's peak memory is its own
    t0 = time.perf_counter()
    errs["ssm_scan"], ssm_timing = phase_ssm(dev)
    serve(14, phase_serve_jamba, None)
    log(f"phases 13-14 took {time.perf_counter() - t0:.3f} s")
    gc.collect()              # phase 14's weights are gone before phase
    torch.cuda.empty_cache()  # 21's largest copies load
    t0 = time.perf_counter()
    add_counts(launches, phase_serve_default(dev, card, ts.actor))
    gc.collect()
    torch.cuda.empty_cache()
    serve("21b", phase_serve_olmoe, None)
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, phase_zoo(dev, card))
    log(f"phase 21 took {time.perf_counter() - t0:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    counts, row23b = phase_launch(dev, card, ts.actor)
    add_counts(launches, counts)
    phase_dryrun(dev, card, row23b)
    for name in KERNELS:
        assert launches.get(name, 0) > 0, (name, launches)
    rows = measure(env_timing, chain_timing, step_timing, flash_timing,
                   ssm_timing, train_timing, errs, launches, per_request, card)
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
