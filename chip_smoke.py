#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit: `python3 chip_smoke.py`. It builds the hand-written kernels from
`src/repro_torch/csrc` into `build/` and runs, one line per phase:

1. the card's name and power limit, and the kernels' build time;
2. the env_step kernel against its plain PyTorch version on random states
   (B = 256, E in {8, 12}, K = 32, l = 8, one and three models, with and
   without fault columns): exact on ints, bools and the clock;
3. the denoiser_chain kernel against its plain version (B = 256, A = 10,
   F in {16, 20}, H = 256; K = 10 DDPM and K = 5 DDIM coefficients);
4. the main path: `batch_rollout` of the EAT actor (random weights from a
   seed, the AgentConfig defaults) with samplers "ddpm" and "ddim:5" on the
   cells paper-8srv and paper-12srv (K = 32 tasks, B = 256 envs, a whole
   episode), with both kernels' launch counts, reset just before each run,
   and a short profiled rollout: device busy time and idle share;
5. kernel path against plain path inside the loop: fifo closed loop,
   EAT teacher-forced, EAT closed loop on aggregate metrics;
6. a `kernels` JSON line: each kernel's main-path launches, error, time,
   plain-version time and bound, after the card's `nvidia-smi` line;
7. `{"ok": true, "device": {...}}` as the last line.

A failing phase raises and the script exits non-zero; nothing is caught.
Without CUDA it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and fp32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
CHAIN_ATOL = 1e-4     # ~10x the fp32-vs-fp64 gap of the plain chain
ENV_ATOL = 1e-5       # quality / obs / reward (exp and a reordered sum)
CELLS = (("paper-8srv", 8, 0.1), ("paper-12srv", 12, 0.15))


def log(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------- inputs
def np_traces(rng, B, K, E, num_models, faults, F=4, rate=0.2):
    support = np.array([c for c in (1, 2, 4, 8) if c <= E])
    probs = np.array([0.35, 0.35, 0.2, 0.1])[:len(support)]
    gaps = (rng.exponential(size=(B, K)) / rate).astype(np.float32)
    tr = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
          "c": rng.choice(support, (B, K), p=probs / probs.sum()).astype(np.int32),
          "model": rng.integers(0, num_models, (B, K)).astype(np.int32),
          "noise": (0.004 * rng.standard_normal((B, K))).astype(np.float32)}
    if faults:
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


def kernel_device_ms(fn, name, iters=20):
    """Mean device time of the kernel named `name` per launch, from
    torch.profiler; None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if name in evt.key:
            total += getattr(evt, "device_time_total", 0.0)
    return total / iters / 1e3 if total > 0 else None


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- phases
def phase_env_step(dev, B=256, K=32, l=8, Es=(8, 12), models=(1, 3),
                   decisions=3):
    """env_step kernel vs plain version; returns (max float error, timing
    inputs at the paper-8srv main-path shape)."""
    from repro_torch.core import env as EV
    from repro_torch.kernels.env_step import ops as EK
    worst, timing = 0.0, None
    for E in Es:
        for nm in models:
            for faults in (False, True):
                rng = np.random.default_rng(E * 10 + nm + 100 * faults)
                ms = (1.0, 0.5, 2.0)[:nm] if nm > 1 else ()
                cfg = EV.EnvConfig(num_servers=E, max_tasks=K, queue_window=l,
                                   num_models=nm, model_scale=ms)
                tr = to_dev(np_traces(rng, B, K, E, nm, faults), dev)
                st = EV.EnvState(**to_dev(np_states(rng, B, E, K, nm), dev))
                statics = EV.decision_statics(cfg, tr)
                q = EV.visible_queue(cfg, tr, st)
                for step in range(decisions):
                    a = rng.uniform(size=(B, cfg.action_dim)).astype(np.float32)
                    a[::2, 0] = 0.1
                    if step == decisions - 1:   # NaN actions: defined path
                        a[0::8, 2 + step % l] = np.nan
                        a[2::8, 2:] = np.nan
                        a[4::8, 1] = np.nan
                        a[1::8, :] = np.nan
                    a = torch.from_numpy(a).to(dev)
                    if (E, nm, faults, step) == (Es[0], 1, False, 0):
                        timing = (cfg, statics, st, a, q)
                    got = EK.env_step_fused(cfg, statics, st, a, q)
                    want = EK.env_step_fused(cfg, statics, st, a, q, impl="ref")
                    sync(dev)
                    ctx = f"env_step E={E} nm={nm} faults={faults} step={step}"
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
                    for name, g, w in (("obs", got[2], want[2]),
                                       ("reward", got[3], want[3])):
                        err = (g - w).abs().max().item()
                        assert err <= ENV_ATOL * max(1.0, w.abs().max().item()), \
                            f"{ctx}: {name} err {err}"
                        worst = max(worst, err)
                    st, q = want[0], want[1]
    log(f"phase 2 env_step kernel == plain: {len(Es) * len(models) * 2} cases x "
        f"{decisions} decisions at B={B} K={K} l={l}, NaN actions in the last; "
        f"ints, bools and clock exact, max float err {worst:.3g} "
        f"(tol {ENV_ATOL})")
    return worst, timing


def phase_chain(dev, B=256, A=10, Fs=(16, 20), H=256, T=10):
    """denoiser_chain kernel vs plain version; returns (max error, timing
    inputs at the paper-8srv DDPM main-path shape)."""
    from repro_torch.actors import samplers as SMP
    from repro_torch.core import diffusion as DF
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.denoiser.ref import denoiser_chain_ref
    g = torch.Generator(device=dev).manual_seed(3)
    sched = DF.vp_schedule(T, device=dev)
    worst, timing = 0.0, None
    for F in Fs:
        p = DF.init_denoiser(A, F, H, generator=g, device=dev)
        w = [t for layer in p["layers"] for t in (layer["w"], layer["b"])]
        x = torch.randn((B, A), generator=g, device=dev)
        f_s = torch.randn((B, F), generator=g, device=dev)
        for kind, K in (("ddpm", None), ("ddim", 5)):
            c = SMP.chain_coeffs(sched, kind, K)
            Ks = c.tembs.shape[0]
            noises = (torch.randn((Ks, B, A), generator=g, device=dev)
                      if kind == "ddpm" else torch.zeros((Ks, B, A), device=dev))
            args = (x, noises, f_s, c.tembs, c.coef_x, c.coef_e, c.coef_n, *w)
            got = DK.denoiser_chain(*args)
            want = denoiser_chain_ref(*args)
            err = (got - want).abs().max().item()
            assert got.shape == (B, A) and bool(torch.isfinite(got).all())
            assert err <= CHAIN_ATOL, f"chain F={F} {kind}: err {err}"
            worst = max(worst, err)
            if (F, kind) == (Fs[0], "ddpm"):
                timing = args
    log(f"phase 3 denoiser_chain kernel ~ plain: F in {list(Fs)}, ddpm K={T} "
        f"and ddim K=5 at B={B} A={A} H={H}; max abs err {worst:.3g} "
        f"(tol {CHAIN_ATOL})")
    return worst, timing


def cell_setup(dev, name, E, rate, B, seed=0):
    from repro_torch.core import env as EV
    from repro_torch.core.workload import TraceConfig, make_trace_batch
    ecfg = EV.EnvConfig(num_servers=E, queue_window=8, max_tasks=32)
    tc = TraceConfig(num_tasks=32, arrival_rate=rate, max_servers=E)
    traces = make_trace_batch(
        tc, B, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    return ecfg, traces


def phase_main(dev, card, B=256, cells=CELLS, samplers=("ddpm", "ddim:5"),
               acfg=None):
    """The main path, each run with both launch counts set to 0 just before
    it; returns {kernel: launches summed over the runs}."""
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.env_step import kernel as EK
    acfg = acfg or AG.AgentConfig()
    launches = {"env_step": 0, "denoiser_chain": 0}
    for name, E, rate in cells:
        ecfg, traces = cell_setup(dev, name, E, rate, B)
        params = AG.init_actor(
            ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
        for sampler in samplers:
            policy = actor_policy(ecfg, acfg, sampler=sampler, device=dev)
            gen = torch.Generator(device=dev).manual_seed(2)
            sync(dev)
            EK.env_step.launches = 0
            DK.denoiser_chain.launches = 0
            t0 = time.perf_counter()
            res = RO.batch_rollout(ecfg, traces, policy, params, generator=gen,
                                   num_steps=ecfg.max_steps, device=dev)
            sync(dev)
            secs = time.perf_counter() - t0
            n_env, n_chain = EK.env_step.launches, DK.denoiser_chain.launches
            m = res.metrics
            for k, v in m.items():
                assert v.shape == (B,) and bool(torch.isfinite(v.float()).all()), k
            longest = int(m["episode_len"].max())
            assert n_env > 0 and n_chain > 0, (name, sampler, n_env, n_chain)
            assert n_env == n_chain, (n_env, n_chain)
            assert longest <= n_env <= ecfg.max_steps, (longest, n_env)
            assert int(m["num_scheduled"].sum()) > 0
            launches["env_step"] += n_env
            launches["denoiser_chain"] += n_chain
            row = {"card": card, "cell": name, "sampler": sampler, "B": B,
                   "decisions": n_env, "ms_per_decision": 1e3 * secs / n_env,
                   "launches": {"env_step": n_env, "denoiser_chain": n_chain},
                   "metrics": {k: float(v.float().mean()) for k, v in m.items()}}
            log("phase 4 main path " + json.dumps(row))
    return launches


def phase_profile(dev, card, B=256, steps=64, acfg=None):
    """Where a decision's time goes on the main path (paper-8srv, "ddpm"):
    a short rollout under torch.profiler. Device busy time is the sum of
    the device-side events (one stream, so they do not overlap); the idle
    share is 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.actors.policies import actor_policy
    from repro_torch.core import agent as AG
    from repro_torch.core import rollout as RO
    acfg = acfg or AG.AgentConfig()
    ecfg, traces = cell_setup(dev, "paper-8srv", 8, 0.1, B)
    params = AG.init_actor(
        ecfg, acfg, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev)
    policy = actor_policy(ecfg, acfg, device=dev)

    def run():
        RO.batch_rollout(ecfg, traces, policy, params, num_steps=steps,
                         generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
        sync(dev)
    run()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    by_name, n_dev = {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_dev += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"card": card, "cell": "paper-8srv", "sampler": "ddpm", "B": B,
           "decisions": steps, "wall_ms_per_decision": 1e3 * wall / steps,
           "device_busy_ms_per_decision": busy_us / 1e3 / steps,
           "device_idle_share": 1.0 - busy_us / 1e6 / wall,
           "device_events_per_decision": n_dev / steps,
           "top_device_us_per_decision": {n[:60]: us / steps for n, us in top}}
    log("phase 4 profile " + json.dumps(row))


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


def phase_loop_parity(dev, B=256, cells=CELLS, acfg=None):
    from repro_torch.actors.policies import actor_policy
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

        def run(impl, collect=False):
            pol = actor_policy(ecfg, acfg, device=dev, impl=impl)
            return RO.batch_rollout(
                ecfg, traces, pol, params, collect=collect, impl=impl,
                generator=torch.Generator(device=dev).manual_seed(2), **kw)
        k = run("auto", collect=True)
        t = RO.batch_rollout(ecfg, traces, RO.sequence_policy(ecfg),
                             {"seq": k.transitions.action}, impl="ref",
                             collect=True, **kw)
        _same_state(k.final_state, t.final_state, f"teacher {name}")
        _same_metrics(k.metrics, t.metrics, f"teacher {name}")
        for f in ("valid", "done"):
            assert torch.equal(getattr(k.transitions, f),
                               getattr(t.transitions, f)), f"teacher {f}"
        obs_err = (k.transitions.next_obs - t.transitions.next_obs).abs().max().item()
        assert obs_err <= ENV_ATOL, f"teacher obs err {obs_err}"
        log(f"phase 5 eat teacher-forced {name}: the kernel path's "
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
        log(f"phase 5 eat closed loop {name}: kernel vs plain means "
            + json.dumps({k_: [round(a, 6), round(b, 6)] for k_, (a, b) in agg.items()})
            + f" within 5%; envs with identical final state "
            f"{int(same.sum())}/{B}")


def measure(env_timing, chain_timing, env_err, chain_err, launches, card):
    """One row per kernel at the main path's shapes. `ms` is the kernel's
    device time per launch from torch.profiler (CUDA events around
    back-to-back wrapper calls when the profiler shows no device time);
    `call_ms` is the wrapper call, host work included; `plain_ms` is the
    plain PyTorch version on the same inputs. The bound counts each input
    element the function needs read once (an array it gathers from counts
    only the elements it gathers) and each output written once at the HBM
    rate, and the matrix products' FLOPs at the fp32 rate (no single
    PyTorch call computes either function, so `library_ms` is null)."""
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.denoiser.ref import denoiser_chain_ref
    from repro_torch.kernels.env_step import ops as EKO
    cfg, statics, st, a, q = env_timing
    env_k = lambda: EKO.env_step_fused(cfg, statics, st, a, q)  # noqa: E731
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
    # the launch floor: device time of a one-element kernel, and the time
    # per call of back-to-back launches of it (host launch rate)
    one = torch.zeros(1, device=x.device)
    floor_fn = lambda: one.add_(1.0)  # noqa: E731
    floor = {"device_ms": kernel_device_ms(floor_fn, "elementwise"),
             "call_ms": time_ms(floor_fn, 200)}
    rows = []
    for (name, src, replaces, k_fn, p_fn, err, nb, flops, kname) in (
            ("env_step", "src/repro_torch/csrc/env_step.cu",
             "src/repro/kernels/env_step/kernel.py:290", env_k, env_p,
             env_err, env_bytes, 0, "env_step_kernel"),
            ("denoiser_chain", "src/repro_torch/csrc/denoiser_chain.cu",
             "src/repro/kernels/denoiser/kernel.py:115", chain_k, chain_p,
             chain_err, chain_bytes, chain_flops, "chain_kernel")):
        call_ms = time_ms(k_fn, 200)
        dev_ms = kernel_device_ms(k_fn, kname)
        plain_ms = time_ms(p_fn, 50)
        t_bytes, t_ops = nb / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err,
                     "ms": call_ms if dev_ms is None else dev_ms,
                     "ms_from": "events" if dev_ms is None else "profiler",
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nb, "flops": flops, "launch_floor": floor,
                     "library_ms": None})
        log(f"phase 6 timing {name} [{card}]: " + json.dumps(rows[-1]))
    return rows


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
    report = KB.build(["env_step", "denoiser_chain"])
    log(f"phase 1 built {sorted(report)} in parallel in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 1 ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    env_err, env_timing = phase_env_step(dev)
    chain_err, chain_timing = phase_chain(dev)
    launches = phase_main(dev, card)
    phase_profile(dev, card)
    phase_loop_parity(dev)
    rows = measure(env_timing, chain_timing, env_err, chain_err, launches,
                   card)
    log(f"phases 2-6 took {time.perf_counter() - t0:.3f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
