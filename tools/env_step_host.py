#!/usr/bin/env python3
"""Where the host time of an env_step call goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit: `python3 tools/env_step_host.py`. At the paper-8srv shape of
`chip_smoke.py` phase 6 (B = 256 envs, E = 8, K = 32, l = 8) it prints the
host microseconds per call, each part timed alone over 1000 calls
(perf_counter_ns), of

1. the per-call work of the env_step wrapper before `EnvStepPlan`: 23
   tensor checks, 18 output allocations, a fresh 45-slot pointer table,
   the stream lookup and the ctypes launch;
2. an `EnvStepPlan` call by part (the 16 per-decision checks, the three
   output buffers, carving the 18 views, the stream lookup and the ctypes
   launch) and whole, and `env_step_fused`, which builds a plan per call;
3. ways to make the 18 outputs: 18 allocations, or three buffers cut by
   split and view, by `_unflatten_dense_tensors` or by `as_strided`;

and the call times of 1 and of the plan by CUDA events (`chip_smoke.time_ms`).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch._utils import _unflatten_dense_tensors

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.core import env as EV  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.env_step import kernel as EKK  # noqa: E402
from repro_torch.kernels.env_step import ops as EKO  # noqa: E402

N = 1000


def us(fn, n=N):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    out = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return out


def plan_split(plan, st, act, q):
    """Host microseconds per `EnvStepPlan` call by part, each timed alone
    over N calls, and the whole call."""
    bufs = plan.buffers()
    lib = EKK._lib()
    return {"check": us(lambda: plan.check(st, act, q)),
            "buffers": us(plan.buffers),
            "carve": us(lambda: plan.carve(bufs)),
            "stream": us(lambda: KB.raw_stream(plan.device.index)),
            "launch": us(lambda: lib.env_step_launch(
                plan._cfg, plan._table, plan.B, int(plan.faulty),
                KB.raw_stream(plan.device.index))),
            "call": us(lambda: plan(st, act, q))}


def unplanned_call(cfg, statics, st, act, q, parts):
    """One decision as the wrapper before `EnvStepPlan` made it; adds each
    part's nanoseconds to `parts`."""
    t0 = time.perf_counter_ns()
    E, K, l, A = cfg.num_servers, cfg.max_tasks, cfg.queue_window, cfg.action_dim
    B, dev = act.shape[0], act.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ins = {"time": (st.time, f32, (B,)),
           "free": (st.server_free_at, f32, (B, E)),
           "smodel": (st.server_model, i32, (B, E)),
           "sgang": (st.server_gang, i32, (B, E)),
           "sgsize": (st.server_gang_size, i32, (B, E)),
           "tstatus": (st.task_status, i32, (B, K)),
           "tstart": (st.task_start, f32, (B, K)),
           "tfinish": (st.task_finish, f32, (B, K)),
           "tsteps": (st.task_steps, i32, (B, K)),
           "tqual": (st.task_quality, f32, (B, K)),
           "treload": (st.task_reload, i32, (B, K)),
           "staken": (st.steps_taken, i32, (B,)),
           "arr": (statics["arr_time"], f32, (B, K)),
           "c": (statics["c"], i32, (B, K)),
           "model": (statics["model"], i32, (B, K)),
           "noise": (statics["noise"], f32, (B, K)),
           "step_base": (statics["step_base"], f32, (B, K)),
           "init_base": (statics["init_base"], f32, (B, K)),
           "scale": (statics["scale"], f32, (B, K)),
           "action": (act, f32, (B, A)), "qidx": (q.idx, i32, (B, l)),
           "qvalid": (q.valid, b8, (B, l)),
           "qqueued": (q.queued, b8, (B, K))}
    for name, (x, dtype, shape) in ins.items():
        EKK._check(name, x, dtype, shape, dev)
    t1 = time.perf_counter_ns()

    def empty(dtype, *shape):
        return torch.empty((B,) + shape, dtype=dtype, device=dev)
    outs = [empty(f32), empty(f32, E), empty(i32, E), empty(i32, E),
            empty(i32, E), empty(i32, K), empty(f32, K), empty(f32, K),
            empty(i32, K), empty(f32, K), empty(i32, K), empty(i32),
            empty(i32, l), empty(b8, l), empty(b8, K), empty(f32, 3, E + l),
            empty(f32), empty(b8)]
    t2 = time.perf_counter_ns()
    ptrs = [ins[n][0].data_ptr() if n in ins else None for n in EKK._INPUTS]
    ptrs += [o.data_ptr() for o in outs]
    table = (ctypes.c_void_p * EKK._N_PTRS)(*ptrs)
    t3 = time.perf_counter_ns()
    err = EKK._lib().env_step_launch(
        ctypes.byref(EKK._ccfg(cfg, 0)), table, B, 0,
        torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0, err
    t4 = time.perf_counter_ns()
    for i, d in enumerate((t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
        parts[i] += d
    return outs


def main():
    if not torch.cuda.is_available():
        sys.exit("env_step_host: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    KB.build(["env_step"])
    dev = torch.device("cuda")
    _, (cfg, statics, st, act, q) = CS.phase_env_step(
        dev, Es=(8,), models=(1,), decisions=2)
    assert not EV.has_faults(statics)
    parts = [0, 0, 0, 0]
    unplanned_call(cfg, statics, st, act, q, parts)
    parts = [0, 0, 0, 0]
    total = us(lambda: unplanned_call(cfg, statics, st, act, q, parts))
    n = N + 10
    print("before " + json.dumps({
        "check_23": parts[0] / n / 1e3, "empty_18": parts[1] / n / 1e3,
        "table_45": parts[2] / n / 1e3, "stream_and_launch": parts[3] / n / 1e3,
        "call": total,
        "call_ms_events": CS.time_ms(
            lambda: unplanned_call(cfg, statics, st, act, q, [0] * 4), 200)}),
        flush=True)
    plan = EKK.EnvStepPlan(cfg, statics, act.shape[0], dev)
    print("plan " + json.dumps({
        **plan_split(plan, st, act, q),
        "call_ms_events": CS.time_ms(lambda: plan(st, act, q), 200),
        "env_step_fused": us(
            lambda: EKO.env_step_fused(cfg, statics, st, act, q))}), flush=True)
    lay = EKK._layout(cfg.num_servers, cfg.max_tasks, cfg.queue_window,
                      cfg.action_dim, act.shape[0], 0)
    bufs = plan.buffers()
    shapes = {k: [o[2] for o in lay.outs if o[1] == k] for k in bufs}
    meta = {k: [torch.empty(s, device="meta") for s in v]
            for k, v in shapes.items()}
    sizes = {k: [int(torch.Size(s).numel()) for s in v]
             for k, v in shapes.items()}
    dtypes = {"f": torch.float32, "i": torch.int32, "b": torch.bool}
    print("outputs " + json.dumps({
        "empty_18": us(lambda: [torch.empty(s, dtype=dtypes[k], device=dev)
                                for k, v in shapes.items() for s in v]),
        "buffers_3": us(plan.buffers),
        "split_and_view": us(lambda: [
            p if len(s) == 1 else p.view(s) for k, b in bufs.items()
            for p, s in zip(b.split(sizes[k]), shapes[k])]),
        "unflatten": us(lambda: [_unflatten_dense_tensors(b, meta[k])
                                 for k, b in bufs.items()]),
        "as_strided (the plan's carve)": us(lambda: plan.carve(bufs))}),
        flush=True)


if __name__ == "__main__":
    main()
