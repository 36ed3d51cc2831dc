"""Wrapper of the CUDA env-step kernel (`csrc/env_step.cu`).

Replaces the TPU kernel `repro/kernels/env_step/kernel.py::env_step_pallas`
(`_env_step_kernel`). What bounds it on an H100: launch latency. Each env
reads and writes a few KB, so at the paper's widths a decision over 256 envs
moves under a MB. The kernel therefore gives each env one warp (lanes stride
over servers and tasks, reductions are warp shuffles, no block barrier) and
does the whole decision, the next queue and the observation in one launch.

For CPU tensors the wrapper takes the plain version (`ref.env_step_ref`);
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core import env as EV
from repro_torch.kernels import build as KB
from repro_torch.kernels.env_step.ref import env_step_ref

_INPUTS = ("time", "free", "smodel", "sgang", "sgsize", "tstatus", "tstart",
           "tfinish", "tsteps", "tqual", "treload", "staken", "arr", "c",
           "model", "noise", "step_base", "init_base", "scale", "action",
           "qidx", "qvalid", "qqueued", "fds", "fde", "fslow", "fcold")
_N_PTRS = len(_INPUTS) + 18       # the kernel's 18 outputs follow


class _Cfg(ctypes.Structure):
    """Mirrors `struct EnvStepCfg` in csrc/env_step.cu, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "E", "K", "L", "F", "A", "num_models", "max_steps", "s_min",
        "s_max")] + [(n, ctypes.c_float) for n in (
            "time_limit", "alpha_q", "beta_t", "mu_t", "k_time", "lambda_q",
            "p_quality", "q_min", "inv_ts", "inv_nm")])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = KB.load("env_step")
    if lib.env_step_ptr_count() != _N_PTRS:
        raise RuntimeError("csrc/env_step.cu and its wrapper disagree on the "
                           "pointer table")
    lib.env_step_launch.argtypes = [ctypes.POINTER(_Cfg),
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.env_step_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _ccfg(cfg: EV.EnvConfig, F: int) -> _Cfg:
    """The kernel's config struct, built once per (EnvConfig, F)."""
    return _Cfg(E=cfg.num_servers, K=cfg.max_tasks, L=cfg.queue_window, F=F,
                A=cfg.action_dim, num_models=cfg.num_models,
                max_steps=cfg.max_steps, s_min=cfg.s_min, s_max=cfg.s_max,
                time_limit=cfg.time_limit, alpha_q=cfg.alpha_q,
                beta_t=cfg.beta_t, mu_t=cfg.mu_t, k_time=cfg.k_time,
                lambda_q=cfg.lambda_q, p_quality=cfg.p_quality,
                q_min=cfg.q_min, inv_ts=1.0 / cfg.time_scale,
                inv_nm=1.0 / max(cfg.num_models, 1))


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"env_step kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def env_step(cfg: EV.EnvConfig, statics: Dict, state: EV.EnvState, action,
             q: EV.QueueView):
    """One fused decision for B envs: (state', queue', obs', reward, done)."""
    if action.device.type == "cpu":
        return env_step_ref(cfg, statics, state, action, q)
    if action.device.type != "cuda":
        raise ValueError(f"env_step runs on cpu or cuda, not {action.device}")
    E, K, l, A = cfg.num_servers, cfg.max_tasks, cfg.queue_window, cfg.action_dim
    if l > K:
        raise ValueError(f"queue_window {l} exceeds max_tasks {K}")
    B = action.shape[0]
    dev = action.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    faulty = EV.has_faults(statics)
    F = statics["f_down_start"].shape[2] if faulty else 0
    ins = {
        "time": (state.time, f32, (B,)),
        "free": (state.server_free_at, f32, (B, E)),
        "smodel": (state.server_model, i32, (B, E)),
        "sgang": (state.server_gang, i32, (B, E)),
        "sgsize": (state.server_gang_size, i32, (B, E)),
        "tstatus": (state.task_status, i32, (B, K)),
        "tstart": (state.task_start, f32, (B, K)),
        "tfinish": (state.task_finish, f32, (B, K)),
        "tsteps": (state.task_steps, i32, (B, K)),
        "tqual": (state.task_quality, f32, (B, K)),
        "treload": (state.task_reload, i32, (B, K)),
        "staken": (state.steps_taken, i32, (B,)),
        "arr": (statics["arr_time"], f32, (B, K)),
        "c": (statics["c"], i32, (B, K)),
        "model": (statics["model"], i32, (B, K)),
        "noise": (statics["noise"], f32, (B, K)),
        "step_base": (statics["step_base"], f32, (B, K)),
        "init_base": (statics["init_base"], f32, (B, K)),
        "scale": (statics["scale"], f32, (B, K)),
        "action": (action, f32, (B, A)),
        "qidx": (q.idx, i32, (B, l)),
        "qvalid": (q.valid, b8, (B, l)),
        "qqueued": (q.queued, b8, (B, K)),
    }
    if faulty:
        ins.update({
            "fds": (statics["f_down_start"], f32, (B, E, F)),
            "fde": (statics["f_down_end"], f32, (B, E, F)),
            "fslow": (statics["f_slow"], f32, (B, E)),
            "fcold": (statics["f_cold"], f32, (B, 1)),
        })
    for name, (x, dtype, shape) in ins.items():
        _check(name, x, dtype, shape, dev)

    def empty(dtype, *shape):
        return torch.empty((B,) + shape, dtype=dtype, device=dev)

    new_state = EV.EnvState(
        time=empty(f32), server_free_at=empty(f32, E),
        server_model=empty(i32, E), server_gang=empty(i32, E),
        server_gang_size=empty(i32, E), task_status=empty(i32, K),
        task_start=empty(f32, K), task_finish=empty(f32, K),
        task_steps=empty(i32, K), task_quality=empty(f32, K),
        task_reload=empty(i32, K), steps_taken=empty(i32))
    new_q = EV.QueueView(idx=empty(i32, l), valid=empty(b8, l),
                         queued=empty(b8, K))
    obs, reward, done = empty(f32, 3, E + l), empty(f32), empty(b8)
    outs = list(new_state) + list(new_q) + [obs, reward, done]
    ptrs = [ins[n][0].data_ptr() if n in ins else None for n in _INPUTS]
    ptrs += [o.data_ptr() for o in outs]
    table = (ctypes.c_void_p * _N_PTRS)(*ptrs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().env_step_launch(ctypes.byref(_ccfg(cfg, F)), table, B,
                                 int(faulty), stream)
    if err != 0:
        raise RuntimeError(f"env_step kernel launch failed: CUDA error {err}")
    env_step.launches += 1
    return new_state, new_q, obs, reward, done


env_step.launches = 0
