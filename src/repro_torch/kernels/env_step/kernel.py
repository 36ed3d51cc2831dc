"""Wrapper of the CUDA env-step kernel (`csrc/env_step.cu`).

Replaces the TPU kernel `repro/kernels/env_step/kernel.py::env_step_pallas`
(`_env_step_kernel`). What bounds it on an H100: latency. Each env reads and
writes a few KB, so at the paper's widths a decision over 256 envs moves
under a MB (0.18 µs at the memory rate). The kernel gives each env one warp
(two per block, so 256 envs reach 128 SMs; lanes stride over servers and
tasks, reductions are warp shuffles and `__reduce_*_sync`, no block
barrier) and does the whole decision, the next queue and the observation in
one launch. Each warp issues every load its env needs in one round (one
element a lane of every row, all loads before the first store) into its
slice of shared memory (`env_smem_bytes`) and never reads device memory
again; each output is written once. Envs of at most 32 servers, tasks,
queue slots and action dims (every paper cell) run an instantiation whose
lanes hold one element of every row, with gang counts taken across the
warp's registers.

The kernel takes a few microseconds; a call's host work took far longer, so
`EnvStepPlan` binds the kernel to one rollout's constants: the statics are
checked and their slots of a persistent pointer table written once, and a
decision checks only its 16 per-decision tensors, allocates one buffer per
output dtype, carves the 18 outputs from them and launches. `env_step`
builds a plan per call; `batch_rollout` keeps one for the whole episode.

A plan on the CPU checks the same tensors and takes the plain version
(`ref.env_step_ref`); on the card it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import env as EV
from repro_torch.kernels import build as KB
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.denoiser.kernel import SMEM_LIMIT
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
    lib.env_step_smem_bytes.argtypes = [ctypes.POINTER(_Cfg), ctypes.c_int]
    lib.env_step_smem_bytes.restype = ctypes.c_int
    return lib


#: envs per block of the kernel (one warp each), fixed in csrc/env_step.cu
ENV_WARPS = 2


def _region(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def env_smem_bytes(E: int, K: int, l: int, A: int, F: int) -> int:
    """Shared memory of one block of the env_step kernel, bytes, for E
    servers, K tasks, l queue slots, A action dims and F fault columns (0:
    no faults): `make_layout` in csrc/env_step.cu, region for region, each
    on 16 bytes. A warp's slice holds the staged inputs (time, steps taken
    and the cold flag in 16 bytes; the four server rows; the six task-state
    rows; the seven statics over all K; the action; the queue's indices,
    validity bytes and the K queued bytes; with faults the two windows of
    E x F and the slow factors) and the work arrays (four int and one
    float array of E, the K priorities)."""
    ef = E * F
    sizes = ([16] + [4 * E] * 4 + [4 * K] * 13 + [4 * A, 4 * l, l, K]
             + [4 * ef, 4 * ef, 4 * E if F else 0] + [4 * E] * 5 + [4 * K])
    return ENV_WARPS * sum(_region(n) for n in sizes)


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


# slots of the kernel's pointer table (the order of `_INPUTS`, then the
# outputs in the order of EnvState, QueueView, obs, reward, done)
_SLOT = {n: i for i, n in enumerate(_INPUTS)}
_STATIC_INPUTS = ("arr", "c", "model", "noise", "step_base", "init_base",
                  "scale")
_STATIC_KEYS = ("arr_time", "c", "model", "noise", "step_base", "init_base",
                "scale")
_FAULT_INPUTS = ("fds", "fde", "fslow", "fcold")


_F32, _I32, _B8 = torch.float32, torch.int32, torch.bool
_DTYPES = {"f": _F32, "i": _I32, "b": _B8}
_ITEMSIZE = {"f": 4, "i": 4, "b": 1}


class _Layout(NamedTuple):
    statics: tuple   # (input name, statics key, dtype, shape)
    dyn: tuple       # (table slot, name, dtype, shape), per decision
    outs: tuple      # (table slot, buffer, shape, stride, offset)
    sizes: Dict      # elements of each output buffer


@functools.lru_cache(maxsize=None)
def _layout(E: int, K: int, l: int, A: int, B: int, F: int) -> _Layout:
    """What a plan checks and carves for B envs of E servers, K tasks, l
    queue slots, A action dims and F fault columns (0: no faults), built
    once per shape."""
    statics = tuple(zip(_STATIC_INPUTS, _STATIC_KEYS,
                        (_F32, _I32, _I32, _F32, _F32, _F32, _F32),
                        ((B, K),) * 7))
    if F:
        statics += tuple(zip(_FAULT_INPUTS, EV.FAULT_COLS, (_F32,) * 4,
                             ((B, E, F), (B, E, F), (B, E), (B, 1))))
    # the per-decision inputs, in the order of (*state, action, *queue)
    dyn = (("time", _F32, (B,)), ("free", _F32, (B, E)),
           ("smodel", _I32, (B, E)), ("sgang", _I32, (B, E)),
           ("sgsize", _I32, (B, E)), ("tstatus", _I32, (B, K)),
           ("tstart", _F32, (B, K)), ("tfinish", _F32, (B, K)),
           ("tsteps", _I32, (B, K)), ("tqual", _F32, (B, K)),
           ("treload", _I32, (B, K)), ("staken", _I32, (B,)),
           ("action", _F32, (B, A)), ("qidx", _I32, (B, l)),
           ("qvalid", _B8, (B, l)), ("qqueued", _B8, (B, K)))
    # the outputs in the kernel's order: EnvState, QueueView, obs, reward,
    # done, each in its dtype's buffer at a running offset
    outs = (("f", (B,)), ("f", (B, E)), ("i", (B, E)), ("i", (B, E)),
            ("i", (B, E)), ("i", (B, K)), ("f", (B, K)), ("f", (B, K)),
            ("i", (B, K)), ("f", (B, K)), ("i", (B, K)), ("i", (B,)),
            ("i", (B, l)), ("b", (B, l)), ("b", (B, K)),
            ("f", (B, 3, E + l)), ("f", (B,)), ("b", (B,)))
    sizes = {"f": 0, "i": 0, "b": 0}
    carved = []
    for j, (buf, shape) in enumerate(outs):
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        carved.append((len(_INPUTS) + j, buf, shape, stride, sizes[buf]))
        sizes[buf] += int(np.prod(shape))
    return _Layout(statics, tuple((_SLOT[n], n, dt, torch.Size(s))
                                  for n, dt, s in dyn), tuple(carved), sizes)


class EnvStepPlan:
    """The env_step kernel bound to one rollout's constants: (cfg, statics,
    B, F, device), checked once.

    Built once, it holds the kernel's config struct and a persistent
    pointer table whose static slots (the traces' per-task constants and
    fault columns) are written here. Each call then checks only the 16
    per-decision tensors (the 12 state fields, the action and the 3 queue
    fields) against a precomputed spec, allocates the 18 outputs as one
    float32, one int32 and one bool buffer carved into contiguous views,
    writes the per-decision slots and launches. The buffers are fresh on
    every call, so outputs a caller keeps are never overwritten.

    A caller that keeps the plan keeps the statics alive (the table points
    at them). The decision's CUDA graph (`actors/program.py`) captures a
    call: the table's entries are copied into the launch's arguments, and
    the fresh buffers come from the capture's pool, fixed across replays."""

    def __init__(self, cfg: EV.EnvConfig, statics: Dict, B: int, device=None):
        dev = torch.device(device) if device is not None \
            else statics["arr_time"].device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"env_step runs on cpu or cuda, not {dev}")
        if cfg.queue_window > cfg.max_tasks:
            raise ValueError(f"queue_window {cfg.queue_window} exceeds "
                             f"max_tasks {cfg.max_tasks}")
        self.faulty = EV.has_faults(statics)
        F = statics["f_down_start"].shape[2] if self.faulty else 0
        self.cfg, self.statics, self.B, self.device = cfg, statics, B, dev
        self._dev = dev.index if dev.type == "cuda" else -1   # get_device()
        lay = _layout(cfg.num_servers, cfg.max_tasks, cfg.queue_window,
                      cfg.action_dim, B, F)
        self._table = (ctypes.c_void_p * _N_PTRS)()
        for name, key, dtype, shape in lay.statics:
            _check(name, statics[key], dtype, shape, dev)
            self._table[_SLOT[name]] = statics[key].data_ptr()
        self._dyn, self._outs, self._sizes = lay.dyn, lay.outs, lay.sizes
        self._cfg = ctypes.byref(_ccfg(cfg, F))
        self.smem_bytes = env_smem_bytes(cfg.num_servers, cfg.max_tasks,
                                         cfg.queue_window, cfg.action_dim, F)
        if self.smem_bytes > SMEM_LIMIT:
            raise ValueError(
                f"env_step kernel: {self.smem_bytes} bytes of shared memory "
                f"per block at E={cfg.num_servers} K={cfg.max_tasks} "
                f"F={F}, over {SMEM_LIMIT}")
        if dev.type == "cuda" and _lib().env_step_smem_bytes(
                self._cfg, int(self.faulty)) != self.smem_bytes:
            raise RuntimeError("csrc/env_step.cu and env_smem_bytes disagree "
                               "on the shared-memory layout")

    def buffers(self):
        """Fresh output buffers {"f": float32, "i": int32, "b": bool}."""
        return {k: torch.empty(n, dtype=_DTYPES[k], device=self.device)
                for k, n in self._sizes.items()}

    def carve(self, bufs):
        """The 18 outputs as contiguous, disjoint views of `bufs` (one
        `as_strided` each, the cheapest view to make), in the kernel's
        order, with their addresses written into the table."""
        base = {k: b.data_ptr() for k, b in bufs.items()}
        tab, size = self._table, _ITEMSIZE
        out = []
        for slot, buf, shape, stride, off in self._outs:
            tab[slot] = base[buf] + off * size[buf]
            out.append(bufs[buf].as_strided(shape, stride, off))
        return out

    def check(self, state: EV.EnvState, action, q: EV.QueueView):
        """Hold the 16 per-decision tensors to the plan's spec, raising
        ValueError naming the first that differs, and write their slots."""
        tab, dev = self._table, self._dev
        for t, (slot, name, dtype, shape) in zip((*state, action, *q),
                                                 self._dyn):
            if t.dtype is not dtype or t.get_device() != dev \
                    or t.shape != shape or not t.is_contiguous():
                raise ValueError(
                    f"env_step kernel: {name} must be a contiguous {dtype} "
                    f"tensor of shape {tuple(shape)} on {self.device}; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device} "
                    f"(contiguous={t.is_contiguous()})")
            tab[slot] = t.data_ptr()

    def __call__(self, state: EV.EnvState, action, q: EV.QueueView):
        """One fused decision: (state', queue', obs', reward, done). A plan
        on the CPU checks the same tensors and takes the plain version."""
        self.check(state, action, q)
        if self._dev < 0:
            return env_step_ref(self.cfg, self.statics, state, action, q)
        refuse_grad("env_step", *state, action, *q, *self.statics.values())
        o = self.carve(self.buffers())
        err = _lib().env_step_launch(self._cfg, self._table, self.B,
                                     int(self.faulty),
                                     KB.raw_stream(self._dev))
        if err != 0:
            raise RuntimeError(
                f"env_step kernel launch failed: CUDA error {err}")
        env_step.launches += 1
        return (EV.EnvState(*o[:12]), EV.QueueView(*o[12:15]), o[15], o[16],
                o[17])


def env_step(cfg: EV.EnvConfig, statics: Dict, state: EV.EnvState, action,
             q: EV.QueueView):
    """One fused decision for B envs: (state', queue', obs', reward, done),
    through an `EnvStepPlan` built for this one call."""
    return EnvStepPlan(cfg, statics, action.shape[0], action.device)(
        state, action, q)


env_step.launches = 0
