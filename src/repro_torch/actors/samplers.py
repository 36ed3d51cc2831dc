"""Sampler family for the diffusion actor (port of
`repro/actors/samplers.py`).

* ``"ddpm"`` — the paper's full T-step reverse chain.
* ``"ddim:K"`` — deterministic DDIM (eta = 0) over K strided timesteps.
* ``"distilled"`` — a consistency-distilled student head: one
  denoiser-shaped MLP call per decision (`training.distill` trains it to
  regress the teacher's full-grid DDIM endpoint from the same x_T and f_s).

The two chains run through the affine chain of `kernels/denoiser` — step j:
x <- c_x[j] x + c_e[j] eps + c_n[j] noise_j — so they share one kernel and
differ only in the (K,) coefficient vectors built here. `chain_sample`
with the DDPM coefficients equals `diffusion.reverse_sample` on the same
draws. The student runs through the one-call `denoiser_step` kernel. Every
sampler draws x_T first, so teacher and student see the same x_T for the
same generator state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import diffusion as DF
from repro_torch.kernels.denoiser import ops as KOPS


def parse_sampler(sampler: Optional[str]) -> Tuple[str, Optional[int]]:
    """"ddpm" | "ddim:K" | "distilled" -> (kind, K). None means "ddpm"."""
    if sampler is None:
        return "ddpm", None
    s = str(sampler).strip().lower()
    if s in ("ddpm", "distilled"):
        return s, None
    if s.startswith("ddim:"):
        try:
            K = int(s.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"bad ddim sampler {sampler!r}: expected 'ddim:K' with "
                "integer K") from None
        if K < 1:
            raise ValueError(f"ddim step count must be >= 1, got {K}")
        return "ddim", K
    raise ValueError(f"unknown sampler {sampler!r}; choose 'ddpm', 'ddim:K' "
                     "or 'distilled'")


def normalize_sampler(sampler: Optional[str]) -> str:
    kind, K = parse_sampler(sampler)
    return f"ddim:{K}" if kind == "ddim" else kind


# ----------------------------------------------------------------------
# affine chain coefficients (step j of K denoises timestep index idx[j])
def ddpm_coeffs(sched: DF.DiffusionSchedule):
    """Full-chain DDPM posterior (Eq. 10/12) as affine coefficients.

    Returns (coef_x, coef_e, coef_n, t_in), each (T,), ordered j = 0..T-1
    over timestep indices i = T-1..0; `t_in = i + 1` feeds the timestep
    embedding."""
    T = sched.betas.shape[0]
    i = torch.arange(T - 1, -1, -1, device=sched.betas.device)
    beta, alpha, abar = sched.betas[i], sched.alphas[i], sched.alpha_bars[i]
    abar_prev = torch.where(
        i > 0, sched.alpha_bars[torch.clamp(i - 1, min=0)], 1.0)
    coef_x = 1.0 / torch.sqrt(alpha)
    coef_e = -(beta / torch.sqrt(1.0 - abar)) / torch.sqrt(alpha)
    var = beta * (1.0 - abar_prev) / (1.0 - abar)
    coef_n = torch.where(i > 0, torch.sqrt(torch.clamp(var, min=1e-12)), 0.0)
    return coef_x, coef_e, coef_n, i + 1


def ddim_taus(T: int, K: int) -> np.ndarray:
    """K strided timestep indices, descending T-1 .. 0 (evenly spaced with
    floor; strictly decreasing for K <= T)."""
    if not 1 <= K <= T:
        raise ValueError(f"ddim step count must be in [1, T={T}], got {K}")
    if K == 1:
        return np.array([T - 1], dtype=np.int64)
    return np.floor(np.linspace(T - 1, 0, K)).astype(np.int64)


def ddim_coeffs(sched: DF.DiffusionSchedule, K: int):
    """Deterministic DDIM (eta = 0) over the strided subset, in the affine
    form: x_prev = sqrt(abar_prev) x0_pred + sqrt(1 - abar_prev) eps with
    x0_pred = (x - sqrt(1 - abar) eps) / sqrt(abar). coef_n is 0; the last
    step uses abar_prev = 1."""
    dev = sched.betas.device
    T = int(sched.betas.shape[0])
    idx = ddim_taus(T, K)
    abar = sched.alpha_bars[torch.as_tensor(idx, device=dev)]
    nxt = torch.as_tensor(np.concatenate([idx[1:], [0]]), device=dev)
    abar_prev = torch.where(torch.arange(K, device=dev) < K - 1,
                            sched.alpha_bars[nxt], 1.0)
    sq_ab, sq_abp = torch.sqrt(abar), torch.sqrt(abar_prev)
    coef_x = sq_abp / sq_ab
    coef_e = torch.sqrt(1.0 - abar_prev) - sq_abp * torch.sqrt(1.0 - abar) / sq_ab
    coef_n = torch.zeros((K,), dtype=sched.betas.dtype, device=dev)
    return coef_x, coef_e, coef_n, torch.as_tensor(idx, device=dev) + 1


class ChainCoeffs(NamedTuple):
    """What the chain kernel needs besides the weights and the draws."""
    coef_x: torch.Tensor   # (K,)
    coef_e: torch.Tensor   # (K,)
    coef_n: torch.Tensor   # (K,)
    tembs: torch.Tensor    # (K, t_dim)


def chain_coeffs(sched: DF.DiffusionSchedule, kind: str = "ddpm",
                 K: Optional[int] = None, t_dim: int = 16) -> ChainCoeffs:
    if kind == "ddpm":
        cx, ce, cn, t_in = ddpm_coeffs(sched)
    elif kind == "ddim":
        if K is None:
            raise ValueError("kind='ddim' needs K")
        cx, ce, cn, t_in = ddim_coeffs(sched, K)
    else:
        raise ValueError(f"chain kind must be ddpm|ddim, got {kind!r}")
    return ChainCoeffs(cx.contiguous(), ce.contiguous(), cn.contiguous(),
                       DF.timestep_embedding(t_in, t_dim))


def chain_draws(kind: str, Ks: int, shape, *, generator=None, device=None,
                x_T=None, noises=None):
    """x_T (shape) and the per-step noises (Ks, *shape), drawn from
    `generator` in that order unless given. DDIM draws no noise (its coef_n
    is 0), so its noises are zeros."""
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=device)
    if noises is None:
        noises = (torch.randn((Ks,) + shape, generator=generator,
                              device=device) if kind == "ddpm"
                  else torch.zeros((Ks,) + shape, device=device))
    return x_T, noises


def chain_sample(denoiser_params, sched: DF.DiffusionSchedule, f_s,
                 action_dim: int, *, kind: str = "ddpm",
                 K: Optional[int] = None, generator=None, x_T=None,
                 noises=None, impl: str = "auto", t_dim: int = 16):
    """Action mean x_0 via the fused affine chain; drop-in for
    `diffusion.reverse_sample` with a selectable schedule. x_T (..., A) and
    the chain noises come from `chain_draws`."""
    c = chain_coeffs(sched, kind, K, t_dim)
    x, noises = chain_draws(kind, c.tembs.shape[0],
                            f_s.shape[:-1] + (action_dim,),
                            generator=generator, device=f_s.device, x_T=x_T,
                            noises=noises)
    return KOPS.denoise_chain(denoiser_params, x, noises, f_s, c.tembs,
                              c.coef_x, c.coef_e, c.coef_n, impl=impl)


@functools.lru_cache(maxsize=None)
def step_embedding(T: int, t_dim: int, device) -> torch.Tensor:
    """The timestep embedding of step T, (t_dim,), built once per (T,
    t_dim, device): the distilled sampler's input for every row of every
    decision. Callers must not write to it."""
    return DF.timestep_embedding(torch.tensor(T, device=device), t_dim)


def distilled_sample(student_params, f_s, action_dim: int, T: int, *,
                     generator=None, x_T=None, impl: str = "auto",
                     t_dim: int = 16):
    """One student forward: x_0 = student(x_T, T, f_s), tanh-bounded.

    x_T (..., A) is the sampler's first and only draw, from `generator`
    unless given: the x_T the teacher chain would have started from.
    `impl="auto"` runs the `denoiser_step` kernel on CUDA tensors and its
    plain version on CPU tensors, with T's embedding from
    `step_embedding` (one row for all, so a decision launches the kernel
    and nothing else for the student); `impl="ref"` runs
    `diffusion.denoise_eps` on any device."""
    shape = f_s.shape[:-1] + (action_dim,)
    x = (torch.randn(shape, generator=generator, device=f_s.device)
         if x_T is None else x_T)
    if impl == "ref":
        i = torch.full(f_s.shape[:-1], T, device=f_s.device)
        return DF.denoise_eps(student_params, x, i, f_s, t_dim)
    if impl != "auto":
        raise ValueError(f"impl must be auto|ref, got {impl!r}")
    return KOPS.denoise_eps_fused(student_params, x, None, f_s, t_dim,
                                  temb=step_embedding(T, t_dim, f_s.device))
