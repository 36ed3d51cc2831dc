"""Diffusion policy (paper §V.B.2, Eqs. 10-13; port of
`repro/core/diffusion.py`).

A T-step DDPM over the action vector, conditioned on the state feature f_s.
The denoiser eps(x_i, i, f_s) is a Mish MLP with a 16-dim sinusoidal
timestep embedding. `reverse_sample` is the plain, differentiable chain kept
for training; rollouts compute the same mean through the affine-chain kernel
(`actors.samplers.chain_sample`). The VP-SDE schedule follows D2SAC:
beta_i = 1 - exp(-bmin/T - (bmax - bmin)(2i - 1)/(2T^2)).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.networks import init_mlp, mlp_apply
from repro_torch.models.layers import mish


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor        # (T,)
    alphas: torch.Tensor       # (T,)
    alpha_bars: torch.Tensor   # (T,)


def vp_schedule(T: int, beta_min: float = 0.1, beta_max: float = 10.0, *,
                device=None) -> DiffusionSchedule:
    """Built on the CPU and moved to `device`, so every device holds the
    same bits (on CUDA, dividing by a Python number multiplies by its
    reciprocal)."""
    dev = resolve_device(device)
    i = torch.arange(1, T + 1, dtype=torch.float32)
    betas = 1.0 - torch.exp(-beta_min / T - 0.5 * (beta_max - beta_min)
                            * (2 * i - 1) / T ** 2)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas=betas.to(dev), alphas=alphas.to(dev),
                             alpha_bars=torch.cumprod(alphas, dim=0).to(dev))


def timestep_embedding(i: torch.Tensor, dim: int = 16) -> torch.Tensor:
    """i: (...,) int -> (..., dim) sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(1000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=i.device) / half)
    ang = i[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_denoiser(action_dim: int, feat_dim: int, hidden: int = 256,
                  t_dim: int = 16, *, generator, device) -> Dict:
    return init_mlp([action_dim + t_dim + feat_dim, hidden, hidden,
                     action_dim], generator=generator, device=device)


def denoise_eps(p: Dict, x, i, f_s, t_dim: int = 16):
    """eps(x_i, i, f_s). x: (..., A); i: (...,); f_s: (..., F)."""
    inp = torch.cat([x, timestep_embedding(i, t_dim), f_s], dim=-1)
    return mlp_apply(p, inp, activation=mish, final_activation=torch.tanh)


def reverse_sample(p: Dict, sched: DiffusionSchedule, f_s, action_dim: int,
                   *, generator=None, x_T=None, noises=None):
    """The reverse chain x_T -> x_0 (Alg. 1 lines 5-11), differentiable
    w.r.t. p. f_s: (..., F). x_T (..., A) and the per-step noises
    (T, ..., A) are drawn from `generator`, in that order, unless given.
    Returns x_0 in [-1, 1]."""
    T = sched.betas.shape[0]
    shape = f_s.shape[:-1] + (action_dim,)
    x = torch.randn(shape, generator=generator, device=f_s.device) \
        if x_T is None else x_T
    if noises is None:
        noises = torch.randn((T,) + shape, generator=generator,
                             device=f_s.device)
    for step in range(T):
        i = T - 1 - step                       # i = T-1 .. 0 (0-indexed)
        beta, alpha = sched.betas[i], sched.alphas[i]
        abar = sched.alpha_bars[i]
        abar_prev = sched.alpha_bars[i - 1] if i > 0 else 1.0
        step_i = torch.full(f_s.shape[:-1], i + 1, device=f_s.device)
        eps = denoise_eps(p, x, step_i, f_s)
        mean = (x - beta / torch.sqrt(1.0 - abar) * eps) / torch.sqrt(alpha)
        var = beta * (1.0 - abar_prev) / (1.0 - abar)                # Eq. 10
        noise = noises[step] if i > 0 else torch.zeros_like(x)
        x = mean + torch.sqrt(torch.clamp(var, min=1e-12)) * noise   # Eq. 12
    return torch.tanh(x)


def bc_loss(p: Dict, sched: DiffusionSchedule, f_s, actions, *,
            generator=None, i=None, noise=None):
    """Behaviour-cloning denoising loss (optional regulariser, Diffusion-QL
    style): predict the noise added to real actions. The timestep indices
    i (...,) in [0, T) and the noise (..., A) are drawn from `generator`,
    in that order, unless given."""
    T = sched.betas.shape[0]
    if i is None:
        i = torch.randint(0, T, actions.shape[:-1], generator=generator,
                          device=actions.device)
    if noise is None:
        noise = torch.randn(actions.shape, generator=generator,
                            device=actions.device)
    abar = sched.alpha_bars[i.to(torch.int64)][..., None]
    x_i = torch.sqrt(abar) * actions + torch.sqrt(1 - abar) * noise
    eps = denoise_eps(p, x_i, i + 1, f_s)
    return torch.mean(torch.square(eps - noise))
