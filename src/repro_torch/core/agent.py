"""Actor and critic construction for EAT and its ablations (port of
`repro/core/agent.py`).

Variant table (paper §VI.A.3):
    EAT     = attention encoder + diffusion policy
    EAT-A   = mlp encoder       + diffusion policy   (no attention)
    EAT-D   = attention encoder + gaussian policy    (no diffusion)
    EAT-DA  = mlp encoder       + gaussian policy    (vanilla SAC)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import normal_init
from repro_torch.core import diffusion as DF
from repro_torch.core.env import EnvConfig
from repro_torch.core.networks import (attention_encode, init_mlp,
                                       make_encoder, mlp_apply, mlp_encode)
from repro_torch.models.layers import mish

VARIANTS = {
    "eat": ("attention", "diffusion"),
    "eat-a": ("mlp", "diffusion"),
    "eat-d": ("attention", "gaussian"),
    "eat-da": ("mlp", "gaussian"),
}


@dataclass(frozen=True)
class AgentConfig:
    variant: str = "eat"
    T: int = 10                   # diffusion denoising steps (Table VIII)
    hidden: int = 256
    d_attn: int = 32
    entropy_alpha: float = 0.05
    log_sigma_min: float = -5.0
    log_sigma_max: float = 1.0

    @property
    def encoder(self) -> str:
        return VARIANTS[self.variant][0]

    @property
    def policy(self) -> str:
        return VARIANTS[self.variant][1]


def init_actor(ecfg: EnvConfig, acfg: AgentConfig, *, generator=None,
               device=None) -> Dict:
    """Random actor params in the reference's layout, drawn from
    `generator` (a fresh default-seeded one when None)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    enc, _, feat_dim = make_encoder(acfg.encoder, ecfg.obs_shape, acfg.d_attn,
                                    generator=gen, device=dev)
    a_dim = ecfg.action_dim
    p = {"enc": enc,
         "sigma_head": {"w": normal_init(gen, (a_dim, a_dim), stddev=0.01,
                                         device=dev),
                        "b": torch.full((a_dim,), -2.0, device=dev)}}
    if acfg.policy == "diffusion":
        p["denoiser"] = DF.init_denoiser(a_dim, feat_dim, acfg.hidden,
                                         generator=gen, device=dev)
    else:
        p["mlp"] = init_mlp([feat_dim, acfg.hidden, acfg.hidden, a_dim],
                            generator=gen, device=dev)
    return p


def _encode(params, acfg: AgentConfig, obs):
    if acfg.encoder == "attention":
        return attention_encode(params["enc"], obs)
    return mlp_encode(params["enc"], obs)


def actor_mean(params, acfg: AgentConfig, ecfg: EnvConfig, sched, obs, *,
               generator=None, x_T=None, noises=None):
    """(action mean x_0 in [-1, 1], f_s). obs: (..., 3, E+l). The diffusion
    variants run the plain differentiable chain (`reverse_sample`)."""
    f_s = _encode(params, acfg, obs)
    if acfg.policy == "diffusion":
        return DF.reverse_sample(params["denoiser"], sched, f_s,
                                 ecfg.action_dim, generator=generator,
                                 x_T=x_T, noises=noises), f_s
    return torch.tanh(mlp_apply(params["mlp"], f_s, activation=mish)), f_s


def gaussian_head(params, acfg: AgentConfig, mean, *, generator=None,
                  deterministic: bool = False, eps=None):
    """Eq. 13: a = clip(mean + exp(log_sigma) eps, -1, 1) with the linear
    sigma head on the mean. eps is drawn from `generator` unless given.
    Returns (action, log_sigma)."""
    log_sigma = torch.clamp(
        mean @ params["sigma_head"]["w"] + params["sigma_head"]["b"],
        acfg.log_sigma_min, acfg.log_sigma_max)
    if deterministic:
        a = mean
    else:
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
        a = mean + torch.exp(log_sigma) * eps
    return torch.clamp(a, -1.0, 1.0), log_sigma


def actor_sample(params, acfg: AgentConfig, ecfg: EnvConfig, sched, obs, *,
                 generator=None, deterministic: bool = False, x_T=None,
                 noises=None, eps=None):
    """Sample an action (Eq. 13). Returns (action [-1,1], mean, log_sigma,
    entropy). Draws, unless given: x_T, the chain noises, then eps."""
    mean, _ = actor_mean(params, acfg, ecfg, sched, obs, generator=generator,
                         x_T=x_T, noises=noises)
    a, log_sigma = gaussian_head(params, acfg, mean, generator=generator,
                                 deterministic=deterministic, eps=eps)
    # Gaussian entropy (Eq. 14), no tanh correction (paper)
    entropy = 0.5 * torch.sum(math.log(2 * math.pi * math.e) + 2 * log_sigma,
                              dim=-1)
    return a, mean, log_sigma, entropy


def to_env_action(a):
    """[-1, 1] -> [0, 1] (the env's native action range)."""
    return (a + 1.0) * 0.5


# ----------------------------------------------------------------------
# critics (paper Table VII: 2 x 256 FC, Mish)
def init_critic(ecfg: EnvConfig, hidden: int = 256, *, generator=None,
                device=None) -> Dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    obs_dim = ecfg.obs_shape[0] * ecfg.obs_shape[1]
    return init_mlp([obs_dim + ecfg.action_dim, hidden, hidden, 1],
                    generator=gen, device=dev)


def critic_apply(params, obs, action):
    """Q(s, a): the flattened obs (..., 3, E+l) and the action (..., A)
    through the Mish MLP; returns (...)."""
    flat = obs.reshape(obs.shape[:-2] + (-1,))
    x = torch.cat([flat, action], dim=-1)
    return mlp_apply(params, x, activation=mish)[..., 0]
