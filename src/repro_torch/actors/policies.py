"""The EAT actor as a rollout policy (port of `repro/actors/policies.py`,
samplers "ddpm", "ddim:K" and "distilled").

The chain samplers compute the action mean as `chain_sample` does, on
coefficients built once, so on the card every decision runs the
hand-written chain kernel (DDPM in its affine form equals
`reverse_sample`); "distilled" runs the student head `params["student"]`
through the one-call `denoiser_step` kernel; the Gaussian variants take the
MLP mean. The sigma head, exploration noise and clip are
`agent.actor_sample`'s tail (`agent.gaussian_head`).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.actors import samplers as SMP
from repro_torch.common.device import resolve_device
from repro_torch.core import agent as AG
from repro_torch.core import diffusion as DF
from repro_torch.core.env import EnvConfig
from repro_torch.kernels.denoiser import ops as KOPS


def actor_policy(ecfg: EnvConfig, acfg: AG.AgentConfig,
                 deterministic: bool = False, sampler: str = "ddpm", *,
                 device=None, impl: str = "auto"):
    """Rollout-protocol callable `policy(params, generator, traces, state,
    obs) -> (env action (B, A), {"agent_action": a})`.

    The schedule, chain coefficients and timestep embeddings are built once
    on `device`. Per decision the policy draws x_T, the DDPM chain noises
    and the exploration eps from the rollout's generator. `impl="ref"` runs
    the plain chain (or the plain student) on any device. "distilled" reads
    the student head from `params["student"]` (`init_student`,
    `training.distill.distill_actor`).

    Cached on its arguments (the sampler normalised, the device resolved),
    as the reference's factory is: the same arguments give the same
    callable, so its `actors.program.ActorProgram` and graphs are reused."""
    return _actor_policy(ecfg, acfg, bool(deterministic),
                         SMP.normalize_sampler(sampler),
                         resolve_device(device), impl)


@functools.lru_cache(maxsize=None)
def _actor_policy(ecfg: EnvConfig, acfg: AG.AgentConfig, deterministic: bool,
                  sampler: str, dev: torch.device, impl: str):
    kind, K = SMP.parse_sampler(sampler)
    if kind != "ddpm" and acfg.policy != "diffusion":
        raise ValueError(
            f"sampler {sampler!r} needs a diffusion actor; variant "
            f"{acfg.variant!r} is Gaussian — only 'ddpm' applies")
    sched = DF.vp_schedule(acfg.T, device=dev)
    coeffs = (SMP.chain_coeffs(sched, kind, K)
              if acfg.policy == "diffusion" and kind != "distilled" else None)

    def policy(params, generator, traces, state, obs):
        if kind == "distilled":
            f_s = AG._encode(params, acfg, obs)
            mean = SMP.distilled_sample(params["student"], f_s,
                                        ecfg.action_dim, acfg.T,
                                        generator=generator, impl=impl)
        elif coeffs is None:
            mean, _ = AG.actor_mean(params, acfg, ecfg, sched, obs)
        else:       # chain_sample on the prebuilt coefficients
            f_s = AG._encode(params, acfg, obs)
            shape = f_s.shape[:-1] + (ecfg.action_dim,)
            x_T, noises = SMP.chain_draws(kind, coeffs.tembs.shape[0], shape,
                                          generator=generator,
                                          device=f_s.device)
            mean = KOPS.denoise_chain(params["denoiser"], x_T, noises, f_s,
                                      coeffs.tembs, coeffs.coef_x,
                                      coeffs.coef_e, coeffs.coef_n, impl=impl)
        a, _ = AG.gaussian_head(params, acfg, mean, generator=generator,
                                deterministic=deterministic)
        return AG.to_env_action(a), {"agent_action": a}

    policy.sampler = sampler
    return policy


def init_student(ecfg: EnvConfig, acfg: AG.AgentConfig, *, generator=None,
                 device=None):
    """Fresh distilled-student head: denoiser-shaped (input concat(x, t_emb,
    f_s), tanh-bounded output), so it runs through the `denoiser_step`
    kernel unchanged."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    return DF.init_denoiser(ecfg.action_dim, ecfg.obs_shape[1], acfg.hidden,
                            generator=gen, device=dev)
