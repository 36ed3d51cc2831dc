"""The actor layer: rollout-protocol policies, the diffusion samplers and
the `ActorProgram` that owns a policy's decision (its CUDA graphs on the
card)."""
from repro_torch.actors.policies import actor_policy, init_student
from repro_torch.actors.program import ActorProgram, actor_program
from repro_torch.actors.samplers import (chain_sample, ddim_coeffs, ddim_taus,
                                         ddpm_coeffs, distilled_sample,
                                         normalize_sampler, parse_sampler)

__all__ = [
    "ActorProgram", "actor_program",
    "actor_policy", "init_student",
    "parse_sampler", "normalize_sampler",
    "ddpm_coeffs", "ddim_coeffs", "ddim_taus",
    "chain_sample", "distilled_sample",
]
