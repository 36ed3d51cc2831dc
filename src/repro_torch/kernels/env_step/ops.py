"""Entry point of the fused batched env decision step.

`impl="auto"` dispatches by the tensors' device: the CUDA kernel for CUDA
tensors (it launches or raises; there is no fallback), the plain PyTorch
version for CPU tensors. `impl="ref"` takes the plain version on any device,
which is how the kernel is held against it on the card.

`env_stepper` is the rollout's door: with `impl="auto"` it binds the step
to one rollout's constants once, as an `EnvStepPlan` (checked once; on the
card one pointer table reused by every decision, on the CPU the plain
version behind the same checks); with `impl="ref"` it is the plain
version.
"""
from __future__ import annotations

from repro_torch.core import env as EV
from repro_torch.kernels.env_step.kernel import EnvStepPlan, env_step
from repro_torch.kernels.env_step.ref import env_step_ref


def env_step_fused(ecfg: EV.EnvConfig, statics, state: EV.EnvState, action,
                   queue: EV.QueueView, *, impl: str = "auto"):
    """One fused decision for B envs. `statics` (`env.decision_statics`),
    `state`, `action` (B, A) and `queue` carry a leading (B,) axis.
    Returns (state', queue', obs', reward (B,), done (B,))."""
    if impl == "auto":
        return env_step(ecfg, statics, state, action, queue)
    if impl == "ref":
        return env_step_ref(ecfg, statics, state, action, queue)
    raise ValueError(f"impl must be auto|ref, got {impl!r}")


def env_stepper(ecfg: EV.EnvConfig, statics, B: int, device, *,
                impl: str = "auto"):
    """`step(state, action, queue)` for B envs on `device`, the statics
    bound once: an `EnvStepPlan` when `impl="auto"`, the plain version when
    `impl="ref"`. Returns what `env_step_fused` returns."""
    if impl == "auto":
        return EnvStepPlan(ecfg, statics, B, device)
    if impl != "ref":
        raise ValueError(f"impl must be auto|ref, got {impl!r}")

    def step(state, action, queue):
        return env_step_ref(ecfg, statics, state, action, queue)
    return step
