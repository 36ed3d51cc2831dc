"""Entry point of the fused batched env decision step.

`impl="auto"` dispatches by the tensors' device: the CUDA kernel for CUDA
tensors (it launches or raises; there is no fallback), the plain PyTorch
version for CPU tensors. `impl="ref"` takes the plain version on any device,
which is how the kernel is held against it on the card.
"""
from __future__ import annotations

from repro_torch.core import env as EV
from repro_torch.kernels.env_step.kernel import env_step
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
