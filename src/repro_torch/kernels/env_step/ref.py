"""Plain PyTorch version of the fused env decision step, batched over B.

One call advances every env by one decision and also returns the next
visible-queue view and observation, so a rollout costs one queue pass per
decision. It is the env's own batched transition (`core.env`) followed by
`visible_queue` (a stable sort) and `observe_from`: the oracle of the CUDA
kernel and the path the kernel's wrapper takes for CPU tensors.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import env as EV


def env_step_ref(cfg: EV.EnvConfig, statics: Dict, state: EV.EnvState,
                 action, q: EV.QueueView):
    """(state', queue', obs' (B, 3, E+l), reward (B,), done (B,))."""
    new_state, reward, done, _ = EV._decide(cfg, statics, state, action, q)
    q2 = EV.visible_queue(cfg, statics, new_state)
    obs = EV.observe_from(cfg, statics, new_state, q2)
    return new_state, q2, obs, reward, done
