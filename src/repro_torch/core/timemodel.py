"""Latency model calibrated to the paper's Table VI (port of
`repro/core/timemodel.py`; the tables are copied, not imported).

| patches | init time (s) | time per inference step (s) |
|   1     |     33.5      |            0.53             |
|   2     |     31.9      |            0.29             |
|   4     |     35.0      |            0.20             |
|   8     |     36.0      |            0.135 (extrapolated from Table I) |

Each service scales these by its per-step FLOP ratio (`model_scale`).
"""
from __future__ import annotations

import torch

# indexed by log2(patches): 1, 2, 4, 8
INIT_TIME = torch.tensor([33.5, 31.9, 35.0, 36.0], dtype=torch.float32)
STEP_TIME = torch.tensor([0.53, 0.29, 0.20, 0.135], dtype=torch.float32)


def _log2i(c: torch.Tensor) -> torch.Tensor:
    """c in {1, 2, 4, 8} -> {0, 1, 2, 3} (int64, usable as an index)."""
    return torch.round(torch.log2(torch.clamp(c, min=1).to(torch.float32))
                       ).to(torch.int64)


def init_time(c: torch.Tensor, model_scale=1.0) -> torch.Tensor:
    """Model (re)initialisation latency for a c-patch gang."""
    return INIT_TIME.to(c.device)[_log2i(c)] * model_scale


def exec_time(c: torch.Tensor, steps: torch.Tensor, model_scale=1.0):
    """Inference latency for `steps` diffusion steps on a c-patch gang."""
    return (STEP_TIME.to(c.device)[_log2i(c)] * steps.to(torch.float32)
            * model_scale)
