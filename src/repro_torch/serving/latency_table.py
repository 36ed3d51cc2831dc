"""Per-architecture latency scales for the scheduler (port of
`repro/serving/latency_table.py`).

The paper measures Stable-Diffusion wall-clock per inference step (Table VI).
When the scheduler manages the 10 assigned architectures as distinct AIGC
services, each service's per-step and init times scale with its active
parameter count (decode FLOPs ~ 2 N_active) relative to the SD-v1.4
reference (~860M UNet params). These scales feed EnvConfig.model_scale in
multi-service mode.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.common.config import ASSIGNED_ARCHS, get_config

SD_V14_PARAMS = 860e6          # reference service (paper's Table VI)


def arch_scales() -> Dict[str, float]:
    out = {}
    for name in ASSIGNED_ARCHS:
        cfg = get_config(name)
        out[name] = cfg.param_count(active_only=True) / SD_V14_PARAMS
    return out


def env_model_scales(clip: Tuple[float, float] = (0.25, 8.0)) -> Tuple[float, ...]:
    """Clipped scales in ASSIGNED_ARCHS order (extremes clipped so episode
    horizons stay comparable to the paper's)."""
    s = arch_scales()
    lo, hi = clip
    return tuple(min(hi, max(lo, s[n])) for n in ASSIGNED_ARCHS)
