"""The Eq.-6 observation path (port of `repro/core/obs.py`), batched: every
tensor carries a leading (B,) env axis.

Scaling multiplies by reciprocals rounded to f32 once, as the reference
does, so the port and the reference round alike.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

#: large sentinel of the reference (`jnp.float32(1e30)`), not `inf`
INF = float(np.float32(1e30))


class QueueView(NamedTuple):
    """One per-decision visible-queue top-l, threaded through the rollout."""
    idx: torch.Tensor     # (B, l) i32 task ids, arrival order
    valid: torch.Tensor   # (B, l) bool slot holds a queued task
    queued: torch.Tensor  # (B, K) bool arrived & unscheduled


def server_down(trace: Dict, t: torch.Tensor) -> torch.Tensor:
    """(B, E) bool: server inside one of its down intervals at time t (B,)."""
    t3 = t[:, None, None]
    return ((trace["f_down_start"] <= t3) & (t3 < trace["f_down_end"])
            ).any(dim=-1)


def visible_queue(cfg, trace: Dict, state) -> QueueView:
    """The l earliest queued (arrived & unscheduled) tasks.

    `jax.lax.top_k` puts the lower index first among ties; a stable ascending
    sort of the priorities does the same (`torch.topk` is not stable)."""
    queued = (state.task_status == 0) & (trace["arr_time"] <= state.time[:, None])
    prio = torch.where(queued, trace["arr_time"], INF)
    vals, order = torch.sort(prio, dim=-1, stable=True)
    l = cfg.queue_window
    return QueueView(idx=order[:, :l].to(torch.int32), valid=vals[:, :l] < INF,
                     queued=queued)


def observe_from(cfg, trace: Dict, state, q: QueueView) -> torch.Tensor:
    """(B, 3, E + l) Eq.-6 state matrix from an already-computed queue view."""
    t = state.time[:, None]
    idx = q.idx.to(torch.int64)
    valid = q.valid
    inv_ts = 1.0 / cfg.time_scale
    inv_nm = 1.0 / max(cfg.num_models, 1)
    up = state.server_free_at <= t
    if "f_down_start" in trace:      # a down server is unavailable too
        up = up & ~server_down(trace, state.time)
    avail = up.to(torch.float32)
    remaining = torch.clamp(state.server_free_at - t, min=0.0) * inv_ts
    model = (state.server_model.to(torch.float32) + 1.0) * inv_nm
    arr_v = torch.gather(trace["arr_time"], 1, idx)
    c_v = torch.gather(trace["c"], 1, idx)
    wait = torch.where(valid, (t - arr_v) * inv_ts, 0.0)
    c = torch.where(valid, c_v.to(torch.float32) / 8.0, 0.0)
    if cfg.num_models > 1:
        m_v = torch.gather(trace["model"], 1, idx)
        mrow = torch.where(valid, (m_v.to(torch.float32) + 1.0) * inv_nm, 0.0)
    else:
        mrow = torch.zeros_like(c)   # paper zero-pads this row
    return torch.stack([torch.cat([avail, wait], dim=1),
                        torch.cat([remaining, c], dim=1),
                        torch.cat([model, mrow], dim=1)], dim=1)
