"""AIGC task workload generation (paper §IV.A.1; port of
`repro/core/workload.py`).

c_k ~ D_c over {1, 2, 4, 8} (clipped to the cluster size) and exponential
inter-arrival gaps at the paper's per-cluster rates. A trace is a dict of
(B, K) tensors. Draws come from a `torch.Generator`; `trace_from_draws`
builds the same trace from draws the caller supplies (the reference's
threefry bits and torch's Philox never agree, so parity tests hand the
same draws to both sides).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device


@dataclass(frozen=True)
class TraceConfig:
    num_tasks: int = 32
    arrival_rate: float = 0.1            # tasks / second (lambda of D_g)
    c_support: Tuple[int, ...] = (1, 2, 4, 8)
    c_probs: Tuple[float, ...] = (0.35, 0.35, 0.2, 0.1)
    num_models: int = 1                  # distinct AIGC services (arch ids)
    max_servers: int = 8                 # c_k is clipped to the cluster size
    quality_noise: float = 0.004         # per-task CLIP-score jitter
    # per-model popularity; () draws models uniformly. Shorter tuples pad
    # with zero, longer ones truncate; renormalised either way.
    model_probs: Tuple[float, ...] = ()


def trace_from_draws(tc: TraceConfig, gaps: torch.Tensor, c: torch.Tensor,
                     model: torch.Tensor, noise: torch.Tensor) -> Dict:
    """Trace dict from raw draws, each (..., K): `gaps` unit-rate
    exponential, `c` patch counts, `model` service ids, `noise` standard
    normal."""
    arr = torch.cumsum(gaps.to(torch.float32) / tc.arrival_rate, dim=-1)
    return {"arr_time": arr, "c": c.to(torch.int32),
            "model": model.to(torch.int32),
            "noise": (tc.quality_noise * noise.to(torch.float32))}


def sample_task_attrs(tc: TraceConfig, shape, *, generator=None,
                      device=None):
    """(c, model, noise) tensors of `shape` from the TraceConfig marginals,
    for tasks whose arrival times come from elsewhere (an arrival process).
    Drawn from `generator` in that order: the patch-count category, the
    model id, the standard normal (scaled here by `quality_noise`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    shape = tuple(shape)
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    support = torch.tensor(tc.c_support, dtype=torch.int32, device=dev)
    probs = torch.tensor(tc.c_probs, dtype=torch.float32, device=dev)
    probs = torch.where(support <= tc.max_servers, probs, 0.0)
    ci = torch.multinomial(probs.expand(rows, -1), n, replacement=True,
                           generator=gen).reshape(shape)
    if tc.model_probs:
        k = min(len(tc.model_probs), tc.num_models)
        mp = torch.zeros((tc.num_models,), dtype=torch.float32, device=dev)
        mp[:k] = torch.tensor(tc.model_probs[:k], dtype=torch.float32)
        model = torch.multinomial(mp.expand(rows, -1), n, replacement=True,
                                  generator=gen).reshape(shape)
    else:
        model = torch.randint(0, tc.num_models, shape, generator=gen,
                              device=dev)
    noise = torch.randn(shape, generator=gen, device=dev)
    return (support[ci], model.to(torch.int32),
            tc.quality_noise * noise)


def make_trace_from_arrivals(arr_times: torch.Tensor, tc: TraceConfig, *,
                             generator=None, attrs=None) -> Dict:
    """Trace dict for given absolute arrival times (..., K). The task
    attributes are `attrs` = (c, model, noise) when given (noise already
    scaled, as `sample_task_attrs` returns it), else drawn from
    `generator`."""
    if attrs is None:
        attrs = sample_task_attrs(tc, arr_times.shape, generator=generator,
                                  device=arr_times.device)
    c, model, noise = attrs
    return {"arr_time": arr_times.to(torch.float32), "c": c.to(torch.int32),
            "model": model.to(torch.int32),
            "noise": noise.to(torch.float32)}


def make_trace_batch(tc: TraceConfig, batch: int, *, generator=None,
                     device=None) -> Dict:
    """Batch of traces as one dict of (B, K) tensors (for `batch_rollout`):
    the unit exponential gaps, then `sample_task_attrs`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    shape = (batch, tc.num_tasks)
    gaps = torch.empty(shape, device=dev).exponential_(generator=gen)
    attrs = sample_task_attrs(tc, shape, generator=gen, device=dev)
    return make_trace_from_arrivals(torch.cumsum(gaps / tc.arrival_rate,
                                                 dim=-1), tc, attrs=attrs)


def stack_traces(traces) -> Dict:
    """Stack a list of trace dicts along a new leading batch axis."""
    return {k: torch.stack([t[k] for t in traces]) for k in traces[0]}


def make_trace(tc: TraceConfig, *, generator=None, device=None) -> Dict:
    """One trace: dict of (K,) tensors arr_time, c, model, noise."""
    return {k: v[0] for k, v in make_trace_batch(
        tc, 1, generator=generator, device=device).items()}


def paper_rate_for(num_servers: int) -> float:
    """Arrival rates used in the paper's experiments (§VI.A.2)."""
    return {4: 0.05, 8: 0.1, 12: 0.15}.get(num_servers, 0.0125 * num_servers)
