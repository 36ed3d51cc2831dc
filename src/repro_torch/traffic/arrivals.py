"""Open-loop arrival processes (port of `repro/traffic/arrivals.py`).

Every process is a frozen dataclass with a small state protocol, batched
over B independent streams:

    state = proc.init(B, generator=..., device=...)   # dict of (B,) tensors
    state, gaps = proc.sample(state, n, generator=...)  # gaps (B, n), seconds
    proc.mean_rate()                                   # long-run tasks/second

Each arrival takes a fixed set of draws: one unit exponential (Poisson and
the rate-modulated processes), plus a switch flag and a jump for MMPP.
`sample` draws them from `generator` in bulk (exponentials, then flags,
then jumps), or takes them as tensors (`draws=`), which is how the parity
tests hand the reference's draws to both sides. Gaps compose into arrival
times by cumsum on the caller's clock.

The library covers the paper's fixed-rate exponential (§IV.A.1),
Markov-modulated bursts (arXiv 2405.08328), a diurnal sinusoid and periodic
flash crowds (arXiv 2411.01458), and replay of recorded arrival times.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def _exp(draws, shape, generator, device):
    if draws is not None:
        return draws["exp"].to(device=device, dtype=torch.float32)
    return torch.empty(shape, device=device).exponential_(generator=generator)


def _batch(state) -> Tuple[int, torch.device]:
    t = next(iter(state.values()))
    return t.shape[0], t.device


@dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson: i.i.d. exponential gaps (the paper's D_g). Its
    state only carries the stream count and device."""
    rate: float = 0.1

    def init(self, batch: int = 1, *, generator=None, device=None,
             draws=None) -> Dict:
        return {"t": torch.zeros((batch,), device=resolve_device(device))}

    def sample(self, state, n: int, *, generator=None, draws=None):
        B, dev = _batch(state)
        return state, _exp(draws, (B, n), generator, dev) / self.rate

    def mean_rate(self) -> float:
        return self.rate


@dataclass(frozen=True)
class MMPPArrivals:
    """Markov-modulated Poisson (bursty): each gap is exponential at the
    current phase's rate; after every arrival the phase jumps to a
    uniformly random other phase with probability `switch`, so the
    long-run rate is the harmonic mean of the phase rates. Draws per
    arrival: an exponential, a switch flag and a jump in [1, P)."""
    rates: Tuple[float, ...] = (0.02, 0.3)
    switch: float = 0.05

    def init(self, batch: int = 1, *, generator=None, device=None,
             draws=None) -> Dict:
        dev = resolve_device(device)
        if draws is not None:
            phase = draws["phase"].to(device=dev, dtype=torch.int64)
        else:
            phase = torch.randint(0, len(self.rates), (batch,),
                                  generator=generator, device=dev)
        return {"phase": phase}

    def sample(self, state, n: int, *, generator=None, draws=None):
        B, dev = _batch(state)
        P = len(self.rates)
        rates = torch.tensor(self.rates, dtype=torch.float32, device=dev)
        exp = _exp(draws, (B, n), generator, dev)
        if draws is not None:
            flip = draws["switch"].to(device=dev, dtype=torch.bool)
            jump = draws["jump"].to(device=dev, dtype=torch.int64)
        else:
            flip = torch.rand((B, n), generator=generator,
                              device=dev) < self.switch
            jump = torch.randint(1, max(P, 2), (B, n), generator=generator,
                                 device=dev)
        ph, gaps = state["phase"], []
        for i in range(n):
            gaps.append(exp[:, i] / rates[ph])
            ph = torch.where(flip[:, i], (ph + jump[:, i]) % P, ph)
        return {"phase": ph}, torch.stack(gaps, dim=1)

    def mean_rate(self) -> float:
        return len(self.rates) / sum(1.0 / r for r in self.rates)


@dataclass(frozen=True)
class _RateModulated:
    """Time-varying intensity lambda(t): each gap is exponential at the
    intensity at the current arrival clock (an NHPP approximation while
    gaps are short against the modulation period). State: the clock."""

    def rate_at(self, t):
        raise NotImplementedError

    def init(self, batch: int = 1, *, generator=None, device=None,
             draws=None) -> Dict:
        return {"t": torch.zeros((batch,), device=resolve_device(device))}

    def sample(self, state, n: int, *, generator=None, draws=None):
        B, dev = _batch(state)
        exp = _exp(draws, (B, n), generator, dev)
        t, gaps = state["t"], []
        for i in range(n):
            gap = exp[:, i] / torch.clamp(self.rate_at(t), min=1e-6)
            t = t + gap
            gaps.append(gap)
        return {"t": t}, torch.stack(gaps, dim=1)


@dataclass(frozen=True)
class DiurnalArrivals(_RateModulated):
    """Sinusoidal day/night demand:
    lambda(t) = base (1 + amp sin(2 pi t / period))."""
    base_rate: float = 0.1
    amplitude: float = 0.6
    period: float = 2000.0

    def rate_at(self, t):
        return self.base_rate * (1.0 + self.amplitude * torch.sin(
            2.0 * math.pi * t / self.period))

    def mean_rate(self) -> float:
        return self.base_rate


@dataclass(frozen=True)
class FlashCrowdArrivals(_RateModulated):
    """Periodic flash crowds: baseline rate with a spike of `spike_rate`
    lasting `spike_duration` seconds at the start of every `period`."""
    base_rate: float = 0.05
    spike_rate: float = 0.5
    period: float = 2000.0
    spike_duration: float = 200.0

    def rate_at(self, t):
        # the clock is never negative, so fmod is the reference's mod
        in_spike = torch.fmod(t, self.period) < self.spike_duration
        return torch.where(in_spike, self.spike_rate, self.base_rate)

    def mean_rate(self) -> float:
        duty = self.spike_duration / self.period
        return self.spike_rate * duty + self.base_rate * (1.0 - duty)


@dataclass(frozen=True, eq=False)
class ReplayArrivals:
    """Replay absolute arrival times from an array; wraps around with a
    period of (last arrival + one mean gap), so the stream is unbounded.

    Every stream replays from index 0 unless `stagger`, when `init` draws a
    start index per stream. eq=False keeps it hashable by identity despite
    the array field."""
    times: Any = ()
    stagger: bool = False

    def _arr_span(self, device):
        arr = torch.as_tensor(np.asarray(self.times, np.float32),
                              device=device)
        N = arr.shape[0]
        return arr, arr[-1] * (N + 1) / N

    def init(self, batch: int = 1, *, generator=None, device=None,
             draws=None) -> Dict:
        dev = resolve_device(device)
        if not self.stagger:
            return {"idx": torch.zeros((batch,), dtype=torch.int64,
                                       device=dev),
                    "last": torch.zeros((batch,), device=dev)}
        arr, _ = self._arr_span(dev)
        if draws is not None:
            idx = draws["idx"].to(device=dev, dtype=torch.int64)
        else:
            idx = torch.randint(0, arr.shape[0], (batch,),
                                generator=generator, device=dev)
        # the wrapped predecessor of arr[idx], so the first gap matches a
        # replay from zero at that point
        prev = torch.where(idx > 0, arr[torch.clamp(idx - 1, min=0)], 0.0)
        return {"idx": idx, "last": prev}

    def sample(self, state, n: int, *, generator=None, draws=None):
        idx0, last = state["idx"], state["last"]
        arr, span = self._arr_span(idx0.device)
        N = arr.shape[0]
        i = idx0[:, None] + torch.arange(n, device=idx0.device)
        t = arr[i % N] + (i // N).to(torch.float32) * span
        gaps = torch.diff(torch.cat([last[:, None], t], dim=1), dim=1)
        return {"idx": idx0 + n, "last": t[:, -1]}, gaps

    def mean_rate(self) -> float:
        arr = np.asarray(self.times, np.float32)
        span = float(arr[-1]) * (len(arr) + 1) / len(arr)
        return len(arr) / span


# ----------------------------------------------------------------------
_KINDS = {
    "poisson": PoissonArrivals,
    "mmpp": MMPPArrivals,
    "diurnal": DiurnalArrivals,
    "flash": FlashCrowdArrivals,
    "replay": ReplayArrivals,
}


def make_process(kind: str, **kwargs):
    """Registry constructor: make_process("mmpp", rates=(0.02, 0.3))."""
    if kind not in _KINDS:
        raise ValueError(f"unknown arrival process {kind!r}; "
                         f"choose from {sorted(_KINDS)}")
    return _KINDS[kind](**kwargs)


def scale_rate(proc, factor: float):
    """Scale a process's arrival intensity by `factor` (> 1 offers more
    load than the cluster drains). Replay has no free intensity and cannot
    be scaled."""
    if factor == 1.0:
        return proc
    if factor <= 0.0:
        raise ValueError(f"rate factor must be positive, got {factor}")
    if isinstance(proc, PoissonArrivals):
        return replace(proc, rate=proc.rate * factor)
    if isinstance(proc, MMPPArrivals):
        return replace(proc, rates=tuple(r * factor for r in proc.rates))
    if isinstance(proc, DiurnalArrivals):
        return replace(proc, base_rate=proc.base_rate * factor)
    if isinstance(proc, FlashCrowdArrivals):
        return replace(proc, base_rate=proc.base_rate * factor,
                       spike_rate=proc.spike_rate * factor)
    raise ValueError(f"cannot rate-scale {type(proc).__name__}")


def generate_trace(proc, tc, batch: int = 1, n: Optional[int] = None, *,
                   generator=None, device=None) -> Dict:
    """B fixed-size traces (dict of (B, n) tensors, the
    `workload.make_trace_batch` schema) whose arrival times come from
    `proc` instead of the fixed-rate exponential: the process's init and
    sample draws, then the task attributes, all from `generator`."""
    from repro_torch.core.workload import make_trace_from_arrivals
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    n = int(n) if n else tc.num_tasks
    state = proc.init(batch, generator=gen, device=dev)
    _, gaps = proc.sample(state, n, generator=gen)
    return make_trace_from_arrivals(torch.cumsum(gaps, dim=1), tc,
                                    generator=gen)
