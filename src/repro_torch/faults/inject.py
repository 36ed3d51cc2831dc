"""Serving-side fault injection + the exceptions the tolerance layer
catches (port of `repro/faults/inject.py`, a copy: numpy draws, so the same
spec and calls give the reference's sequence of failures).

`ExecFaultInjector` draws deterministic transient prefill/decode errors for
the serving executor (one seeded stream per injector, advanced once per
generation attempt in call order — the serving layer is single-threaded,
so the draw sequence is reproducible for a given run). The executor raises
`ExecutorTimeout` itself when a generation attempt exceeds its wall budget;
both exception types are *expected* failures a retry/degrade wrapper
handles — anything else propagates.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.faults.spec import FaultSpec


class ExecutorFault(Exception):
    """Base of the transient executor failures the serving layer retries."""


class InjectedExecutorError(ExecutorFault):
    """A deterministic injected transient error (fault-injection testing)."""


class ExecutorTimeout(ExecutorFault):
    """A generation attempt exceeded its wall-clock budget."""


class ExecFaultInjector:
    """Deterministic transient-error source for real executor attempts."""

    def __init__(self, spec: Optional[FaultSpec]):
        self.spec = spec
        self.errors_injected = 0
        self._reseed()

    def _reseed(self) -> None:
        seed = 0 if self.spec is None else self.spec.seed
        self._rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0xFFFFFFFF, 0xE33C]))

    def reset(self) -> None:
        """Back to the attempt-0 draw stream (fresh run)."""
        self.errors_injected = 0
        self._reseed()

    @property
    def enabled(self) -> bool:
        return self.spec is not None and self.spec.exec_error_prob > 0.0

    def maybe_fail(self, phase: str = "generate") -> None:
        """Advance the draw stream by one attempt; raise on an injected
        error. Called once per real generation attempt."""
        if not self.enabled:
            return
        if self._rng.random() < self.spec.exec_error_prob:
            self.errors_injected += 1
            raise InjectedExecutorError(
                f"injected transient {phase} error "
                f"(#{self.errors_injected}, p={self.spec.exec_error_prob})")

    def counters(self) -> Dict[str, int]:
        return {"exec_errors_injected": int(self.errors_injected)}
