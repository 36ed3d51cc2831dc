"""Seeded, deterministic fault injection + the fault-tolerance policy
(port of `repro/faults`).

Front door: build a `FaultSpec` and hand it to ``StreamConfig(faults=...)``.
`FaultSpec.none()` — or leaving it None — is bitwise-identical to a
fault-free run: no arrays are attached, so the decision programs are
unchanged.
"""
from repro_torch.faults.inject import (ExecFaultInjector, ExecutorFault,
                                       ExecutorTimeout, InjectedExecutorError)
from repro_torch.faults.schedule import (FAULT_COLS, RETRY_COL, FaultTimeline,
                                         fault_horizon, retry_backoff)
from repro_torch.faults.spec import FaultSpec, faults_active

__all__ = [
    "FaultSpec", "faults_active", "FaultTimeline", "fault_horizon",
    "retry_backoff", "FAULT_COLS", "RETRY_COL", "ExecFaultInjector",
    "ExecutorFault", "ExecutorTimeout", "InjectedExecutorError",
]
