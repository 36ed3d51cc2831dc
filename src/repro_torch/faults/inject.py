"""The exceptions of the serving tolerance layer (port of
`repro/faults/inject.py`, the exception classes the executor raises; the
injector is ROADMAP Queue 1 item 9)."""
from __future__ import annotations


class ExecutorFault(Exception):
    """Base of the transient executor failures the serving layer retries."""


class ExecutorTimeout(ExecutorFault):
    """A generation attempt exceeded its wall-clock budget."""
