"""The disabled tracer (port of `repro/telemetry/trace.py`, `NullTracer`
and `NULL_TRACER` only). The serving executor takes a `tracer=` and opens
its prefill and decode spans on it; the recording `Tracer` is ROADMAP
Queue 1 item 11."""
from __future__ import annotations

from typing import Optional


class _NullSpan:
    """No-op context manager shared by every disabled call site."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a constant-time no-op."""
    enabled = False
    config = None

    def span(self, name: str, cat: str = "phase", **args):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "phase", **args) -> None:
        pass

    def counter(self, name: str, value: float, **args) -> None:
        pass

    def write(self) -> Optional[str]:
        return None


NULL_TRACER = NullTracer()
