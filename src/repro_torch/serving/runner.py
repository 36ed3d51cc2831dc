"""Windowed streaming against the real serving engine (port of
`repro/serving/runner.py`).

`ServingStreamRunner` is `StreamRunner` with the serving execution backend
plugged into the `rollout_fn` seam: every window's decisions drive the one
physical pool (real weight loads, real patch-parallel prefill + decode),
while the backlog carry, `max_carry` shedding, seam ledger, and
`StreamAggregator` QoS rows are the simulated streaming machinery's. The
summary additionally carries the pool's economics (`model_loads` /
`model_reuses` / `tasks_executed`) and a `wall_clock` flag so downstream
tables can tell measured rows from modelled ones.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core import env as EV
from repro_torch.core.rollout import Transitions
from repro_torch.traffic.stream import StreamConfig, StreamResult, StreamRunner


class ServingStreamRunner(StreamRunner):
    """StreamRunner over a serving rollout fn (one physical cluster, B=1)."""

    def __init__(self, ecfg: EV.EnvConfig, policy, params, source,
                 generator=None, scfg: StreamConfig = StreamConfig(),
                 rollout_fn=None, tracer=None, device=None):
        if scfg.num_streams != 1:
            raise ValueError(
                "serving streams run ONE physical cluster; set "
                f"StreamConfig(num_streams=1), got {scfg.num_streams}")
        if rollout_fn is None:
            from repro_torch.serving.backend import ServingRollout
            rollout_fn = ServingRollout(ecfg.num_servers, device=device)
        if getattr(rollout_fn, "backend", None) != "serving":
            raise ValueError(
                "ServingStreamRunner needs a serving rollout fn (build one "
                "via repro_torch.api ExecSpec(backend='serving') or "
                "serving.backend.ServingRollout)")
        super().__init__(ecfg, policy, params, source, generator, scfg,
                         rollout_fn=rollout_fn, tracer=tracer, device=device)

    def result(self, transitions: Optional[List[Transitions]] = None
               ) -> StreamResult:
        res = super().result(transitions=transitions)
        stats = getattr(self.rollout_fn, "serving_stats", None)
        if stats is not None:
            res.summary.update(stats())
        res.summary["wall_clock"] = bool(getattr(self.rollout_fn,
                                                 "wall_clock", False))
        return res


def serve_stream(ecfg: EV.EnvConfig, policy, params, source, generator=None,
                 scfg: StreamConfig = StreamConfig(), rollout_fn=None,
                 collect: bool = False, tracer=None,
                 device=None) -> StreamResult:
    """Drive `scfg.num_windows` windows of real serving (`run_stream`'s
    serving twin; loops `ServingStreamRunner.run_window`)."""
    runner = ServingStreamRunner(ecfg, policy, params, source, generator,
                                 scfg, rollout_fn=rollout_fn, tracer=tracer,
                                 device=device)
    collected: Optional[List[Transitions]] = [] if collect else None
    for _ in range(scfg.num_windows):
        wres = runner.run_window(collect=collect)
        if collect:
            collected.append(wres.transitions)
    return runner.result(transitions=collected)
