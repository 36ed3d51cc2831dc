"""`Simulator` — the single door to episodic and streaming simulation (port
of `repro/api/simulator.py`).

    from repro_torch import api

    sim = api.Simulator(
        api.WorkloadSpec.streaming(scenarios.bursty_traffic(8), streams=32,
                                   num_windows=50, window_tasks=64),
        api.ExecSpec(backend="fused"))
    result = sim.run(api.PolicySpec("eat", checkpoint="runs/eat"),
                     torch.Generator("cuda").manual_seed(0))
    result.summary["latency_p99"], result.trained

One Simulator = one workload x one execution backend; `run` takes any
registered policy (see `api.registry`) and returns a `SimResult` whose
`summary` is a flat scalar dict with the same core keys in both modes.
Policies resolve against the workload's env, offline meta-heuristics get
the workload's trace sampler to optimise on, and the execution backend
("reference" | "fused") is transparent: the same spec grid produces the
same numbers on either.

Generators. Where the reference splits and folds PRNG keys, the port
derives child generators by one rule, `split_generator(parent, n)`: n
draws of 63-bit seeds from the parent, in order, each seeding a fresh
`torch.Generator` on the Simulator's device. So:

* `run(policy, generator)` takes (data, rollout, profile) =
  `split_generator(generator, 3)`. Episodic: the B traces are one
  `make_scenario_trace_batch` on the data generator (the reference vmaps
  its trace sampler over B keys) and the rollout draws from the rollout
  generator. Streaming: the task source draws from the data generator
  and `run_stream` from the rollout generator. The decision-latency probe
  draws from the profile generator (the reference's `fold_in(key,
  0x9e77)`).
* `sweep(policies, generator)` runs policy i on child i of
  `split_generator(generator, len(policies))` (the reference's
  `fold_in(key, i)`).

An int in place of a generator seeds one on the device.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api import backends as BK
from repro_torch.api import registry as REG
from repro_torch.api.specs import ExecSpec, PolicySpec, WorkloadSpec
from repro_torch.common.device import resolve_device
from repro_torch.core.scenarios import (Scenario, make_scenario_trace,
                                        make_scenario_trace_batch)
from repro_torch.faults import FaultTimeline, fault_horizon, faults_active
from repro_torch.placement import placement_active
from repro_torch.telemetry import metrics as MET
from repro_torch.telemetry import profile as PROF
from repro_torch.telemetry.trace import torch_profile, tracer_for
from repro_torch.traffic.arrivals import PoissonArrivals
from repro_torch.traffic.stream import (ProcessTaskSource, StreamConfig,
                                        run_stream)

PolicyLike = Union[str, PolicySpec]
GeneratorLike = Union[int, torch.Generator]


def split_generator(generator: torch.Generator, n: int,
                    device=None) -> List[torch.Generator]:
    """n child generators on `device` (None: the parent's), each seeded by
    one 63-bit draw of `generator`, drawn in order: the port's
    `jax.random.split`."""
    dev = generator.device if device is None else torch.device(device)
    seeds = torch.randint(0, 2 ** 63 - 1, (n,), generator=generator,
                          dtype=torch.int64, device=generator.device)
    return [torch.Generator(device=dev).manual_seed(int(s))
            for s in seeds.tolist()]


def resolve_cell(sc: Scenario, window_tasks: Optional[int] = None):
    """(ecfg, tcfg, process) for streaming a scenario cell: `window_tasks`
    overrides the cell's episodic max_tasks; a missing arrival process means
    Poisson at the cell's configured rate."""
    ecfg, tcfg = sc.ecfg, sc.tcfg
    if window_tasks and window_tasks != ecfg.max_tasks:
        ecfg = dataclasses.replace(ecfg, max_tasks=int(window_tasks))
        tcfg = dataclasses.replace(tcfg, num_tasks=int(window_tasks))
    proc = sc.arrival if sc.arrival is not None else PoissonArrivals(
        tcfg.arrival_rate)
    return ecfg, tcfg, proc


@dataclass
class SimResult:
    policy: str
    trained: bool
    kind: str                    # baseline | learned | offline
    mode: str                    # episodic | streaming
    backend: str
    scenario: str
    summary: Dict[str, float]    # flat scalars (means / QoS aggregates)
    metrics: Dict[str, np.ndarray] = field(default_factory=dict)
    per_window: Optional[List[Dict]] = None       # streaming only
    wall_s: float = 0.0
    raw: Any = None              # RolloutResult | StreamResult

    def row(self) -> Dict[str, Any]:
        """Flat telemetry row (sweep/JSON schema)."""
        out = {"policy": self.policy, "trained": self.trained,
               "mode": self.mode, "exec_backend": self.backend,
               "cell": self.scenario, "wall_s": self.wall_s}
        out.update(self.summary)
        return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Simulator:
    """One workload x one execution backend; `run` any registered policy.
    Every tensor of a run lives on `device` (None: the CUDA device; raises
    without one)."""

    def __init__(self, workload: WorkloadSpec,
                 exec_spec: ExecSpec = ExecSpec(), *, device=None):
        self.workload = workload
        self.exec_spec = exec_spec
        self.scenario = workload.scenario
        self.device = resolve_device(device)
        if workload.mode == "streaming":
            self.ecfg, self.tcfg, self.process = resolve_cell(
                workload.scenario, workload.window_tasks)
        else:
            self.ecfg, self.tcfg = workload.scenario.ecfg, workload.scenario.tcfg
            self.process = workload.scenario.arrival
        if exec_spec.backend == "serving" and workload.batch != 1:
            raise ValueError(
                "serving backend runs ONE physical cluster; build the "
                "workload with batch/streams=1, got "
                f"{workload.batch}")
        if placement_active(exec_spec.placement) \
                and workload.mode != "streaming":
            raise ValueError(
                "placement is a streaming-only subsystem (the slow "
                "timescale acts at window seams); use mode='streaming' or "
                "drop ExecSpec.placement")
        self.tracer = tracer_for(exec_spec.trace)
        self._rollout = BK.rollout_fn_for(exec_spec)

    def _generator(self, generator: GeneratorLike) -> torch.Generator:
        if isinstance(generator, torch.Generator):
            return generator
        return torch.Generator(device=self.device).manual_seed(int(generator))

    # -- policy resolution against this workload's env ------------------
    def trace_fn(self):
        """Trace sampler of this workload's cell: `fn(generator)` -> one
        trace (dict of (K,) tensors on the device); offline schedulers
        optimise on it."""
        sc = dataclasses.replace(self.scenario, ecfg=self.ecfg,
                                 tcfg=self.tcfg)
        dev = self.device
        return lambda generator: make_scenario_trace(sc, generator=generator,
                                                     device=dev)

    def resolve(self, policy: PolicyLike) -> REG.ResolvedPolicy:
        return REG.resolve(policy, self.ecfg, trace_fn=self.trace_fn(),
                           device=self.device)

    # -- runs ------------------------------------------------------------
    def run(self, policy: PolicyLike, generator: GeneratorLike) -> SimResult:
        tcfg = self.exec_spec.trace
        g_data, g_run, g_prof = split_generator(self._generator(generator),
                                                3, self.device)
        with self.tracer.span(
                "run", cat="run", mode=self.workload.mode,
                backend=self.exec_spec.backend, cell=self.scenario.name):
            with self.tracer.span("resolve_policy", cat="run"):
                rp = self.resolve(policy)
            if hasattr(self._rollout, "reset"):
                self._rollout.reset()  # serving: fresh cluster per run, so
                #                        a sweep's policies never inherit a
                #                        warm pool from the previous policy
            t0 = time.perf_counter()
            with torch_profile(tcfg):
                if self.workload.mode == "episodic":
                    res = self._run_episodic(rp, g_data, g_run)
                else:
                    res = self._run_streaming(rp, g_data, g_run)
            res.wall_s = time.perf_counter() - t0
            if rp.meta.get("sampler"):
                res.summary["sampler"] = str(rp.meta["sampler"])
            if tcfg.enabled and tcfg.profile_decisions:
                with self.tracer.span("profile_decisions", cat="profile",
                                      policy=rp.name):
                    res.summary.update(PROF.profile_policy(
                        self.ecfg, rp.policy, rp.params, g_prof,
                        iters=tcfg.profile_iters, device=self.device))
        self._flush_telemetry()
        return res

    def _labels(self, rp: REG.ResolvedPolicy) -> Dict[str, str]:
        out = {"policy": rp.name, "backend": self.exec_spec.backend,
               "mode": self.workload.mode, "cell": self.scenario.name}
        if rp.meta.get("sampler"):        # diffusion actors: metric rows
            out["sampler"] = str(rp.meta["sampler"])   # split per sampler
        return out

    def _flush_telemetry(self) -> None:
        """Rewrite the trace file and (when configured) the metrics
        snapshots — called at every run end so a sweep's files are always
        consistent on disk."""
        self.tracer.write()
        tcfg = self.exec_spec.trace
        if tcfg.enabled and tcfg.metrics_path:
            reg = MET.default_registry()
            reg.write_prometheus(tcfg.metrics_path)
            reg.write_jsonl(tcfg.metrics_path + ".jsonl")

    def sweep(self, policies: Sequence[PolicyLike],
              generator: GeneratorLike) -> List[SimResult]:
        gens = split_generator(self._generator(generator), len(policies),
                               self.device)
        return [self.run(p, g) for p, g in zip(policies, gens)]

    def _attach_faults(self, traces, batch: int):
        """Merge window-0 fault columns into episodic traces (no-op when
        `ExecSpec.faults` is absent/inactive, keeping the decision program
        and results identical to a fault-free run)."""
        fspec = self.exec_spec.faults
        if not faults_active(fspec):
            return traces, None
        timeline = FaultTimeline(fspec, self.ecfg.num_servers, batch)
        fa = timeline.window_arrays(0, np.zeros(batch, np.float64),
                                    fault_horizon(self.ecfg.time_limit,
                                                  fspec))
        out = dict(traces)
        out.update({k: torch.from_numpy(v).to(self.device)
                    for k, v in fa.items()})
        return out, timeline

    def _run_episodic(self, rp: REG.ResolvedPolicy, g_data, g_run
                      ) -> SimResult:
        wl = self.workload
        sc = dataclasses.replace(self.scenario, ecfg=self.ecfg,
                                 tcfg=self.tcfg)
        traces = make_scenario_trace_batch(sc, wl.batch, generator=g_data,
                                           device=self.device)
        traces, timeline = self._attach_faults(traces, wl.batch)
        with self.tracer.span("episodic_rollout", cat="rollout",
                              policy=rp.name, batch=wl.batch):
            res = self._rollout(self.ecfg, traces, rp.policy, rp.params,
                                generator=g_run, num_steps=wl.num_steps,
                                collect=wl.collect, device=self.device)
            _sync(self.device)
        metrics = {k: v.cpu().numpy() for k, v in res.metrics.items()}
        summary = {f"mean_{k}": float(np.mean(v)) for k, v in metrics.items()}
        summary["n_episodes"] = wl.batch
        if self.exec_spec.backend == "serving":
            summary.update(self._rollout.serving_stats())
        MET.publish_summary(summary, prefix="eat_episodic",
                            labels=self._labels(rp))
        if timeline is not None:
            self._publish_faults(timeline.counters(), rp)
        return SimResult(policy=rp.name, trained=rp.trained, kind=rp.kind,
                         mode="episodic", backend=self.exec_spec.backend,
                         scenario=self.scenario.name, summary=summary,
                         metrics=metrics, raw=res)

    def _run_streaming(self, rp: REG.ResolvedPolicy, g_data, g_run
                       ) -> SimResult:
        wl = self.workload
        source = ProcessTaskSource(self.process, self.tcfg, g_data,
                                   num_streams=wl.batch,
                                   chunk_size=wl.chunk_size,
                                   device=self.device)
        scfg = StreamConfig(num_windows=wl.num_windows, num_streams=wl.batch,
                            max_steps_per_window=wl.max_steps_per_window,
                            max_carry=wl.max_carry, resp_sla=wl.resp_sla,
                            chunk_size=wl.chunk_size,
                            faults=self.exec_spec.faults,
                            placement=self.exec_spec.placement)
        res = run_stream(self.ecfg, rp.policy, rp.params, source, g_run,
                         scfg, rollout_fn=self._rollout, collect=wl.collect,
                         tracer=self.tracer, device=self.device)
        summary = dict(res.summary)
        summary["arrival"] = type(self.process).__name__
        summary["num_servers"] = self.ecfg.num_servers
        serving = self.exec_spec.backend == "serving"
        if serving:
            summary.update(self._rollout.serving_stats())
            summary["wall_clock"] = self.exec_spec.serving_wall_clock
        labels = self._labels(rp)
        res.aggregator.publish(labels=labels)
        if serving:
            ledger = self._rollout.pool_counters()
            MET.publish_counters(ledger, prefix="eat_serving", labels=labels)
            MET.publish_summary(
                {k: v for k, v in self._rollout.serving_stats().items()
                 if k not in ledger},
                prefix="eat_serving", labels=labels)
        fault_ledger = dict(res.fault_counters or {})
        if serving:
            fault_ledger.update(self._rollout.fault_counters())
        if fault_ledger:
            self._publish_faults(fault_ledger, rp)
        placement_ledger = dict(res.placement_counters or {})
        if placement_ledger:
            if serving:
                placement_ledger.update(self._rollout.placement_counters())
            self._publish_placement(placement_ledger, summary, rp)
        return SimResult(policy=rp.name, trained=rp.trained, kind=rp.kind,
                         mode="streaming", backend=self.exec_spec.backend,
                         scenario=self.scenario.name, summary=summary,
                         per_window=res.per_window, raw=res)

    def _publish_faults(self, ledger: Dict[str, int],
                        rp: REG.ResolvedPolicy) -> None:
        """Fault-injection ledger -> ``eat_fault_*`` counters in the unified
        registry (see docs/telemetry_schema.md)."""
        MET.publish_counters({k: int(v) for k, v in ledger.items()},
                             prefix="eat_fault", labels=self._labels(rp))

    def _publish_placement(self, ledger: Dict, summary: Dict[str, float],
                           rp: REG.ResolvedPolicy) -> None:
        """Placement ledger -> ``eat_placement_*`` metrics: the host
        counters, a warm-hit-rate gauge (the run's gang-reuse rate — what
        pre-warming buys), and per-model cold-start-rate gauges labelled
        ``{model=...}`` (see docs/telemetry_schema.md)."""
        labels = self._labels(rp)
        per_model = ledger.pop("per_model", {})
        MET.publish_counters(
            {k.removeprefix("placement_"): v for k, v in ledger.items()},
            prefix="eat_placement", labels=labels)
        reg = MET.default_registry()
        if "reuse_rate" in summary:
            reg.gauge("eat_placement_warm_hit_rate",
                      "gang-reuse rate of a placement-enabled run").set(
                float(summary["reuse_rate"]), labels=labels)
        g = reg.gauge("eat_placement_cold_start_rate",
                      "per-model reload fraction of scheduled tasks")
        for m, row in per_model.items():
            g.set(float(row["cold_start_rate"]),
                  labels={**labels, "model": str(m)})


# ----------------------------------------------------------------------
def evaluate_batch(ecfg, traces, policy, generator=None, *, params=None,
                   exec_spec: ExecSpec = ExecSpec(),
                   num_steps: Optional[int] = None,
                   device=None) -> Dict[str, np.ndarray]:
    """Facade door for evaluating *explicit* traces (the batched-evaluator
    use case): B traces (dict of (B, K) tensors) in one rollout on any
    backend, drawing from `generator`. `policy` is either a PolicySpec /
    registered name (resolved here; `params` ignored) or a raw rollout
    policy callable paired with `params`. Returns per-episode (B,) numpy
    metric arrays."""
    dev = resolve_device(device)
    if isinstance(policy, (str, PolicySpec)):
        rp = REG.resolve(policy, ecfg, device=dev)
        policy, params = rp.policy, rp.params
    if faults_active(exec_spec.faults):
        B = int(traces["arr_time"].shape[0])
        timeline = FaultTimeline(exec_spec.faults, ecfg.num_servers, B)
        traces = dict(traces)
        traces.update({k: torch.from_numpy(v) for k, v in
                       timeline.window_arrays(
                           0, np.zeros(B, np.float64),
                           fault_horizon(ecfg.time_limit,
                                         exec_spec.faults)).items()})
    res = BK.rollout_fn_for(exec_spec)(
        ecfg, traces, policy, {} if params is None else params,
        generator=generator, num_steps=num_steps, device=dev)
    return {k: v.cpu().numpy() for k, v in res.metrics.items()}
