"""Scenario grids for batched evaluation sweeps (port of
`repro/core/scenarios.py`).

The paper's tables (IX–XI) sweep cluster size {4, 8, 12} and arrival rate;
related work (arXiv 2405.08328, 2412.18212) adds multi-task and multi-rate
grids. A `Scenario` bundles the (EnvConfig, TraceConfig) pair of one cell
and, optionally, an open-loop arrival process; `run_scenario` evaluates B
traces of a cell in one fused `batch_rollout` (one program, and on the card
its decision graphs, per EnvConfig and policy), and `run_grid` sweeps a
list.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO
from repro_torch.core.workload import (TraceConfig, make_trace_batch,
                                       paper_rate_for)
from repro_torch.traffic.arrivals import (DiurnalArrivals, FlashCrowdArrivals,
                                          MMPPArrivals, PoissonArrivals,
                                          generate_trace)

# paper cluster configs: servers -> arrival-rate sweep (Tables IX-XI)
PAPER_RATE_GRID = {
    4: (0.01, 0.03, 0.05, 0.07, 0.09),
    8: (0.06, 0.08, 0.10, 0.12, 0.14),
    12: (0.11, 0.13, 0.15, 0.17, 0.19),
}


@dataclass(frozen=True)
class Scenario:
    name: str
    ecfg: EV.EnvConfig
    tcfg: TraceConfig
    # optional open-loop arrival process (`traffic.arrivals`); None means
    # the paper's fixed-rate exponential at tcfg.arrival_rate
    arrival: Optional[object] = None


def _make(name: str, num_servers: int, rate: float, *, num_tasks: int = 32,
          num_models: int = 1, model_scale: Tuple[float, ...] = (),
          c_support: Tuple[int, ...] = (1, 2, 4, 8),
          c_probs: Tuple[float, ...] = (0.35, 0.35, 0.2, 0.1),
          model_probs: Tuple[float, ...] = (), arrival=None) -> Scenario:
    ecfg = EV.EnvConfig(num_servers=num_servers, max_tasks=num_tasks,
                        num_models=num_models, model_scale=model_scale)
    tcfg = TraceConfig(num_tasks=num_tasks, arrival_rate=rate,
                       max_servers=num_servers, num_models=num_models,
                       c_support=c_support, c_probs=c_probs,
                       model_probs=model_probs)
    return Scenario(name=name, ecfg=ecfg, tcfg=tcfg, arrival=arrival)


def zipf_probs(n: int, a: float = 1.5) -> Tuple[float, ...]:
    """Zipf popularity over n models: p_k proportional to 1/(k+1)^a."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(a)
    return tuple(float(x) for x in w / w.sum())


def make_scenario_trace_batch(sc: Scenario, batch: int, *, generator=None,
                              device=None) -> Dict:
    """B traces of a scenario cell (dict of (B, K) tensors), honouring its
    arrival process."""
    if sc.arrival is None:
        return make_trace_batch(sc.tcfg, batch, generator=generator,
                                device=device)
    return generate_trace(sc.arrival, sc.tcfg, batch, generator=generator,
                          device=device)


def make_scenario_trace(sc: Scenario, *, generator=None, device=None) -> Dict:
    """One trace (dict of (K,) tensors) of a scenario cell."""
    return {k: v[0] for k, v in make_scenario_trace_batch(
        sc, 1, generator=generator, device=device).items()}


# ----------------------------------------------------------------------
def paper_scenarios() -> List[Scenario]:
    """The three paper clusters at their §VI.A.2 arrival rates."""
    return [_make(f"paper-{e}srv", e, paper_rate_for(e)) for e in (4, 8, 12)]


def arrival_sweep(num_servers: int = 8,
                  rates: Optional[Sequence[float]] = None) -> List[Scenario]:
    """One cluster size across the paper's rate sweep (Tables IX-XI)."""
    rates = tuple(rates) if rates is not None else PAPER_RATE_GRID[num_servers]
    return [_make(f"rate-{num_servers}srv-{r:.2f}", num_servers, r)
            for r in rates]


def multi_model_mix(num_servers: int = 8, num_models: int = 3,
                    model_scale: Tuple[float, ...] = (1.0, 0.6, 1.4)) -> Scenario:
    """Heterogeneous AIGC services with distinct per-step costs
    (multi-task edge serving, arXiv 2405.08328)."""
    return _make(f"multimodel-{num_models}x{num_servers}srv", num_servers,
                 paper_rate_for(num_servers), num_models=num_models,
                 model_scale=model_scale[:num_models])


def cold_start_heavy(num_servers: int = 8) -> Scenario:
    """Gang sizes skewed large: reuse is rare, so the scheduler pays the
    ~30 s model (re)init often (stresses reload_rate)."""
    return _make(f"coldstart-{num_servers}srv", num_servers,
                 paper_rate_for(num_servers),
                 c_probs=(0.05, 0.15, 0.35, 0.45))


def poisson_scenario(num_servers: int = 8,
                     rate: Optional[float] = None) -> Scenario:
    """Poisson arrivals at the paper rate (or `rate`): the reference point
    of the traffic cells."""
    r = paper_rate_for(num_servers) if rate is None else rate
    return _make(f"poisson-{num_servers}srv-{r:g}", num_servers, r)


def _mmpp_rates(base: float, factor: float) -> Tuple[float, float]:
    """(quiet, hot) phase rates in ratio factor^2 whose harmonic mean (the
    long-run MMPP rate under symmetric switching) equals `base`."""
    scale = (factor * factor + 1.0) / (2.0 * factor)
    return (scale * base / factor, scale * base * factor)


def bursty_traffic(num_servers: int = 8, *, burst_factor: float = 3.0,
                   switch: float = 0.05) -> Scenario:
    """Markov-modulated bursts at the paper's mean rate (arXiv
    2405.08328)."""
    base = paper_rate_for(num_servers)
    proc = MMPPArrivals(rates=_mmpp_rates(base, burst_factor), switch=switch)
    return _make(f"bursty-{num_servers}srv", num_servers, base, arrival=proc)


def diurnal_traffic(num_servers: int = 8, *, amplitude: float = 0.6,
                    period: float = 2000.0) -> Scenario:
    """Sinusoidal day/night demand around the paper rate (arXiv
    2411.01458)."""
    base = paper_rate_for(num_servers)
    proc = DiurnalArrivals(base_rate=base, amplitude=amplitude, period=period)
    return _make(f"diurnal-{num_servers}srv", num_servers, base, arrival=proc)


def flash_crowd(num_servers: int = 8, *, spike_factor: float = 8.0,
                period: float = 2000.0, spike_duration: float = 200.0) -> Scenario:
    """Baseline load with periodic flash-crowd spikes."""
    base = paper_rate_for(num_servers)
    proc = FlashCrowdArrivals(base_rate=base, spike_rate=base * spike_factor,
                              period=period, spike_duration=spike_duration)
    return _make(f"flashcrowd-{num_servers}srv", num_servers, base,
                 arrival=proc)


def model_skew(num_servers: int = 8, num_models: int = 3, *,
               zipf_a: float = 1.5,
               model_scale: Tuple[float, ...] = (1.0, 0.6, 1.4)) -> Scenario:
    """Zipf-skewed model popularity at the paper rate."""
    return _make(f"modelskew-{num_models}x{num_servers}srv", num_servers,
                 paper_rate_for(num_servers), num_models=num_models,
                 model_scale=model_scale[:num_models],
                 model_probs=zipf_probs(num_models, zipf_a))


def model_skew_flashcrowd(num_servers: int = 8, num_models: int = 3, *,
                          zipf_a: float = 1.5, spike_factor: float = 8.0,
                          period: float = 2000.0,
                          spike_duration: float = 200.0) -> Scenario:
    """Zipf popularity under flash-crowd arrival spikes."""
    base = paper_rate_for(num_servers)
    proc = FlashCrowdArrivals(base_rate=base, spike_rate=base * spike_factor,
                              period=period, spike_duration=spike_duration)
    return _make(f"modelskew-flashcrowd-{num_models}x{num_servers}srv",
                 num_servers, base, num_models=num_models,
                 model_probs=zipf_probs(num_models, zipf_a), arrival=proc)


def model_shift_cells(num_servers: int = 8, num_models: int = 3, *,
                      zipf_a: float = 1.5, spike_factor: float = 8.0):
    """Time-shifting popularity as a cell pair sharing one ecfg: a
    Zipf-skewed base cell, then a flash crowd on the reversed Zipf (the
    crowd lands on the previously coldest model)."""
    base = paper_rate_for(num_servers)
    probs = zipf_probs(num_models, zipf_a)
    hot = _make(f"modelshift-base-{num_models}x{num_servers}srv",
                num_servers, base, num_models=num_models, model_probs=probs,
                arrival=PoissonArrivals(base))
    cold = _make(f"modelshift-crowd-{num_models}x{num_servers}srv",
                 num_servers, base, num_models=num_models,
                 model_probs=tuple(reversed(probs)),
                 arrival=FlashCrowdArrivals(base_rate=base,
                                            spike_rate=base * spike_factor))
    return [hot, cold]


def traffic_grid(num_servers: int = 8) -> List[Scenario]:
    """The non-stationary arrival-process cells."""
    return [bursty_traffic(num_servers), diurnal_traffic(num_servers),
            flash_crowd(num_servers)]


def default_grid() -> List[Scenario]:
    return (paper_scenarios() + arrival_sweep(8)
            + [multi_model_mix(), cold_start_heavy()] + traffic_grid(8))


# ----------------------------------------------------------------------
def training_curriculum(ecfg: EV.EnvConfig, *,
                        rates: Optional[Sequence[float]] = None,
                        include_arrival_processes: bool = True) -> List[Scenario]:
    """Scenario cells for curriculum training: every cell shares `ecfg`
    (one program, and one set of graphs, serves them all) and varies the
    workload: the rate sweep, a cold-start-heavy gang mix, the bursty and
    flash-crowd arrival processes, and with several models the Zipf-skewed
    and shifted-popularity cells. `sac.train` and `ppo.train_ppo` sample
    one cell per collection round when given `curriculum=`."""
    base = paper_rate_for(ecfg.num_servers)
    rates = tuple(rates) if rates is not None else (0.5 * base, base,
                                                    1.5 * base)

    def tc(rate, **kw):
        return TraceConfig(num_tasks=ecfg.max_tasks, arrival_rate=rate,
                           max_servers=ecfg.num_servers,
                           num_models=ecfg.num_models, **kw)

    cells = [Scenario(name=f"rate-{r:.3f}", ecfg=ecfg, tcfg=tc(r))
             for r in rates]
    cells.append(Scenario(name="coldstart", ecfg=ecfg,
                          tcfg=tc(base, c_probs=(0.05, 0.15, 0.35, 0.45))))
    if include_arrival_processes:
        cells.append(Scenario(
            name="bursty", ecfg=ecfg, tcfg=tc(base),
            arrival=MMPPArrivals(rates=_mmpp_rates(base, 3.0))))
        cells.append(Scenario(
            name="flashcrowd", ecfg=ecfg, tcfg=tc(base),
            arrival=FlashCrowdArrivals(base_rate=base,
                                       spike_rate=base * 8.0)))
    if ecfg.num_models > 1:
        probs = zipf_probs(ecfg.num_models)
        cells.append(Scenario(name="modelskew", ecfg=ecfg,
                              tcfg=tc(base, model_probs=probs)))
        if include_arrival_processes:
            cells.append(Scenario(
                name="modelshift", ecfg=ecfg,
                tcfg=tc(base, model_probs=tuple(reversed(probs))),
                arrival=FlashCrowdArrivals(base_rate=base,
                                           spike_rate=base * 8.0)))
    return cells


def curriculum_picker(ecfg: EV.EnvConfig, curriculum: Sequence[Scenario]):
    """Check a curriculum against the training env and return
    pick(rng) -> (cell name, trace_fn(generator, B)), `rng` a numpy
    Generator. Every cell must share the training ecfg."""
    for sc in curriculum:
        if not isinstance(sc, Scenario):
            raise ValueError(f"curriculum cells must be core.scenarios."
                             f"Scenario objects, got {type(sc).__name__}")
        if sc.ecfg != ecfg:
            raise ValueError(
                f"curriculum cell {sc.name!r} has a different EnvConfig than "
                "the training env; build cells with "
                "scenarios.training_curriculum(ecfg)")

    def pick(rng):
        sc = curriculum[int(rng.integers(len(curriculum)))]
        return sc.name, (lambda gen, batch: make_scenario_trace_batch(
            sc, batch, generator=gen, device=gen.device))
    return pick


# ----------------------------------------------------------------------
def run_scenario(scenario: Scenario, policy, generator=None, *,
                 batch: int = 32, params=None, num_steps: Optional[int] = None,
                 traces: Optional[Dict] = None, device=None) -> Dict:
    """B fresh traces of one cell (or the given `traces`) through one
    fused batched rollout. Returns per-episode (B,) numpy arrays plus
    scalar mean_* summaries, the scenario's name and the batch."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    if traces is None:
        traces = make_scenario_trace_batch(scenario, batch, generator=gen,
                                           device=dev)
    batch = int(traces["arr_time"].shape[0])
    res = RO.batch_rollout(scenario.ecfg, traces, policy,
                           {} if params is None else params, generator=gen,
                           num_steps=num_steps, device=dev)
    out: Dict = {k: v.cpu().numpy() for k, v in res.metrics.items()}
    out.update({f"mean_{k}": float(np.mean(v)) for k, v in out.items()})
    out["scenario"] = scenario.name
    out["batch"] = batch
    return out


def run_grid(scenarios: Sequence[Scenario], policy_fn, generator=None, *,
             batch: int = 32, params=None, verbose: bool = False,
             device=None) -> List[Dict]:
    """Sweep a scenario list. `policy_fn(ecfg)` gives the rollout policy
    of a cell (e.g. `rollout.uniform_policy`, `rollout.greedy_policy`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    results = []
    for sc in scenarios:
        m = run_scenario(sc, policy_fn(sc.ecfg), gen, batch=batch,
                         params=params, device=dev)
        results.append(m)
        if verbose:
            print(f"[{sc.name:24s}] q={m['mean_avg_quality']:.3f} "
                  f"resp={m['mean_avg_response']:7.1f} "
                  f"reload={m['mean_reload_rate']:.3f} "
                  f"R={m['mean_episode_return']:7.1f}", flush=True)
    return results
