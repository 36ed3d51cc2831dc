"""Train in the stream: SAC/PPO learning from windowed streaming rollouts
(port of `repro/training/stream_train.py`).

The paper trains EAT on fixed-length episodes that reset the cluster every
K tasks; paper arrival rates *overload* the cluster in sustained streams —
the regime a deployed scheduler actually faces (arXiv 2412.18212,
2405.08328). Each training round advances one (or more) windows of an
open-loop arrival stream through the facade's execution backends with
`collect=True`, carries environment state across the window seam (clock
rebase, residual server occupancy, backlog carry + max_carry shedding —
`traffic.stream.StreamRunner`), pushes the window's valid transitions into
the replay buffer (SAC) or GAE pool (PPO), then runs gradient updates. The
policy therefore trains on the backlog distribution it *induces*, not on
fresh resets.

Execution is backend-transparent: `exec_spec` picks reference / fused /
serving (`api.backends`). Arrival curricula (`curriculum=` — Poisson /
MMPP bursts / diurnal / flash-crowd cells from
`core.scenarios.training_curriculum`) steer the traffic mix per round
through one continuous clock (`traffic.stream.CurriculumTaskSource`), and
every round logs streaming QoS telemetry (p95/p99 latency, drop-inclusive
violation rate, drop rate, goodput) alongside the usual training metrics.
The updates are the port's eager `sac.update_step` and `ppo.ppo_update`.

Generators: one `torch.Generator` seeded `seed` on the device feeds, in
order, the host rng (`sac.host_rng`), the network init, then
`api.simulator.split_generator(., 2)` — the task source's and the
runner's generators (the reference's `split(k_run)`) — and every later
update's draws.

    from repro_torch.training import stream_train as ST
    res = ST.train_stream_sac(ecfg, acfg, SACConfig(),
                              ST.StreamTrainConfig(rounds=32, streams=8,
                                                   rate_scale=2.0))
    res.state, res.history[-1]["latency_p99"], res.stream.summary
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import actors as ACT
from repro_torch.common.device import resolve_device
from repro_torch.core import agent as AG
from repro_torch.core import env as EV
from repro_torch.core import ppo as PPO
from repro_torch.core import sac as SAC
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.scenarios import Scenario
from repro_torch.core.workload import TraceConfig, paper_rate_for
from repro_torch.telemetry import metrics as MET
from repro_torch.telemetry.trace import tracer_for
from repro_torch.traffic import metrics as MX
from repro_torch.traffic.arrivals import PoissonArrivals, scale_rate
from repro_torch.traffic.stream import (CurriculumTaskSource, StreamConfig,
                                        StreamResult, StreamRunner)

# per-round QoS telemetry copied from the round aggregator into history rows
QOS_KEYS = ("latency_p50", "latency_p95", "latency_p99",
            "qos_violation_rate", "drop_rate", "goodput_per_s",
            "throughput_per_s", "utilization")


@dataclass(frozen=True)
class StreamTrainConfig:
    """Shape of a streaming training run (shared by SAC and PPO).

    One *round* = `windows_per_round` stream windows of K = ecfg.max_tasks
    tasks per stream, collected with the current policy, followed by
    gradient updates. `rate_scale` multiplies every cell's arrival
    intensity (`traffic.arrivals.scale_rate`) — > 1 trains under sustained
    overload. `max_updates_per_round` caps the gradient work per round
    (smoke tests / benches); None keeps the algorithm's own
    update/env-step ratio.
    """
    rounds: int = 32
    windows_per_round: int = 1
    streams: int = 4                      # B parallel streams
    rate_scale: float = 1.0
    max_steps_per_window: Optional[int] = None
    max_carry: Optional[int] = None
    resp_sla: float = 120.0
    chunk_size: int = 0
    max_updates_per_round: Optional[int] = None
    log_every: int = 0
    #: collection-time sampler for the SAC diffusion actor ("ddpm" — the
    #: default — or "ddim:K" for cheaper per-decision inference during
    #: collection; resolved through the shared actor layer). "distilled" is
    #: rejected: the student head does not exist in a TrainState
    #: mid-training.
    sampler: str = "ddpm"

    def __post_init__(self):
        if ACT.normalize_sampler(self.sampler) == "distilled":
            raise ValueError(
                "stream training collects with the online actor; "
                "sampler='distilled' needs a student head that only exists "
                "after training (use ddpm or ddim:K)")
        if self.rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {self.rounds}")
        if self.windows_per_round < 1:
            raise ValueError(f"windows_per_round must be >= 1, got "
                             f"{self.windows_per_round}")
        if self.streams < 1:
            raise ValueError(f"streams must be >= 1, got {self.streams}")
        if self.rate_scale <= 0.0:
            raise ValueError(f"rate_scale must be > 0, got "
                             f"{self.rate_scale}")


class StreamTrainResult(NamedTuple):
    state: Any                    # SAC.TrainState | PPO.PPOState
    history: List[Dict]           # one row per round (training + QoS)
    stream: StreamResult          # run-level QoS summary + final carry


# ----------------------------------------------------------------------
def resolve_cells(ecfg: EV.EnvConfig, scenario: Optional[Scenario],
                  curriculum: Optional[Sequence[Scenario]],
                  rate_scale: float = 1.0
                  ) -> List[Tuple[str, Any, TraceConfig]]:
    """Scenario cells -> [(name, arrival process, TraceConfig)] for the
    curriculum task source. Every cell must share the training `ecfg` (one
    decision program serves them all); a missing arrival process means
    Poisson at the cell's configured rate; `rate_scale` scales every
    process's intensity uniformly."""
    if curriculum and scenario:
        raise ValueError("pass either scenario= or curriculum=, not both")
    cells = list(curriculum) if curriculum else None
    if cells is None:
        sc = scenario
        if sc is None:
            base = paper_rate_for(ecfg.num_servers)
            sc = Scenario(
                name=f"poisson-{ecfg.num_servers}srv",
                ecfg=ecfg,
                tcfg=TraceConfig(num_tasks=ecfg.max_tasks, arrival_rate=base,
                                 max_servers=ecfg.num_servers,
                                 num_models=ecfg.num_models))
        cells = [sc]
    out = []
    for sc in cells:
        if sc.ecfg != ecfg:
            raise ValueError(
                f"cell {sc.name!r} has a different EnvConfig than the "
                "training env; build cells with "
                "scenarios.training_curriculum(ecfg)")
        tc = sc.tcfg
        if tc.num_tasks != ecfg.max_tasks:
            tc = dataclasses.replace(tc, num_tasks=ecfg.max_tasks)
        proc = sc.arrival if sc.arrival is not None else PoissonArrivals(
            tc.arrival_rate)
        out.append((sc.name, scale_rate(proc, rate_scale), tc))
    return out


def _make_runner(ecfg, cells, generator, stcfg: StreamTrainConfig,
                 exec_spec, policy, params, dev):
    from repro_torch.api.backends import rollout_fn_for
    from repro_torch.api.simulator import split_generator
    from repro_torch.api.specs import ExecSpec
    g_src, g_stream = split_generator(generator, 2, dev)
    source = CurriculumTaskSource([(proc, tc) for _, proc, tc in cells],
                                  g_src, num_streams=stcfg.streams,
                                  chunk_size=stcfg.chunk_size, device=dev)
    scfg = StreamConfig(
        num_windows=stcfg.rounds * stcfg.windows_per_round,
        num_streams=stcfg.streams,
        max_steps_per_window=stcfg.max_steps_per_window,
        max_carry=stcfg.max_carry, resp_sla=stcfg.resp_sla,
        chunk_size=stcfg.chunk_size,
        faults=getattr(exec_spec, "faults", None),
        placement=getattr(exec_spec, "placement", None))
    rollout = rollout_fn_for(exec_spec or ExecSpec())
    tracer = tracer_for(getattr(exec_spec, "trace", None))
    runner = StreamRunner(ecfg, policy, params, source, g_stream, scfg,
                          rollout_fn=rollout, tracer=tracer, device=dev)
    return source, runner


def _round_row(r: int, cell_name: str, ragg: MX.StreamAggregator,
               runner: StreamRunner, returns: List[float], n_new: int,
               n_upd: int) -> Dict:
    row = {"round": r, "cell": cell_name,
           "transitions": n_new, "updates": n_upd,
           "episode_return_mean": float(np.mean(returns)),
           "backlog": runner.backlog()}
    rs = ragg.summary()
    row.update({k: rs[k] for k in QOS_KEYS})
    return row


def _publish_round(row: Dict, algo: str) -> None:
    """Round row -> unified metrics registry gauges (eat_train_*); the
    registry snapshot is what `TraceConfig.metrics_path` exports."""
    MET.publish_summary(row, prefix="eat_train",
                        labels={"algo": algo, "cell": str(row["cell"])})


def _log_row(tag: str, row: Dict) -> None:
    print(f"[{tag} round {row['round']:4d}] cell={row['cell']:<12s} "
          f"R={row['episode_return_mean']:8.2f} "
          f"p99={row['latency_p99']:8.1f}s "
          f"viol={row['qos_violation_rate']:.3f} "
          f"drop={row['drop_rate']:.3f} backlog={row['backlog']:4d} "
          f"buf/pool={row.get('buffer_size', row['transitions']):6d}")


# ----------------------------------------------------------------------
def train_stream_sac(ecfg: EV.EnvConfig, acfg: AG.AgentConfig,
                     scfg: SAC.SACConfig,
                     stcfg: StreamTrainConfig = StreamTrainConfig(), *,
                     scenario: Optional[Scenario] = None,
                     curriculum: Optional[Sequence[Scenario]] = None,
                     seed: int = 0, exec_spec=None, callback=None,
                     transition_hook=None, device=None) -> StreamTrainResult:
    """SAC (paper Algorithm 2) trained from windowed streaming rollouts.

    Per round: pick a curriculum cell (host rng, `sac.host_rng`), advance
    `windows_per_round` stream windows with the current policy (uniform
    exploration until the buffer reaches `scfg.warmup_steps`, then the
    diffusion/Gaussian actor), push the valid transitions into the replay
    buffer, and run the per-step update schedule over the new experience.
    Backlog, clock, and server occupancy persist across rounds.

    Replay transitions keep the env's own done flag at the window's final
    step (the layout of episodic `collect_batch`), so the TD target treats
    the seam as terminal; the truncation bias this introduces is one
    bootstrap term per window, bounded by gamma and washed out by the
    off-policy buffer.

    `transition_hook(round_idx, flat)` (flat = the replay-layout arrays
    from `sac.flatten_valid_transitions`) observes every window's collected
    batch. Every tensor lives on `device` (None: the CUDA device).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    rng = SAC.host_rng(gen)
    ts = SAC.init_train_state(ecfg, acfg, generator=gen, device=dev)
    buffer = ReplayBuffer(scfg.buffer_capacity, ecfg.obs_shape,
                          ecfg.action_dim)
    cells = resolve_cells(ecfg, scenario, curriculum, stcfg.rate_scale)
    source, runner = _make_runner(ecfg, cells, gen, stcfg, exec_spec,
                                  SAC.warmup_policy(ecfg), {}, dev)
    history: List[Dict] = []
    for r in range(stcfg.rounds):
        ci = int(rng.integers(len(cells))) if len(cells) > 1 else 0
        source.set_cell(ci)
        warmup = buffer.size < scfg.warmup_steps
        policy = (SAC.warmup_policy(ecfg) if warmup
                  else ACT.actor_policy(ecfg, acfg, sampler=stcfg.sampler,
                                        device=dev))
        params = {} if warmup else ts.actor
        ragg = MX.StreamAggregator(ecfg.num_servers, ecfg.q_min,
                                   stcfg.resp_sla)
        n_new, returns = 0, []
        with runner.tracer.span("train_round", cat="train", algo="sac",
                                round=r, cell=cells[ci][0],
                                warmup=bool(warmup)):
            for _ in range(stcfg.windows_per_round):
                wres = runner.run_window(policy=policy, params=params,
                                         collect=True)
                flat = SAC.flatten_valid_transitions(wres.transitions)
                with runner.tracer.span("replay_push", cat="train",
                                        n=int(len(flat[2]))):
                    buffer.add_batch(*flat)
                n_new += len(flat[2])
                if transition_hook is not None:
                    transition_hook(r, flat)
                ragg.update(wres.stats)
                returns.append(wres.record["episode_return_mean"])
            with runner.tracer.span("gradient_update", cat="train",
                                    algo="sac", new_transitions=int(n_new)):
                ts, n_upd, _ = SAC.run_update_schedule(
                    ts, buffer, rng, gen, n_new, ecfg=ecfg, acfg=acfg,
                    scfg=scfg, max_updates=stcfg.max_updates_per_round)
                if runner.tracer.enabled and dev.type == "cuda":
                    torch.cuda.synchronize(dev)    # the span times the work
        row = _round_row(r, cells[ci][0], ragg, runner, returns, n_new,
                         n_upd)
        row.update(warmup=bool(warmup), buffer_size=buffer.size)
        history.append(row)
        _publish_round(row, "sac")
        runner.tracer.write()
        if callback:
            callback(r, row, ts)
        if stcfg.log_every and r % stcfg.log_every == 0:
            _log_row("sac", row)
    return StreamTrainResult(state=ts, history=history,
                             stream=runner.result())


# ----------------------------------------------------------------------
def train_stream_ppo(ecfg: EV.EnvConfig, pcfg: PPO.PPOConfig,
                     stcfg: StreamTrainConfig = StreamTrainConfig(), *,
                     scenario: Optional[Scenario] = None,
                     curriculum: Optional[Sequence[Scenario]] = None,
                     seed: int = 0, exec_spec=None, callback=None,
                     transition_hook=None, device=None) -> StreamTrainResult:
    """PPO trained from windowed streaming rollouts.

    Per round: collect `windows_per_round` on-policy windows, compute GAE
    per stream over each window's valid prefix — bootstrapping past the
    window seam with the critic's value of the final `next_obs` (the seam
    is a truncation, not a terminal state) — pool everything into one
    batch, and run the clipped-surrogate epochs.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    rng = SAC.host_rng(gen)
    st = PPO.init_ppo(ecfg, generator=gen, device=dev)
    policy = PPO.ppo_policy(ecfg)
    cells = resolve_cells(ecfg, scenario, curriculum, stcfg.rate_scale)
    source, runner = _make_runner(ecfg, cells, gen, stcfg, exec_spec,
                                  policy, st.params, dev)
    history: List[Dict] = []
    for r in range(stcfg.rounds):
        ci = int(rng.integers(len(cells))) if len(cells) > 1 else 0
        source.set_cell(ci)
        ragg = MX.StreamAggregator(ecfg.num_servers, ecfg.q_min,
                                   stcfg.resp_sla)
        datas, returns, n_new = [], [], 0
        with runner.tracer.span("train_round", cat="train", algo="ppo",
                                round=r, cell=cells[ci][0]):
            for _ in range(stcfg.windows_per_round):
                wres = runner.run_window(params=st.params, collect=True)
                tr = wres.transitions
                if transition_hook is not None:
                    transition_hook(r, SAC.flatten_valid_transitions(tr))
                with runner.tracer.span("gae_pool", cat="train"):
                    lens = tr.valid.sum(dim=1)
                    last = torch.clamp(lens - 1, min=0)
                    last_nobs = tr.next_obs[
                        torch.arange(lens.shape[0], device=lens.device), last]
                    with torch.no_grad():
                        last_vals = PPO.value_of(st.params, last_nobs)
                    last_vals = torch.where(lens > 0, last_vals, 0.0)
                    data = PPO.pool_gae(tr, pcfg,
                                        last_values=last_vals.cpu().numpy())
                datas.append(data)
                n_new += len(data["adv"])
                ragg.update(wres.stats)
                returns.append(wres.record["episode_return_mean"])
            pooled = {k: np.concatenate([d[k] for d in datas])
                      for k in datas[0]}
            with runner.tracer.span("gradient_update", cat="train",
                                    algo="ppo", new_transitions=int(n_new)):
                st, n_upd = PPO.run_ppo_epochs(
                    st, pooled, rng, ecfg, pcfg,
                    max_updates=stcfg.max_updates_per_round)
                if runner.tracer.enabled and dev.type == "cuda":
                    torch.cuda.synchronize(dev)    # the span times the work
        row = _round_row(r, cells[ci][0], ragg, runner, returns, n_new,
                         n_upd)
        history.append(row)
        _publish_round(row, "ppo")
        runner.tracer.write()
        if callback:
            callback(r, row, st)
        if stcfg.log_every and r % stcfg.log_every == 0:
            _log_row("ppo", row)
    return StreamTrainResult(state=st, history=history,
                             stream=runner.result())
