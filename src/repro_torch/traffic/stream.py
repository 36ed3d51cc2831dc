"""Unbounded-horizon windowed streaming on the batched rollout engine (port
of `repro/traffic/stream.py`).

The episodic engine (`core/rollout.py`) runs one fixed-size trace to
completion. This module chains it over consecutive fixed-size *task windows*
with carried environment state, so a run covers 10^5-10^6 tasks at O(window)
memory:

    window w trace  ->  batch_rollout(init_state = carry_{w-1})  ->  seam:
        * clock rebased to 0 (float32 stays precise at any horizon)
        * residual server busy time / model / gang metadata carried
        * carried gangs relabelled into [K, K+E) so their labels can never
          collide with the next window's task ids (reuse survives the seam)
        * unscheduled tasks compacted and re-injected into the next window
          (oldest beyond `max_carry` are shed and counted as dropped)

Each window is B parallel independent streams in one `batch_rollout`: on
the card the decision of the policy's `actors.program.ActorProgram`, whose
loop and CUDA graphs are built on the first window and replayed by every
later one (the window's tensors have fixed shapes). Arrival times are
open-loop: a task source draws fixed-shape chunks from an arrival process
(`arrivals.py`) on its own clock, regardless of how far the scheduler has
fallen behind. The seam (`_window_seam`) is one batched function over the
(B, K) and (B, E) tensors on the carry's device; per-window QoS stats are
folded into a `StreamAggregator` on the host. The backlog, retry and
placement bookkeeping between windows is host numpy, as in the reference,
and gives its results byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO
from repro_torch.core.rollout import Transitions
from repro_torch.core.workload import TraceConfig, sample_task_attrs
from repro_torch.faults import (RETRY_COL, FaultSpec, FaultTimeline,
                                fault_horizon, faults_active, retry_backoff)
from repro_torch.placement import (PlacementManager, PlacementSpec,
                                   placement_active)
from repro_torch.telemetry.trace import NULL_TRACER
from repro_torch.traffic import metrics as MX

_COLS = ("arr_time", "c", "model", "noise")
_DTYPES = {"arr_time": np.float32, "c": np.int32, "model": np.int32,
           "noise": np.float32}


@dataclass(frozen=True)
class StreamConfig:
    num_windows: int = 16
    num_streams: int = 1                    # B independent parallel streams
    max_steps_per_window: Optional[int] = None   # default min(4K, max_steps)
    max_carry: Optional[int] = None         # leftover slots kept; default K//2
    resp_sla: float = 120.0                 # QoS latency budget (seconds)
    chunk_size: int = 0                     # arrival buffer refill; 0 = 4K
    #                                         (read by the task sources'
    #                                         builders: api, sweep, trainers)
    fused: bool = True                      # fused env-step engine (equal
    #                                         results; False = unfused path)
    faults: Optional[FaultSpec] = None      # deterministic fault injection;
    #                                         None / FaultSpec.none() =
    #                                         bitwise-identical fault-free run
    placement: Optional[PlacementSpec] = None   # slow-timescale proactive
    #                                         model placement at window seams
    #                                         (repro_torch.placement); None /
    #                                         PlacementSpec.none() = bitwise-
    #                                         identical placement-free run


def _host(x, dtype=None) -> np.ndarray:
    """A tensor or array as a host numpy array (of `dtype` when given)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# ----------------------------------------------------------------------
# task sources: host-side open-loop suppliers of (arr_time, c, model, noise)
class CurriculumTaskSource:
    """Piecewise arrival curriculum over one continuous stream.

    `cells` is a list of (arrival process, TraceConfig) pairs; every stream
    keeps ONE shared absolute arrival clock, and each fixed-size refill
    chunk is drawn from the currently-selected cell's process + attribute
    marginals. `set_cell(i)` switches the generator from the next refill
    on — the chunk default is one window's worth of tasks, so a switch
    typically lands on the very next window — while the clock, buffered
    arrivals, and carried backlog stay continuous across the switch: the
    agent trains on the backlog distribution its own scheduling induced,
    not on fresh resets.

    Draws come from `generator` (default a fresh one on `device`): every
    cell's `proc.init` at construction in cell order, then per refill the
    active cell's `proc.sample` and its `sample_task_attrs`. `draws`, when
    given, replaces all of that: an iterable of per-refill dicts of (B,
    chunk) tensors or arrays, ``gaps`` (seconds), ``c``, ``model`` and
    ``noise`` (scaled, as `sample_task_attrs` returns it); the parity
    tests hand the reference's refills to the port this way. Arrival clocks
    are float64 numpy on the host, as in the reference.
    `ProcessTaskSource` is the single-cell special case (with a larger,
    refill-amortising chunk default).
    """

    def __init__(self, cells, generator: Optional[torch.Generator] = None,
                 num_streams: int = 1, chunk_size: int = 0, *, device=None,
                 draws=None):
        if not cells:
            raise ValueError("CurriculumTaskSource needs at least one cell")
        self.cells = [(proc, tc) for proc, tc in cells]
        self.B = int(num_streams)
        tc0 = self.cells[0][1]
        self.chunk = int(chunk_size) if chunk_size else max(tc0.num_tasks, 1)
        self._draws = None if draws is None else iter(draws)
        self._states = []
        if self._draws is None:
            self.device = resolve_device(device)
            self.generator = (torch.Generator(self.device)
                              if generator is None else generator)
            self._states = [proc.init(self.B, generator=self.generator,
                                      device=self.device)
                            for proc, _ in self.cells]
        self.active = 0
        self._clock = np.zeros(self.B, np.float64)   # absolute arrival clock
        self._buf = [{c: np.zeros((0,), _DTYPES[c]) for c in _COLS}
                     for _ in range(self.B)]

    def set_cell(self, i: int) -> None:
        if not 0 <= int(i) < len(self.cells):
            raise ValueError(f"cell index {i} out of range "
                             f"[0, {len(self.cells)})")
        self.active = int(i)

    def _draw(self):
        """(gaps, c, model, noise) of the next refill, each (B, chunk)."""
        if self._draws is not None:
            d = next(self._draws)
            return d["gaps"], d["c"], d["model"], d["noise"]
        a = self.active
        proc, tc = self.cells[a]
        self._states[a], gaps = proc.sample(self._states[a], self.chunk,
                                            generator=self.generator)
        c, model, noise = sample_task_attrs(tc, (self.B, self.chunk),
                                            generator=self.generator,
                                            device=self.device)
        return gaps, c, model, noise

    def _refill(self) -> None:
        gaps, c, model, noise = self._draw()
        gaps = _host(gaps, np.float32).astype(np.float64)      # (B, chunk)
        arr = self._clock[:, None] + np.cumsum(gaps, axis=1)
        self._clock = arr[:, -1].copy()
        c, model, noise = (_host(c, np.int32), _host(model, np.int32),
                           _host(noise, np.float32))
        for b in range(self.B):
            new = {"arr_time": arr[b].astype(np.float64), "c": c[b],
                   "model": model[b], "noise": noise[b]}
            self._buf[b] = {col: np.concatenate([self._buf[b][col], new[col]])
                            for col in _COLS}

    def take(self, stream: int, n: int) -> Dict[str, np.ndarray]:
        """Pop the next n tasks of one stream (arr_time is absolute)."""
        while len(self._buf[stream]["arr_time"]) < n:
            self._refill()
        out = {col: self._buf[stream][col][:n] for col in _COLS}
        self._buf[stream] = {col: self._buf[stream][col][n:] for col in _COLS}
        return out


class ProcessTaskSource(CurriculumTaskSource):
    """Draws tasks from ONE arrival process + TraceConfig attribute
    marginals — the single-cell curriculum source with a larger chunk
    default (4 windows) that amortises refills over a long sweep."""

    def __init__(self, proc, tc: TraceConfig,
                 generator: Optional[torch.Generator] = None,
                 num_streams: int = 1, chunk_size: int = 0, *, device=None,
                 draws=None):
        super().__init__(
            [(proc, tc)], generator, num_streams=num_streams,
            chunk_size=int(chunk_size) if chunk_size
            else max(4 * tc.num_tasks, 64), device=device, draws=draws)
        self.proc, self.tc = proc, tc


class TraceTaskSource:
    """Finite source replaying explicit traces with full attributes —
    feed an episodic trace through the streaming engine verbatim (parity
    tests, trace-driven evaluation). `traces` is a dict of (B, N) tensors
    or arrays with *absolute* arrival times."""

    def __init__(self, traces: Dict):
        self._cols = {c: _host(traces[c]) for c in _COLS}
        self.B, self.N = self._cols["arr_time"].shape
        self._cursor = np.zeros(self.B, np.int64)

    def take(self, stream: int, n: int) -> Dict[str, np.ndarray]:
        i = int(self._cursor[stream])
        if i + n > self.N:
            raise ValueError(f"TraceTaskSource exhausted: stream {stream} "
                             f"has {self.N - i} tasks left, asked for {n}")
        self._cursor[stream] = i + n
        return {c: v[stream, i:i + n] for c, v in self._cols.items()}


# ----------------------------------------------------------------------
def _compact(traces: Dict, keys, mask: torch.Tensor, te: torch.Tensor):
    """The tasks of `mask` first, oldest first (a stable sort on arrival
    time with the rest at INF, as the reference's `jnp.argsort`), each
    column gathered along K, the arrival clock rebased by `te`."""
    order = torch.argsort(torch.where(mask, traces["arr_time"], EV.INF),
                          dim=1, stable=True)
    out = {c: torch.gather(traces[c], 1, order) for c in keys}
    out["arr_time"] = out["arr_time"] - te[:, None]
    return out


def _window_seam(ecfg: EV.EnvConfig, traces: Dict, st: EV.EnvState,
                 edges: torch.Tensor, resp_sla: float,
                 per_model: bool = False):
    """Seam: per-window QoS stats + next-window carry state + compacted
    leftovers, batched over the stream axis on the state's device (the
    reference vmaps a per-stream function; here every op carries the (B,)
    axis).

    With fault columns attached the seam additionally excludes crashed
    tasks (status 3) from the served stats, compacts them into a separate
    retry set (with their `f_retries` counts, clock rebased like the
    leftovers), and cold-wipes the model cache of carried servers whose
    crash fell inside this window — the next window's fault arrays drop
    fully-past intervals, so the wipe must happen here.

    `per_model=True` (on iff placement is active) adds per-model
    scheduled/reload counts to the stats — the source of the
    `eat_placement_cold_start_rate{model=...}` telemetry labels.

    Integer counts, the carry, the leftovers, the failed set, `max_resp`,
    `elapsed` and the histogram equal the reference's; the float sums over
    K (`sum_resp`, `sum_quality`, `sum_steps`, `busy_time`) may round in
    another order."""
    K, E = ecfg.max_tasks, ecfg.num_servers
    faulty = EV.has_faults(traces)
    i32, f32 = torch.int32, torch.float32
    te = st.time                                                  # (B,)
    status = st.task_status
    if faulty:                   # crashed tasks (status 3) served nothing
        sched = (status == 1) | (status == 2)
    else:
        sched = status >= 1
    fsch = sched.to(f32)
    resp = torch.where(sched, st.task_finish - traces["arr_time"], 0.0)
    viol_q = sched & (st.task_quality < ecfg.q_min)
    viol_t = sched & (resp > resp_sla)
    viol = viol_q | viol_t
    busy = torch.where(sched, traces["c"].to(f32)
                       * (st.task_finish - st.task_start), 0.0).sum(1)
    stats = {
        "n_sched": sched.sum(1, dtype=i32),
        "n_done": (status == 2).sum(1, dtype=i32),
        "n_reload": torch.where(sched, st.task_reload, 0).sum(1, dtype=i32),
        "n_viol": viol.sum(1, dtype=i32),
        "n_viol_q": viol_q.sum(1, dtype=i32),
        "n_viol_t": viol_t.sum(1, dtype=i32),
        "sum_resp": resp.sum(1),
        "max_resp": resp.amax(1),
        "sum_quality": torch.where(sched, st.task_quality, 0.0).sum(1),
        "sum_steps": (fsch * st.task_steps).sum(1),
        "busy_time": busy,
        "elapsed": te,
        "hist": MX.bucketize_counts(resp, sched, edges),
    }
    if faulty:
        stats["n_failed"] = (status == 3).sum(1, dtype=i32)
    if per_model:
        oh = torch.nn.functional.one_hot(
            torch.clamp(traces["model"], 0, ecfg.num_models - 1).long(),
            ecfg.num_models).to(f32)                               # (B, K, M)
        stats["n_sched_m"] = (oh * fsch[..., None]).sum(1)
        stats["n_reload_m"] = (
            oh * (fsch * st.task_reload.to(f32))[..., None]).sum(1)

    # ---- carry: rebase the clock, keep server occupancy + gang ids ------
    gang = st.server_gang
    has = gang >= 0
    same = gang[:, :, None] == gang[:, None, :]                   # (B, E, E)
    ar = torch.arange(E, device=gang.device)
    leader = torch.where(same & has[:, None, :], ar, E).amin(2)
    B, dev = te.shape[0], te.device
    zk = torch.zeros((B, K), dtype=f32, device=dev)
    zki = torch.zeros((B, K), dtype=i32, device=dev)
    model = st.server_model
    carry_gang = torch.where(has, K + leader, -1).to(i32)
    size = st.server_gang_size
    if faulty:                   # carried servers lose their cache if
        wipe = (traces["f_down_start"] <= te[:, None, None]).any(2) \
            & (traces["f_cold"][:, :1] > 0)   # their crash began this window
        model = torch.where(wipe, -1, model)
        carry_gang = torch.where(wipe, -1, carry_gang)
        size = torch.where(wipe, 0, size)
    carry = EV.EnvState(
        time=torch.zeros((B,), dtype=f32, device=dev),
        server_free_at=torch.clamp(st.server_free_at - te[:, None], min=0.0),
        server_model=model, server_gang=carry_gang, server_gang_size=size,
        task_status=zki, task_start=zk, task_finish=zk.clone(),
        task_steps=zki.clone(), task_quality=zk.clone(),
        task_reload=zki.clone(),
        steps_taken=torch.zeros((B,), dtype=i32, device=dev))

    # ---- leftovers: unscheduled tasks, oldest first, clock rebased ------
    left = status == 0
    n_left = left.sum(1, dtype=i32)
    keys = _COLS + ((RETRY_COL,) if faulty else ())
    leftovers = _compact(traces, keys, left, te)
    if faulty:
        # ---- failed tasks: compacted for the host retry machinery ------
        failed = status == 3
        fail = _compact(traces, keys, failed, te)
        return stats, carry, leftovers, n_left, fail, failed.sum(1, dtype=i32)
    return stats, carry, leftovers, n_left


class StreamResult(NamedTuple):
    summary: Dict
    per_window: List[Dict]
    aggregator: MX.StreamAggregator
    final_carry: EV.EnvState
    transitions: Optional[List[Transitions]] = None   # per window, collect=
    fault_counters: Dict = {}          # host fault ledger (empty: faults off)
    placement_counters: Dict = {}      # slow-timescale placement ledger
    #                                    (empty: placement off); includes a
    #                                    nested "per_model" cold-start table


class WindowResult(NamedTuple):
    """One window of one `StreamRunner`: raw per-stream stats, the flat
    per-window ledger record, rollout metrics, and (collect=True) the
    window's stacked (B, T, ...) transitions."""
    window: int
    stats: Dict[str, np.ndarray]
    record: Dict
    metrics: Dict
    transitions: Optional[Transitions]


class StreamRunner:
    """Stateful windowed streaming: each `run_window()` call advances every
    stream by one window of K = ecfg.max_tasks tasks and returns that
    window's stats (and, with `collect=True`, its stacked transitions),
    while backlog, clock epoch, and server occupancy carry across the seam.

    This is the collect-capable engine under `run_stream` (which just loops
    it) and streaming trainers, which interleave gradient updates between
    windows: the policy callable and params may be swapped per window
    (e.g. warmup -> actor, fresh actor weights every round) without
    disturbing the carried stream state.

    The runner holds one `torch.Generator` (`generator`, default a fresh
    one on `device`), and each window's rollout draws from it in order, as
    `batch_rollout` would: a single-window run from a fresh carry equals
    `batch_rollout(ecfg, traces, policy, params, generator=g)` on the same
    generator state, in every tensor. (The reference's window w uses
    `split(fold_in(key, w), B)`; threefry and Philox never agree, so the
    port's contract is stated on the generator.) `rollout_fn`, when given,
    is any callable with `core.rollout.batch_rollout`'s signature; None
    keeps `batch_rollout` on the `scfg.fused` path. The transition layout
    is stable across seams: always (B, T, ...) with window-local clocks in
    the observations and `valid` masking steps past the drain. Every
    tensor of the run lives on `device` (None: the CUDA device; raises
    without one); the task sources and the host bookkeeping are numpy.
    """

    def __init__(self, ecfg: EV.EnvConfig, policy, params, source,
                 generator: Optional[torch.Generator] = None,
                 scfg: StreamConfig = StreamConfig(), rollout_fn=None,
                 tracer=None, device=None):
        K, B = ecfg.max_tasks, scfg.num_streams
        max_carry = K // 2 if scfg.max_carry is None else int(scfg.max_carry)
        if not 0 <= max_carry < K:
            raise ValueError(f"max_carry must be in [0, {K}), got {max_carry}")
        self.device = resolve_device(device)
        self.ecfg, self.scfg = ecfg, scfg
        self.params = params
        self._set_policy(policy)
        self.source = source
        self.generator = (torch.Generator(self.device) if generator is None
                          else generator)
        self.rollout_fn = rollout_fn
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.K, self.B = K, B
        self.T = scfg.max_steps_per_window or min(4 * K, ecfg.max_steps)
        self.max_carry = max_carry
        self._edges = torch.as_tensor(MX.DEFAULT_EDGES, device=self.device)
        self._sla = float(np.float32(scfg.resp_sla))
        self.agg = MX.StreamAggregator(ecfg.num_servers, ecfg.q_min,
                                       scfg.resp_sla, edges=MX.DEFAULT_EDGES)
        self.carry = EV.reset(ecfg, B, device=self.device)
        self.leftovers = [{c: np.zeros((0,), _DTYPES[c]) for c in _COLS}
                          for _ in range(B)]
        self.t0 = np.zeros(B, np.float64)   # absolute epoch of window start
        self.window = 0
        self.per_window: List[Dict] = []
        # ---- fault tolerance: crash timeline + host retry buffers -------
        self.faults = scfg.faults if faults_active(scfg.faults) else None
        if self.faults is not None:
            self.timeline = FaultTimeline(self.faults, ecfg.num_servers, B)
            self._horizon = fault_horizon(ecfg.time_limit, self.faults)
            for lo in self.leftovers:
                lo[RETRY_COL] = np.zeros((0,), np.int32)
            # per stream: failed tasks waiting out their backoff. arr_abs /
            # ready_abs are absolute-clock float64 (windows rebase to f32).
            self._retry = [
                {"arr_abs": np.zeros((0,), np.float64),
                 "c": np.zeros((0,), np.int32),
                 "model": np.zeros((0,), np.int32),
                 "noise": np.zeros((0,), np.float32),
                 "retries": np.zeros((0,), np.int32),
                 "ready_abs": np.zeros((0,), np.float64)}
                for _ in range(B)]
        # ---- slow timescale: proactive model placement at window seams --
        self.placement = None
        if placement_active(scfg.placement):
            self.placement = PlacementManager(scfg.placement, ecfg, B,
                                              tracer=self.tracer)
            # per-model scheduled/reload tallies (cold-start-rate labels)
            self._pm_sched = np.zeros(ecfg.num_models, np.float64)
            self._pm_reload = np.zeros(ecfg.num_models, np.float64)

    # ------------------------------------------------------------------
    def _set_policy(self, policy) -> None:
        """Register the current policy with the shared actor layer: the
        seam swap (`run_window(policy=...)`) re-resolves the cached
        `ActorProgram`, so per-window policy changes (warmup -> actor,
        sampler swaps) reuse its loops and graphs — and the program's
        sampler label feeds the window span."""
        from repro_torch.actors.program import actor_program
        self.policy = policy
        self.program = actor_program(self.ecfg, policy)

    # ------------------------------------------------------------------
    def _build_window(self):
        """Fill the next window's traces: re-admit retry-buffer tasks whose
        backoff expired (merged into the backlog by original arrival time),
        shed over-carry backlog, re-inject the surviving leftovers, top up
        with fresh arrivals."""
        K, B = self.K, self.B
        faulty = self.faults is not None
        cols = {c: np.zeros((B, K), _DTYPES[c]) for c in _COLS}
        if faulty:
            cols[RETRY_COL] = np.zeros((B, K), np.int32)
        n_injected = np.zeros(B, np.int64)
        n_dropped = np.zeros(B, np.int64)
        n_carried = np.zeros(B, np.int64)
        n_readmit = np.zeros(B, np.int64)
        for b in range(B):
            lo = self.leftovers[b]
            if faulty:
                rb = self._retry[b]
                due = rb["ready_abs"] <= self.t0[b]
                if due.any():
                    # keep the ORIGINAL (rebased) arrival time: latency is
                    # measured from first arrival, not from re-admission
                    add = {"arr_time": (rb["arr_abs"][due] - self.t0[b]
                                        ).astype(np.float32),
                           "c": rb["c"][due], "model": rb["model"][due],
                           "noise": rb["noise"][due],
                           RETRY_COL: rb["retries"][due]}
                    n_readmit[b] = int(due.sum())
                    lo = {c: np.concatenate([lo[c], add[c]]) for c in lo}
                    order = np.argsort(lo["arr_time"], kind="stable")
                    lo = {c: v[order] for c, v in lo.items()}
                    self._retry[b] = {c: v[~due] for c, v in rb.items()}
            nl = len(lo["arr_time"])
            if nl > self.max_carry:        # shed the stalest backlog
                n_dropped[b] = nl - self.max_carry
                lo = {c: v[nl - self.max_carry:] for c, v in lo.items()}
                nl = self.max_carry
            n_carried[b] = nl
            n_new = K - nl
            new = self.source.take(b, n_new)
            n_injected[b] = n_new
            for c in _COLS:
                cols[c][b, :nl] = lo[c]
                if c == "arr_time":        # absolute -> window-local clock
                    cols[c][b, nl:] = (new[c].astype(np.float64)
                                       - self.t0[b]).astype(np.float32)
                else:
                    cols[c][b, nl:] = new[c]
            if faulty:
                cols[RETRY_COL][b, :nl] = lo[RETRY_COL]
        return cols, n_injected, n_dropped, n_carried, n_readmit

    def run_window(self, *, policy=None, params=None,
                   collect: bool = False) -> WindowResult:
        """Advance every stream by one window. `policy`/`params`, when
        given, replace the runner's current ones from this window on (the
        trainers push freshly-updated actor weights each round)."""
        if policy is not None:
            self._set_policy(policy)
        if params is not None:
            self.params = params
        w = self.window
        dev = self.device
        tr = self.tracer
        wkw = ({"sampler": self.program.sampler}
               if self.program.sampler else {})
        wspan = tr.span("window", cat="stream", window=w,
                        backend=getattr(self.rollout_fn, "backend",
                                        "fused" if self.scfg.fused
                                        else "reference"), **wkw)
        with wspan:
            with tr.span("build_window", cat="stream", window=w):
                (cols, n_injected, n_dropped, n_carried,
                 n_readmit) = self._build_window()
                if self.placement is not None:
                    # demand for the slow timescale: this window's tasks,
                    # folded BEFORE the rollout but only consulted at the
                    # seam AFTER it — the layout for window w+1 sees
                    # arrivals of windows <= w, never its own
                    self.placement.observe_window(w, cols)
                if self.faults is not None:
                    cols.update(self.timeline.window_arrays(w, self.t0,
                                                            self._horizon))
                traces = {c: torch.from_numpy(v).to(dev)
                          for c, v in cols.items()}
            with tr.span("window_rollout", cat="rollout", window=w,
                         streams=self.B, steps=self.T):
                kw = dict(generator=self.generator, num_steps=self.T,
                          init_state=self.carry, collect=collect, device=dev)
                if self.rollout_fn is None:
                    res = RO.batch_rollout(self.ecfg, traces, self.policy,
                                           self.params, fused=self.scfg.fused,
                                           **kw)
                else:
                    res = self.rollout_fn(self.ecfg, traces, self.policy,
                                          self.params, **kw)
                if tr.enabled and dev.type == "cuda":
                    # wall-clock attribution only: make the asynchronous
                    # rollout finish inside its span, not the seam's
                    torch.cuda.current_stream(dev).synchronize()
            with tr.span("window_seam", cat="stream", window=w):
                seam = _window_seam(self.ecfg, traces, res.final_state,
                                    self._edges, self._sla,
                                    per_model=self.placement is not None)
                if self.faults is not None:
                    stats, self.carry, lcols, n_left, fcols, n_fail = seam
                else:
                    stats, self.carry, lcols, n_left = seam
                    fcols = n_fail = None
                n_left = _host(n_left)
                lcols = {c: _host(v) for c, v in lcols.items()}
                self.leftovers = [{c: lcols[c][b, :n_left[b]] for c in lcols}
                                  for b in range(self.B)]
                rec = {k: _host(v) for k, v in stats.items()}
                self.t0 += rec["elapsed"].astype(np.float64)
            if self.placement is not None:
                # slow timescale: rewrite the carried state (idle servers
                # only) and let a real-weight backend prefetch off the
                # timed path
                self.carry, decision = self.placement.apply(self.carry, w)
                if decision is not None:
                    hook = getattr(self.rollout_fn, "apply_placement", None)
                    if hook is not None:
                        hook(decision)

        n_retried = np.zeros(self.B, np.int64)
        n_fail_drop = np.zeros(self.B, np.int64)
        if self.faults is not None:
            with tr.span("fault_requeue", cat="stream", window=w):
                n_retried, n_fail_drop = self._requeue_failed(
                    {c: _host(v) for c, v in fcols.items()}, _host(n_fail))
            tr.counter("pending_retry", float(self.pending_retry()),
                       window=w)

        tr.counter("backlog", float(n_left.sum()), window=w)
        if self.placement is not None:
            # per-model tallies are placement telemetry, not window-ledger
            # rows: fold them here and keep the aggregator's schema fixed
            self._pm_sched += rec.pop("n_sched_m").sum(axis=0)
            self._pm_reload += rec.pop("n_reload_m").sum(axis=0)
        rec["n_injected"] = n_injected
        rec["n_dropped"] = n_dropped
        rec["n_carried"] = n_carried
        rec["n_leftover"] = n_left.astype(np.int64)
        if self.faults is not None:
            rec["n_retried"] = n_retried
            rec["n_failed_dropped"] = n_fail_drop
            rec["n_readmitted"] = n_readmit
        self.agg.update(rec)
        n_sched_w = int(rec["n_sched"].sum())
        record = {
            "window": w,
            "injected": int(n_injected.sum()),
            "carried": int(n_carried.sum()),
            "scheduled": n_sched_w,
            "dropped": int(n_dropped.sum()),
            "leftover": int(n_left.sum()),
            "mean_elapsed": float(np.mean(rec["elapsed"])),
            "mean_latency": float(rec["sum_resp"].sum() / max(n_sched_w, 1)),
            "episode_return_mean": float(np.mean(_host(
                res.metrics["episode_return"]))),
        }
        if self.faults is not None:
            record["failed"] = int(rec["n_failed"].sum())
            record["retried"] = int(n_retried.sum())
            record["failed_dropped"] = int(n_fail_drop.sum())
            record["pending_retry"] = self.pending_retry()
        self.per_window.append(record)
        self.window += 1
        return WindowResult(window=w, stats=rec, record=record,
                            metrics=res.metrics,
                            transitions=res.transitions if collect else None)

    # ------------------------------------------------------------------
    def _requeue_failed(self, fcols: Dict[str, np.ndarray],
                        n_fail: np.ndarray):
        """Route this window's crashed tasks into the retry buffers.

        Each failure bumps the task's retry count and earns a capped
        exponential backoff (`faults.retry_backoff`) measured from the new
        window epoch; tasks beyond `max_retries`, or whose age at the
        earliest possible re-admission would already exceed
        `retry_deadline`, are dropped (deadline-aware retry budget — a task
        that cannot possibly meet QoS is not worth a server)."""
        spec = self.faults
        n_retried = np.zeros(self.B, np.int64)
        n_dropped = np.zeros(self.B, np.int64)
        for b in range(self.B):
            m = int(n_fail[b])
            if m == 0:
                continue
            # arr was rebased to the new epoch by the seam (-te), so the
            # absolute original arrival is rebased + t0 (t0 already moved)
            arr_abs = fcols["arr_time"][b, :m].astype(np.float64) \
                + self.t0[b]
            r = fcols[RETRY_COL][b, :m].astype(np.int64) + 1
            ready = self.t0[b] + np.array(
                [retry_backoff(spec, int(ri)) for ri in r], np.float64)
            keep = (r <= spec.max_retries) \
                & ((ready - arr_abs) <= spec.retry_deadline)
            n_retried[b] = int(keep.sum())
            n_dropped[b] = m - int(keep.sum())
            if not keep.any():
                continue
            rb = self._retry[b]
            self._retry[b] = {
                "arr_abs": np.concatenate([rb["arr_abs"], arr_abs[keep]]),
                "c": np.concatenate([rb["c"], fcols["c"][b, :m][keep]]),
                "model": np.concatenate([rb["model"],
                                         fcols["model"][b, :m][keep]]),
                "noise": np.concatenate([rb["noise"],
                                         fcols["noise"][b, :m][keep]]),
                "retries": np.concatenate([rb["retries"],
                                           r[keep].astype(np.int32)]),
                "ready_abs": np.concatenate([rb["ready_abs"], ready[keep]]),
            }
        return n_retried, n_dropped

    def pending_retry(self) -> int:
        """Failed tasks currently waiting out their backoff."""
        if self.faults is None:
            return 0
        return int(sum(len(rb["arr_abs"]) for rb in self._retry))

    def backlog(self) -> int:
        """Tasks currently waiting across all streams (pre-shedding)."""
        return int(sum(len(lo["arr_time"]) for lo in self.leftovers))

    def fault_counters(self) -> Dict[str, int]:
        """Host-side fault bookkeeping (empty when faults are off)."""
        if self.faults is None:
            return {}
        out = dict(self.timeline.counters())
        out["tasks_pending_retry"] = self.pending_retry()
        return out

    def placement_counters(self) -> Dict:
        """Slow-timescale placement ledger (empty when placement is off):
        the manager's cumulative counts plus a nested "per_model" table of
        {model: {scheduled, reloads, cold_start_rate}} — the source of the
        per-model cold-start-rate telemetry labels."""
        if self.placement is None:
            return {}
        out = dict(self.placement.counters())
        out["per_model"] = {
            int(m): {"scheduled": float(self._pm_sched[m]),
                     "reloads": float(self._pm_reload[m]),
                     "cold_start_rate": float(
                         self._pm_reload[m] / max(self._pm_sched[m], 1.0))}
            for m in range(self.ecfg.num_models)}
        return out

    def result(self, transitions: Optional[List[Transitions]] = None
               ) -> StreamResult:
        summary = self.agg.summary()
        summary["tasks_leftover"] = self.backlog()
        summary["num_streams"] = self.B
        summary["window_tasks"] = self.K
        summary["tasks_failed_pending_retry"] = self.pending_retry()
        return StreamResult(summary=summary, per_window=self.per_window,
                            aggregator=self.agg, final_carry=self.carry,
                            transitions=transitions,
                            fault_counters=self.fault_counters(),
                            placement_counters=self.placement_counters())


# ----------------------------------------------------------------------
def run_stream(ecfg: EV.EnvConfig, policy, params, source,
               generator: Optional[torch.Generator] = None,
               scfg: StreamConfig = StreamConfig(),
               rollout_fn=None, collect: bool = False,
               tracer=None, device=None) -> StreamResult:
    """Drive `num_windows` windows of K = ecfg.max_tasks tasks per stream.

    A thin loop over `StreamRunner.run_window`; see that class for the seam
    and generator semantics. Device memory is O(B * K) regardless of the
    horizon (`collect=True` additionally returns each window's stacked
    (B, T, ...) transitions, so memory grows with `num_windows` — training
    consumers that need bounded memory drive `StreamRunner` directly and
    drain each window into their replay buffer / GAE pool).
    """
    runner = StreamRunner(ecfg, policy, params, source, generator, scfg,
                          rollout_fn=rollout_fn, tracer=tracer, device=device)
    collected: Optional[List[Transitions]] = [] if collect else None
    for _ in range(scfg.num_windows):
        wres = runner.run_window(collect=collect)
        if collect:
            collected.append(wres.transitions)
    return runner.result(transitions=collected)
