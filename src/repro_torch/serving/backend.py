"""The serving execution backend: real model execution behind the
`batch_rollout` calling convention (port of `repro/serving/backend.py`).

`ServingRollout` is a stateful callable with the port's backend signature

    fn(ecfg, traces, policy, params, *, generator=None, num_steps=None,
       collect=False, init_state=None, device=None) -> RolloutResult

so `Simulator(ExecSpec(backend="serving"))`, `StreamRunner(rollout_fn=...)`
and `train_stream_sac(exec_spec=...)` all drive a real serving cluster
through the exact seam the simulated engines use. One constraint: the batch
axis is 1 — there is one physical pool, not B parallel universes.

Design: the scheduler's view of the cluster is a *mirror* `EnvState` at
batch 1. The pool (`serving.pool`) holds the real per-server weights and
the load/reuse ledger; the executor (`serving.executor`) runs real
patch-parallel prefill + decode for every scheduled task (on the card each
prefill layer launches the flash_attention kernel). Each decision is the
policy's `actors.program.actor_program(ecfg, policy).act` at batch 1 — on
the card its CUDA graph, one denoiser_chain launch per ddpm decision.

The mirror advance. The reference advances its mirror with
`env.step_with_queue`, bitwise equal to its fused op. In the port the
fused engine's step is the env_step kernel, exact on integers, booleans
and the clock but not on every float (1e-5), so a closed loop through the
compositional step could fork from the fused run after one ulp. So the
mirror advances through the fused engine's own door,
`kernels.env_step.ops.env_stepper` at batch 1 (one env_step launch per
decision on the card; the plain version on the CPU), and the `info` the
backend needs (scheduled, task, steps, reuse, failed) is read from the
state change (`step_info`: the one task whose status left 0 this
decision), which `tests/test_torch_serving_backend.py` holds to
`env.step_with_queue`'s `info`. With the same draws the mirror is then
the fused rollout at batch 1 in every tensor, EAT closed loop included.

Two time modes:

* virtual (``serving_wall_clock=False``): latencies stay on the Table-VI
  model inside the decision step, so the whole rollout — final state,
  rewards, collected transitions — equals the fused engine's on the same
  (trace, policy, generator state) in every tensor. Real execution rides
  along without perturbing the MDP.
* wall-clock (``serving_wall_clock=True``): each scheduled task's measured
  execution seconds are patched back into the mirror (`wall_patch`:
  `server_free_at`, `task_finish`), the reward is recomputed from the
  *measured* t_resp (Eq. 4a, `core.env`'s operation order), done is
  re-evaluated and the next observation/queue derive from the patched
  state — the sim-to-real loop closes.

Draws and freeze-after-done follow `batch_rollout` at batch 1: the policy
is called at every one of the T decisions and draws from the caller's
generator in the fused loop's order (post-done decisions still draw, and
replay the frozen state), so the generator leaves a window exactly as the
fused engine leaves it. Weight loads draw from the backend's own
generator (seeded `seed`), placement prefetches from a second one (seeded
`seed ^ 0x5EED`, so the on-demand load sequence is the same with and
without placement), prompts from `np.random.default_rng(seed)` as in the
reference.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.actors.program import actor_program
from repro_torch.common.config import ASSIGNED_ARCHS, get_config
from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import env as EV
from repro_torch.core import obs as OBS
from repro_torch.core import quality as Q
from repro_torch.core.rollout import RolloutResult, Transitions
from repro_torch.faults import ExecFaultInjector, ExecutorFault, FaultSpec
from repro_torch.kernels.env_step import ops as EK
from repro_torch.models.zoo import build_model
from repro_torch.serving.executor import ModelExecutor
from repro_torch.serving.pool import ServerPool
from repro_torch.telemetry.profile import DecisionProfile
from repro_torch.telemetry.trace import NULL_TRACER, tracer_for


class StepInfo(NamedTuple):
    """What one batch-1 decision did, on the host."""
    scheduled: bool
    task: int
    steps: int
    reuse: bool
    failed: bool
    done: bool
    sel: np.ndarray       # (E,) bool: the servers of the task's gang


def step_info(state: EV.EnvState, nstate: EV.EnvState,
              done: torch.Tensor) -> StepInfo:
    """The decision's `info`, read from the state change of batch row 0:
    a task was scheduled iff exactly one task's status left 0 (lazy
    retirement only moves 1 -> 2); its steps, reuse flag (reload 0) and
    crash (status 3) are its new record, its gang the servers now labelled
    with it. One device-to-host copy."""
    new = (state.task_status[0] == 0) & (nstate.task_status[0] != 0)
    k = torch.argmax(new.to(torch.int32))
    row = torch.stack([new.any(), k, nstate.task_steps[0, k],
                       nstate.task_reload[0, k] == 0,
                       nstate.task_status[0, k] == 3, done[0]]
                      ).to(torch.int32)
    sel = (nstate.server_gang[0] == k).to(torch.int32)
    h = torch.cat([row, sel]).cpu().numpy()
    return StepInfo(bool(h[0]), int(h[1]), int(h[2]), bool(h[3]),
                    bool(h[4]), bool(h[5]), h[6:].astype(bool))


def wall_patch(ecfg: EV.EnvConfig, trace: Dict, q_pre: EV.QueueView,
               nstate: EV.EnvState, k: int, sel: torch.Tensor,
               busy: torch.Tensor):
    """Patch a just-scheduled decision (batch 1) with its measured busy
    seconds `busy` ((1,) f32): rewrite the gang's `server_free_at` (`sel`
    (1, E) bool) and task k's finish time, recompute the reward from the
    measured t_resp (Eq. 4a, in `core.env`'s operation order; t_avg from
    the same pre-step queue view the virtual reward used), re-evaluate
    done, and rebuild the queue/observation from the patched state.
    Returns (state', queue', obs', reward (1,), done (1,))."""
    t = nstate.time                          # scheduling never moves time
    finish = t + busy
    tfin = nstate.task_finish.clone()
    tfin[:, k] = finish
    st = nstate._replace(
        server_free_at=torch.where(sel, finish[:, None],
                                   nstate.server_free_at),
        task_finish=tfin)
    q_k = st.task_quality[:, k]
    pen = Q.quality_penalty(q_k, ecfg.q_min, ecfg.p_quality)
    arr = trace["arr_time"]
    t_resp = finish - arr[:, k]
    still = q_pre.queued & (torch.arange(ecfg.max_tasks,
                                         device=arr.device) != k)
    n_q = torch.clamp(still.to(torch.float32).sum(1), min=1.0)
    t_avg = torch.where(still, t[:, None] - arr, 0.0).sum(1) / n_q
    denom = ecfg.beta_t * t_resp + ecfg.mu_t * t_avg + 1e-3
    r = (ecfg.alpha_q * q_k - ecfg.lambda_q * pen
         + torch.div(torch.full_like(denom, ecfg.k_time), denom))
    status = st.task_status
    all_done = ((status == 2) | ((status == 1)
                                 & (st.task_finish <= t[:, None]))).all(1)
    d = (all_done | (t >= ecfg.time_limit)
         | (st.steps_taken >= ecfg.max_steps))
    q2 = OBS.visible_queue(ecfg, trace, st)
    obs2 = OBS.observe_from(ecfg, trace, st, q2)
    return st, q2, obs2, r, d


def check_archs(archs, reduced: bool) -> None:
    """Build every arch's model (no weights): an unknown arch or layer
    pattern raises here, when the backend is built, rather than at the
    first task — no other model is ever substituted."""
    for arch in dict.fromkeys(archs):
        cfg = get_config(arch)
        build_model(cfg.reduced() if reduced else cfg)


class ServingRollout:
    """Stateful serving backend under the `batch_rollout` convention.

    The pool (loaded weights, load/reuse counters) persists across calls —
    across stream windows and training rounds, exactly like a long-lived
    cluster. `reset()` drops every loaded model (the Simulator calls it at
    the start of each `run`, so sweep policies never inherit a warm pool).
    `archs` names the model-zoo archs served (by env model id, cycled);
    () is the reference's `ASSIGNED_ARCHS`. Every tensor lives on `device`
    (None: the CUDA device).
    """

    backend = "serving"

    def __init__(self, num_servers: int, *, archs=(), reduced: bool = True,
                 wall_clock: bool = False, execute: bool = True,
                 prompt_len: int = 8, max_new_tokens: int = 16,
                 seed: int = 0, warmup: Optional[bool] = None, tracer=None,
                 faults: Optional[FaultSpec] = None, device=None):
        self.device = resolve_device(device)
        self.archs = tuple(archs) if archs else ASSIGNED_ARCHS
        self.reduced = reduced
        self.wall_clock = wall_clock
        self.execute = execute
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.seed = int(seed)
        # warmup runs each executor shape once outside the timed region so
        # wall-clock latencies measure inference, not first-use builds; it
        # defaults on exactly when measured seconds feed the MDP
        self.warmup = bool(wall_clock) if warmup is None else bool(warmup)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.pool = ServerPool(num_servers)
        check_archs(self.archs, reduced)
        self.executor = ModelExecutor(reduced=reduced, tracer=self.tracer,
                                      device=self.device)
        self.faults = faults if (faults is not None and faults.active) \
            else None
        self.injector = ExecFaultInjector(self.faults)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Fresh cluster: unload every model, zero the ledgers and restart
        the weight, prefetch and prompt draws. Built models and the warmed
        shapes survive (process state, not cluster state)."""
        self.pool.reset()
        self.injector.reset()
        self.profile = DecisionProfile()
        self.tasks_executed = 0
        self.measured_busy: list = []       # wall seconds per executed task
        self._load_gen = torch.Generator(self.device).manual_seed(self.seed)
        self._prompt_rng = np.random.default_rng(self.seed)
        # placement prefetch draws weights from its OWN generator so the
        # on-demand `_load` sequence — and with it every scheduled task's
        # weights — is identical to a placement-free run
        self._prefetch_gen = torch.Generator(self.device).manual_seed(
            self.seed ^ 0x5EED)
        self.placement_prefetches = 0
        self.placement_evictions = 0

    def serving_stats(self) -> Dict[str, float]:
        out = dict(self.pool.counters())
        out["tasks_executed"] = self.tasks_executed
        if self.measured_busy:
            out["measured_busy_mean_s"] = float(np.mean(self.measured_busy))
        out.update(self.profile.summary())
        out.update(self.placement_counters())
        return out

    def placement_counters(self) -> Dict[str, int]:
        """Real-weight prefetch/evict ledger (zero in a placement-free
        run); kept off `pool.counters()`, whose key set is pinned."""
        return {"placement_weight_prefetches": self.placement_prefetches,
                "placement_weight_evictions": self.placement_evictions}

    def pool_counters(self) -> Dict[str, int]:
        """The pool's monotonic load/reuse/shed ledger alone (metrics
        registry counters; `serving_stats` adds derived scalars)."""
        return dict(self.pool.counters())

    def fault_counters(self) -> Dict[str, int]:
        """Fault-tolerance ledger: pool retry/degrade counts + injected
        errors (all zero in a fault-free run)."""
        out = dict(self.pool.fault_counters())
        out.update(self.injector.counters())
        return out

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _arch_of(self, m_k: int) -> str:
        return self.archs[m_k % len(self.archs)]

    def _run_task(self, m_k: int, c_k: int, steps: int, sel: np.ndarray,
                  reuse: bool) -> float:
        """Pool bookkeeping + real execution for one scheduled gang.
        Returns measured wall seconds of the load + generate work."""
        arch = self._arch_of(m_k)
        gang = [self.pool.servers[i] for i in np.flatnonzero(sel)]
        if self.execute and self.warmup:
            # run this shape bucket once BEFORE the timer: the first task
            # of an (arch, shape) pair must not bill first-use builds as
            # serving latency
            with self.tracer.span("executor_warmup", cat="serving",
                                  arch=arch, c=int(c_k)):
                self.executor.warm(arch, self.prompt_len, c_k, steps,
                                   self.max_new_tokens)
                self._sync()
        t0 = time.perf_counter()
        if reuse:
            self.pool.reuse_count += 1
            leader = next((s for s in gang if s.params is not None), None)
            if leader is None:                # defensive: mirror said reuse
                leader = gang[0]              # but pool lost the weights
                self._load(leader, arch)
            for s in gang:
                s.params, s.model_name = leader.params, leader.model_name
        else:
            for s in gang:          # a server drops its resident model
                s.params = None     # before it materialises the next one
            self._load(gang[0], arch)
            for s in gang[1:]:
                # each member materialises the weights in the real system;
                # the replicas are identical, so share the leader's tensors
                s.params, s.model_name = gang[0].params, arch
                self.pool.load_count += 1
        if self.execute:
            prompt = self._prompt_rng.integers(
                0, self.executor.model(arch).cfg.vocab_size,
                self.prompt_len, dtype=np.int64).astype(np.int32)
            self._generate_tolerant(arch, gang[0].params, prompt, c_k, steps)
        self._sync()
        self.tasks_executed += 1
        return time.perf_counter() - t0

    def _generate_tolerant(self, arch: str, params, prompt, c_k: int,
                           steps: int) -> None:
        """Real generation under the fault-tolerance policy: each attempt is
        wall-clock-bounded (`exec_timeout_s`) and may draw an injected
        transient error; transient failures retry up to `exec_max_attempts`
        tries, with the LAST attempt degraded to `degrade_steps_frac` of the
        requested steps (graceful degradation: a reduced-quality result
        beats no result). Without an active FaultSpec this is exactly one
        plain `executor.generate` call."""
        spec = self.faults
        if spec is None:
            self.executor.generate(arch, params, prompt, c_k, steps,
                                   self.max_new_tokens)
            return
        attempts = max(int(spec.exec_max_attempts), 1)
        for attempt in range(1, attempts + 1):
            run_steps = steps
            if attempt == attempts and attempts > 1:
                run_steps = max(1, int(steps * spec.degrade_steps_frac))
            degraded = run_steps < steps
            try:
                if degraded:
                    with self.tracer.span("executor_degrade", cat="serving",
                                          arch=arch, steps=run_steps,
                                          requested=steps):
                        self.injector.maybe_fail("generate")
                        self.executor.generate(
                            arch, params, prompt, c_k, run_steps,
                            self.max_new_tokens,
                            deadline_s=spec.exec_timeout_s)
                    self.pool.exec_degraded += 1
                else:
                    self.injector.maybe_fail("generate")
                    self.executor.generate(
                        arch, params, prompt, c_k, run_steps,
                        self.max_new_tokens, deadline_s=spec.exec_timeout_s)
                return
            except ExecutorFault as err:
                self.pool.exec_failures += 1
                if attempt == attempts:
                    self.pool.exec_gave_up += 1
                    return          # every attempt failed: serve nothing
                self.pool.exec_retries += 1
                with self.tracer.span("executor_retry", cat="serving",
                                      arch=arch, attempt=attempt,
                                      error=type(err).__name__):
                    pass

    def _load(self, server, arch: str) -> None:
        with self.tracer.span("model_load", cat="serving", arch=arch):
            server.params = self.executor.init_params(arch, self._load_gen)
            if self.tracer.enabled:
                self._sync()        # the span times the load
        server.model_name = arch
        self.pool.load_count += 1

    # ------------------------------------------------------------------
    def apply_placement(self, decision) -> None:
        """Materialise a seam placement in the real pool, OFF the timed
        path: evict weights the plan displaced, prefetch the planned
        models (own generator — the `_load` sequence stays identical to a
        placement-free run), and run each placed gang's executor shapes
        once via the warmup machinery. A subsequent matching gang hits
        `_run_task`'s reuse path with the weights already resident — the
        mirror and the pool agree the start is warm."""
        sp = decision.streams[0]            # serving is one physical cluster
        for i in np.flatnonzero(sp.evict):
            s = self.pool.servers[i]
            with self.tracer.span("evict", cat="placement", server=int(i),
                                  arch=s.model_name or ""):
                s.params, s.model_name = None, None
            self.placement_evictions += 1
        warmed = set()
        for i in np.flatnonzero(sp.prefetch):
            arch = self._arch_of(int(sp.model[i]))
            s = self.pool.servers[i]
            if s.model_name != arch or s.params is None:
                s.params = None
                with self.tracer.span("prefetch", cat="placement",
                                      server=int(i), arch=arch):
                    s.params = self.executor.init_params(
                        arch, self._prefetch_gen)
                    s.model_name = arch
                self.placement_prefetches += 1
            # mirror the carry's synthetic gang into the pool bookkeeping,
            # so pool-level reuse queries see the placed gang as complete
            s.gang = int(sp.gang[i])
            s.gang_size = int(sp.gang_size[i])
            c = int(sp.gang_size[i])
            if self.execute and self.warmup and (arch, c) not in warmed:
                warmed.add((arch, c))
                with self.tracer.span("executor_warmup", cat="serving",
                                      arch=arch, c=c):
                    self.executor.warm(arch, self.prompt_len, c,
                                       self.max_new_tokens,
                                       self.max_new_tokens)

    # ------------------------------------------------------------------
    def __call__(self, ecfg: EV.EnvConfig, traces: Dict, policy, params, *,
                 generator: Optional[torch.Generator] = None,
                 num_steps: Optional[int] = None, collect: bool = False,
                 init_state: Optional[EV.EnvState] = None,
                 device=None) -> RolloutResult:
        dev = self.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"serving backend lives on {dev}, asked to run "
                             f"on {device}")
        traces = to_device(traces, dev)
        params = to_device(params, dev)
        B = int(traces["arr_time"].shape[0])
        if B != 1:
            raise ValueError(
                f"serving backend runs ONE physical cluster; got batch {B} "
                "(build the workload with batch/streams=1)")
        if ecfg.num_servers != len(self.pool.servers):
            raise ValueError(
                f"serving pool has {len(self.pool.servers)} servers but "
                f"ecfg.num_servers={ecfg.num_servers}")
        T = int(num_steps) if num_steps else ecfg.max_steps
        gen = torch.Generator(device=dev) if generator is None else generator
        state = (EV.reset(ecfg, 1, device=dev) if init_state is None
                 else to_device(init_state, dev))
        q, obs = EV.reset_view(ecfg, traces, state)
        # the shared actor layer owns the per-decision program (the graph
        # the latency probe measures); its sampler label attributes every
        # decision span
        prog = actor_program(ecfg, policy)
        dkw = {"sampler": prog.sampler} if prog.sampler else {}
        env_step = EK.env_stepper(ecfg, EV.decision_statics(ecfg, traces), 1,
                                  dev)
        model_h = traces["model"][0].cpu().numpy()
        c_h = traces["c"][0].cpu().numpy()
        tr = self.tracer
        zero = torch.zeros((1,), dtype=torch.float32, device=dev)

        done = False
        total = zero.clone()
        length = torch.zeros((1,), dtype=torch.int32, device=dev)
        rows = [] if collect else None
        for t_i in range(T):
            t0 = time.perf_counter()
            with tr.span("decision", cat="serving", step=t_i, **dkw):
                action, extras = prog.act(traces, state, obs, gen, params)
                self._sync()
            self.profile.observe("policy", time.perf_counter() - t0)
            if done and not collect:
                continue        # frozen: the draws are consumed, no more
            t0 = time.perf_counter()
            with tr.span("env_advance", cat="serving", step=t_i):
                nstate, nq, nobs, r, d = env_step(state, action, q)
                info = step_info(state, nstate, d)
            self.profile.observe("env_advance", time.perf_counter() - t0)
            if not done and info.scheduled and info.failed:
                # the mirror says a selected server crashes mid-run: the
                # gang aborts, so no real execution happens for this task
                self.pool.crashed_tasks += 1
            elif not done and info.scheduled:
                k = info.task
                m_k, c_k = int(model_h[k]), int(c_h[k])
                with tr.span("execute_task", cat="serving", step=t_i,
                             task=k, arch=self._arch_of(m_k), c=c_k,
                             steps=info.steps, reuse=info.reuse):
                    busy = self._run_task(m_k, c_k, info.steps, info.sel,
                                          info.reuse)
                self.profile.observe("executor", busy)
                if self.wall_clock:
                    self.measured_busy.append(busy)
                    with tr.span("wall_patch", cat="serving", step=t_i,
                                 busy_s=busy):
                        nstate, nq, nobs, r, d = wall_patch(
                            ecfg, traces, q, nstate, k,
                            torch.from_numpy(info.sel).to(dev)[None],
                            torch.tensor([busy], dtype=torch.float32,
                                         device=dev))
                        info = info._replace(done=bool(d[0]))
            if done:       # frozen episode: replay the carried state
                nstate, nq, nobs, r = state, q, obs, zero
            if collect:
                rows.append((obs, action, r, nobs, d.to(torch.float32),
                             not done, extras))
            total = total + r
            length = length + (0 if done else 1)
            state, q, obs = nstate, nq, nobs
            done = done or info.done

        metrics = dict(EV.episode_metrics(ecfg, traces, state))
        metrics["episode_return"] = total
        metrics["episode_len"] = length
        transitions = self._stack(rows, dev) if collect else None
        return RolloutResult(metrics=metrics, final_state=state,
                             transitions=transitions)

    @staticmethod
    def _stack(rows, dev) -> Transitions:
        """Per-decision rows -> the (B=1, T, ...) layout every simulated
        backend emits, so `sac.flatten_valid_transitions` consumes it
        unchanged."""
        def stk(xs):
            return torch.stack(list(xs), dim=1)
        extras = {}
        if rows and rows[0][6]:
            extras = {k: stk(r[6][k] for r in rows) for k in rows[0][6]}
        return Transitions(
            obs=stk(r[0] for r in rows), action=stk(r[1] for r in rows),
            reward=stk(r[2] for r in rows), next_obs=stk(r[3] for r in rows),
            done=stk(r[4] for r in rows),
            valid=torch.tensor([[r[5] for r in rows]], dtype=torch.bool,
                               device=dev),
            extras=extras)


def serving_rollout(spec, *, device=None) -> "_LazyServing":
    """Build the serving backend for an `ExecSpec(backend="serving")`.

    Fresh state per call: each Simulator / StreamRunner / trainer gets its
    own pool, which then persists across that consumer's windows and rounds.
    Pool size is deferred to the first call's `ecfg.num_servers` (the spec
    does not know the workload) and fixed thereafter; the archs are checked
    here, at once.
    """
    return _from_spec(spec, device=device)


class _LazyServing:
    """Defers pool construction to the first call (the spec does not know
    num_servers; the workload's ecfg does)."""
    backend = "serving"

    def __init__(self, spec, device):
        self.spec = spec
        self.device = device
        self.inner: Optional[ServingRollout] = None
        self.wall_clock = spec.serving_wall_clock

    def _ensure(self, num_servers: int, device) -> ServingRollout:
        if self.inner is None:
            spec = self.spec
            self.inner = ServingRollout(
                num_servers, archs=spec.serving_archs,
                reduced=spec.serving_reduced,
                wall_clock=spec.serving_wall_clock,
                execute=spec.serving_execute,
                prompt_len=spec.serving_prompt_len,
                max_new_tokens=spec.serving_max_new_tokens,
                seed=spec.serving_seed, warmup=spec.serving_warmup,
                tracer=tracer_for(spec.trace), faults=spec.faults,
                device=self.device if device is None else device)
        return self.inner

    def __call__(self, ecfg, traces, policy, params, *, device=None, **kw):
        return self._ensure(ecfg.num_servers, device)(
            ecfg, traces, policy, params, device=device, **kw)

    def reset(self):
        if self.inner is not None:
            self.inner.reset()

    def serving_stats(self):
        return self.inner.serving_stats() if self.inner else {}

    def pool_counters(self):
        return self.inner.pool_counters() if self.inner else {}

    def fault_counters(self):
        return self.inner.fault_counters() if self.inner else {}

    def apply_placement(self, decision):
        if self.inner is not None:      # placement fires after the
            self.inner.apply_placement(decision)   # first window ran

    def placement_counters(self):
        return self.inner.placement_counters() if self.inner else {}


def _from_spec(spec, *, device=None) -> _LazyServing:
    check_archs(spec.serving_archs or ASSIGNED_ARCHS, spec.serving_reduced)
    return _LazyServing(spec, device)
