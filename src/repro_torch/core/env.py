"""Edge-cluster gang-scheduling environment (paper §IV–V.A; port of
`repro/core/env.py`), batched: every state tensor carries a leading (B,)
env axis, written out rather than vmapped.

The MDP is event-driven: if the agent schedules a task, time stays put;
otherwise time advances to the next event (arrival, completion or, with
faults, recovery). Observation (Eq. 6) is the 3 x (E + l) matrix of
`core.obs`; the action (Eq. 8) is [a_c, a_s, a_k1..a_kl] in [0, 1]^(2+l);
the reward is alpha_q q - lambda_q I + k_time / (beta_t t_r + mu_t t_wait).

Exactness. Eager PyTorch rounds every operation on its own, so with the
reference's operation order the clock (`time`, `server_free_at`,
`task_start`, `task_finish`) and every integer and boolean come out equal
to the reference's. Scalar constants are rounded to f32 once, as JAX does
with a weak-typed Python float. The one reordered float is the sum over K in
the reward's `t_avg`, so the reward is held to a tolerance.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import quality as Q
from repro_torch.core import timemodel as TM
from repro_torch.core.obs import (INF, QueueView, observe_from, server_down,
                                  visible_queue)

__all__ = ["INF", "QueueView", "observe_from", "server_down", "visible_queue",
           "EnvConfig", "EnvState", "FAULT_COLS", "has_faults", "reset",
           "observe", "decision_step", "step", "step_with_queue",
           "reset_view", "decision_statics", "episode_metrics"]

#: fault-schedule trace columns: f_down_start / f_down_end (B, E, F) crash
#: intervals, f_slow (B, E) straggler multipliers, f_cold (B, 1) cold-restart
#: flag. Their presence in the trace dict switches the step into fault mode.
FAULT_COLS = ("f_down_start", "f_down_end", "f_slow", "f_cold")


def has_faults(trace: Dict) -> bool:
    """Fault columns attached?"""
    return "f_down_start" in trace


@dataclass(frozen=True)
class EnvConfig:
    num_servers: int = 8
    queue_window: int = 8              # l: visible queue slots
    s_min: int = 10
    s_max: int = 50
    max_tasks: int = 32                # K per episode
    time_limit: float = 1024.0
    max_steps: int = 1024              # decision-step limit
    alpha_q: float = 10.0
    beta_t: float = 0.1
    mu_t: float = 0.1
    k_time: float = 10.0
    lambda_q: float = 1.0
    p_quality: float = 2.0
    q_min: float = 0.23
    time_scale: float = 60.0
    num_models: int = 1                # distinct services; 1 = paper's SD-only
    model_scale: Tuple[float, ...] = ()  # per-model exec-time scale

    @property
    def action_dim(self) -> int:
        return 2 + self.queue_window

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (3, self.num_servers + self.queue_window)

    def scales(self, device=None) -> torch.Tensor:
        vals = self.model_scale or (1.0,) * self.num_models
        return torch.tensor(vals, dtype=torch.float32, device=device)


class EnvState(NamedTuple):
    time: torch.Tensor            # (B,) f32
    server_free_at: torch.Tensor  # (B, E) f32 absolute
    server_model: torch.Tensor    # (B, E) i32, -1 = none
    server_gang: torch.Tensor     # (B, E) i32 task id of last gang, -1 = none
    server_gang_size: torch.Tensor  # (B, E) i32
    task_status: torch.Tensor     # (B, K) i32 0=unscheduled 1=running 2=done
                                  #             3=failed (fault mode only)
    task_start: torch.Tensor      # (B, K) f32
    task_finish: torch.Tensor     # (B, K) f32
    task_steps: torch.Tensor      # (B, K) i32
    task_quality: torch.Tensor    # (B, K) f32
    task_reload: torch.Tensor     # (B, K) i32 1 = had to (re)init
    steps_taken: torch.Tensor     # (B,) i32


def reset(cfg: EnvConfig, batch: int, *, device=None) -> EnvState:
    dev = resolve_device(device)
    E, K = cfg.num_servers, cfg.max_tasks

    def full(shape, val, dtype):
        return torch.full((batch,) + shape, val, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return EnvState(
        time=full((), 0.0, f32), server_free_at=full((E,), 0.0, f32),
        server_model=full((E,), -1, i32), server_gang=full((E,), -1, i32),
        server_gang_size=full((E,), 0, i32), task_status=full((K,), 0, i32),
        task_start=full((K,), 0.0, f32), task_finish=full((K,), 0.0, f32),
        task_steps=full((K,), 0, i32), task_quality=full((K,), 0.0, f32),
        task_reload=full((K,), 0, i32), steps_taken=full((), 0, i32))


# ----------------------------------------------------------------------
def observe(cfg: EnvConfig, trace: Dict, state: EnvState) -> torch.Tensor:
    """Eq.-6 state matrix, normalised: (B, 3, E+l)."""
    return observe_from(cfg, trace, state, visible_queue(cfg, trace, state))


# ----------------------------------------------------------------------
def _select_servers(cfg: EnvConfig, state: EnvState, idle, m_k, c_k):
    """(selected mask (B, E), reuse flag (B,)). Greedy §V.B.4.

    A complete idle gang with the task's model and size is reused; otherwise
    the c_k idle servers that break the fewest intact gangs are taken. The
    reference ranks by argsort; ranking by counting strictly smaller scores
    is the same wherever it is read (idle scores are unique thanks to the
    0.001 * index tie-breaker, busy servers sit at INF)."""
    E = cfg.num_servers
    gang = state.server_gang
    gsize = state.server_gang_size
    has_gang = gang >= 0
    same = gang[:, :, None] == gang[:, None, :]                 # (B, E, E)
    m_k, c_k = m_k[:, None], c_k[:, None]

    ok = idle & has_gang & (state.server_model == m_k) & (gsize == c_k)
    counts = (same & ok[:, None, :]).sum(2)
    complete = ok & (counts == c_k)
    any_reuse = complete.any(1)
    g_star = torch.where(complete, gang, 2 ** 30).amin(1, keepdim=True)
    reuse_sel = ok & (gang == g_star)

    member_ok = idle & has_gang
    counts_all = (same & member_ok[:, None, :]).sum(2)
    intact = member_ok & (counts_all == gsize) & (gsize > 0)
    iota = torch.arange(E, device=gang.device)
    score = torch.where(idle, intact.to(torch.float32) * (100.0 + 10.0 * gsize)
                        + 0.001 * iota, INF)
    rank = (score[:, None, :] < score[:, :, None]).sum(2)
    fresh_sel = idle & (rank < c_k)
    return torch.where(any_reuse[:, None], reuse_sel, fresh_sel), any_reuse


def _decide(cfg: EnvConfig, st: Dict, state: EnvState, action, q: QueueView):
    """One decision for B envs from the per-task statics `st`
    (`decision_statics`). Returns (state', reward, done, info)."""
    K, l = cfg.max_tasks, cfg.queue_window
    dev = action.device
    t = state.time
    tc = t[:, None]
    faulty = has_faults(st)
    # lazily retire finished tasks
    finished = (state.task_status == 1) & (state.task_finish <= tc)
    status = torch.where(finished, 2, state.task_status)

    if faulty:
        ds, de = st["f_down_start"], st["f_down_end"]             # (B, E, F)
        t3 = t[:, None, None]
        down = ((ds <= t3) & (t3 < de)).any(2)
        # cold restart: a server whose crash has begun loses its cached
        # model and gang metadata
        wipe = (ds <= t3).any(2) & (st["f_cold"][:, :1] > 0)
        state = state._replace(
            server_model=torch.where(wipe, -1, state.server_model),
            server_gang=torch.where(wipe, -1, state.server_gang),
            server_gang_size=torch.where(wipe, 0, state.server_gang_size))

    # visible-queue slot pick: first-match argmax over preference scores;
    # a NaN score counts as the largest, as in jnp.argmax, so slot < l
    iota_l = torch.arange(l, device=dev)
    scores = torch.where(q.valid, action[:, 2:], -INF)
    smax = scores.amax(1, keepdim=True)
    slot = torch.minimum(
        torch.where(scores.isnan(), iota_l, l).amin(1, keepdim=True),
        torch.where(scores == smax, iota_l, l).amin(1, keepdim=True))
    k = q.idx.gather(1, slot)                                     # (B, 1) i32
    k64 = k.to(torch.int64)
    k_valid = q.valid.gather(1, slot)[:, 0]

    def pick(a):
        return a.gather(1, k64)[:, 0]

    want_exec = action[:, 0] <= 0.5
    c_k = pick(st["c"])
    m_k = pick(st["model"])
    scale_k = pick(st["scale"])
    idle = state.server_free_at <= tc
    if faulty:                       # a down server cannot join a gang
        idle = idle & ~down
    n_idle = idle.sum(1)
    feasible = want_exec & k_valid & (n_idle >= c_k)

    sel, reuse = _select_servers(cfg, state, idle, m_k, c_k)
    # a NaN step knob gives 0 steps, as XLA's float-to-int conversion does
    steps = torch.round(cfg.s_min + torch.clamp(action[:, 1], 0.0, 1.0)
                        * (cfg.s_max - cfg.s_min))
    steps = steps.nan_to_num(0.0).to(torch.int32)
    t_exec = pick(st["step_base"]) * steps.to(torch.float32) * scale_k
    if faulty:                       # gang speed = slowest member's speed
        t_exec = t_exec * torch.where(sel, st["f_slow"], 1.0).amax(1)
    t_init = torch.where(reuse, 0.0, pick(st["init_base"]) * scale_k)
    finish = t + t_exec + t_init
    q_k = Q.quality_of(steps, pick(st["noise"]))
    pen = Q.quality_penalty(q_k, cfg.q_min, cfg.p_quality)
    t_resp = finish - pick(st["arr_time"])

    if faulty:
        # in-flight failure: a selected server crashes before the gang
        # finishes -> the gang aborts at the first crash (status 3, servers
        # freed at the crash, no reward)
        crash_cand = sel[:, :, None] & (ds > t3) & (ds < finish[:, None, None])
        crash_t = torch.where(crash_cand, ds, INF).amin((1, 2))
        will_fail = crash_t < INF
        sched_status = torch.where(will_fail, 3, 1).to(torch.int32)[:, None]
        rec_finish = torch.where(will_fail, crash_t, finish)
    else:
        sched_status, rec_finish = 1, finish

    # --- apply schedule (masked) -------------------------------------
    f = feasible
    sel_f = sel & f[:, None]
    new_free = torch.where(sel_f, rec_finish[:, None], state.server_free_at)
    new_model = torch.where(sel_f, m_k[:, None], state.server_model)
    new_gang = torch.where(sel_f, k, state.server_gang)
    new_gsize = torch.where(sel_f, c_k[:, None], state.server_gang_size)

    iota_K = torch.arange(K, device=dev)
    hit = (iota_K == k64) & f[:, None]
    status2 = torch.where(hit, sched_status, status)
    start2 = torch.where(hit, tc, state.task_start)
    tfin2 = torch.where(hit, rec_finish[:, None], state.task_finish)
    tsteps2 = torch.where(hit, steps[:, None], state.task_steps)
    tq2 = torch.where(hit, q_k[:, None], state.task_quality)
    trl2 = torch.where(hit, (~reuse).to(torch.int32)[:, None],
                       state.task_reload)

    # reward (only on a successful schedule)
    arr = st["arr_time"]
    still_queued = q.queued & (iota_K != k64)
    n_q = torch.clamp(still_queued.to(torch.float32).sum(1), min=1.0)
    t_avg = torch.where(still_queued, tc - arr, 0.0).sum(1) / n_q
    denom = cfg.beta_t * t_resp + cfg.mu_t * t_avg + 1e-3
    # true division: `scalar / tensor` would be a reciprocal times scalar
    r = (cfg.alpha_q * q_k - cfg.lambda_q * pen
         + torch.div(torch.full_like(denom, cfg.k_time), denom))
    reward = torch.where(f, r, 0.0)
    if faulty:                       # a gang that will crash earns nothing
        reward = torch.where(will_fail, 0.0, reward)

    # --- advance time on no-op ----------------------------------------
    next_arrival = torch.where(arr > tc, arr, INF).amin(1)
    next_completion = torch.where(new_free > tc, new_free, INF).amin(1)
    next_event = torch.minimum(next_arrival, next_completion)
    if faulty:                       # recoveries are events too
        next_recovery = torch.where((ds <= t3) & (de > t3), de, INF).amin((1, 2))
        next_event = torch.minimum(next_event, next_recovery)
    t_new = torch.where(f, t, torch.where(next_event < INF, next_event,
                                          t + 1.0))

    new_state = EnvState(
        time=t_new, server_free_at=new_free, server_model=new_model,
        server_gang=new_gang, server_gang_size=new_gsize,
        task_status=status2, task_start=start2, task_finish=tfin2,
        task_steps=tsteps2, task_quality=tq2, task_reload=trl2,
        steps_taken=state.steps_taken + 1)
    resolved = (status2 == 2) | ((status2 == 1) & (tfin2 <= t_new[:, None]))
    if faulty:                       # failed tasks are resolved (host retries)
        resolved = resolved | (status2 == 3)
    done = (resolved.all(1) | (t_new >= cfg.time_limit)
            | (new_state.steps_taken >= cfg.max_steps))
    info = {"scheduled": f, "task": k[:, 0], "reuse": reuse & f,
            "steps": steps, "quality": torch.where(f, q_k, 0.0),
            "response": torch.where(f, t_resp, 0.0)}
    if faulty:
        info["failed"] = f & will_fail
    return new_state, reward, done, info


def decision_step(cfg: EnvConfig, trace: Dict, state: EnvState, action,
                  q: QueueView):
    """The per-decision state transition for B envs.

    `q` must be `visible_queue(cfg, trace, state)`. Returns
    (state', reward (B,), done (B,), info); the caller owns the next
    observation."""
    return _decide(cfg, decision_statics(cfg, trace), state, action, q)


def step(cfg: EnvConfig, trace: Dict, state: EnvState, action):
    """One decision for B envs, the queue view taken from `state`.
    Returns (state', obs', reward, done, info), as `step_with_queue` gives
    them."""
    q = visible_queue(cfg, trace, state)
    new_state, reward, done, info = decision_step(cfg, trace, state, action, q)
    return new_state, observe(cfg, trace, new_state), reward, done, info


def step_with_queue(cfg: EnvConfig, trace: Dict, state: EnvState,
                    q: QueueView, action):
    """One decision plus the next queue view and observation.
    Returns (state', queue', obs', reward, done, info)."""
    new_state, reward, done, info = decision_step(cfg, trace, state, action, q)
    q2 = visible_queue(cfg, trace, new_state)
    obs2 = observe_from(cfg, trace, new_state, q2)
    return new_state, q2, obs2, reward, done, info


def reset_view(cfg: EnvConfig, trace: Dict, state: EnvState):
    """(queue, obs) of a (possibly carried) state: the rollout's carry seed."""
    q = visible_queue(cfg, trace, state)
    return q, observe_from(cfg, trace, state, q)


# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _tables(cfg: EnvConfig, device: torch.device):
    """(step time, init time by log2 c, per-model scale) on `device`,
    copied there once: a decision computed inside a CUDA graph capture (the
    greedy baseline's) may not copy from the host."""
    return (TM.STEP_TIME.to(device), TM.INIT_TIME.to(device),
            cfg.scales(device))


def decision_statics(cfg: EnvConfig, trace: Dict) -> Dict[str, torch.Tensor]:
    """Per-task constants of the decision step, hoisted out of the rollout
    loop; all (B, K), plus the fault columns when the trace has them."""
    c = trace["c"]
    li = TM._log2i(c)
    step_time, init_time, scales = _tables(cfg, c.device)
    out = {
        "arr_time": trace["arr_time"],
        "c": c,
        "model": trace["model"],
        "noise": trace["noise"],
        "step_base": step_time[li],                   # s / inference step
        "init_base": init_time[li],                   # model (re)load s
        "scale": scales[trace["model"].to(torch.int64)],
    }
    if has_faults(trace):
        for col in FAULT_COLS:
            out[col] = trace[col]
    return out


# ----------------------------------------------------------------------
def episode_metrics(cfg: EnvConfig, trace: Dict, state: EnvState) -> Dict:
    """Per-env aggregates matching the paper's Tables IX/X/XI, each (B,).

    In fault mode crashed tasks (status 3) are left out of the averages and
    counted as `num_failed`."""
    st = state.task_status
    sched = ((st == 1) | (st == 2)) if has_faults(trace) else st >= 1
    f32, i32 = torch.float32, torch.int32
    n = torch.clamp(sched.to(f32).sum(1), min=1.0)
    resp = torch.where(sched, state.task_finish - trace["arr_time"], 0.0)
    out = {
        "num_scheduled": sched.sum(1).to(i32),
        "num_done": (st == 2).sum(1).to(i32),
        "avg_quality": torch.where(sched, state.task_quality, 0.0).sum(1) / n,
        "avg_response": resp.sum(1) / n,
        "reload_rate": torch.where(sched, state.task_reload, 0).to(f32).sum(1) / n,
        "avg_steps": torch.where(sched, state.task_steps, 0).to(f32).sum(1) / n,
    }
    if has_faults(trace):
        out["num_failed"] = (st == 3).sum(1).to(i32)
    return out
