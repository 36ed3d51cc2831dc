"""Batched rollout engine (port of `repro/core/rollout.py`, the fused
engine of Algorithm 1's loop).

Each decision does three things for all B envs at once: the policy acts on
the observation, one fused env-step op (`kernels/env_step`, one kernel
launch on the card, through an `EnvStepPlan` built once per rollout)
advances the envs and returns the next queue and observation, and finished
envs are frozen with `where(done, old, new)`. The policy's
`actors.program.ActorProgram` owns that decision: on the card it is
captured once as a CUDA graph and replayed, as the reference compiles its
scan body into one program. `rollout_episode` and `fused=False` are the
unfused engine on the compositional `env.step_with_queue`.

Policy protocol
---------------
    policy(params, generator, traces, state, obs) -> (action (B, A), extras)

`action` is in env space [0, 1]; `extras` is a dict of per-step tensors
that comes back stacked in `Transitions.extras`. A policy that draws takes
its numbers from the rollout's `torch.Generator`; `sequence_policy` replays
draws or actions the caller supplies instead.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import env as EV
from repro_torch.kernels.env_step import ops as EK

Policy = Callable[..., Any]


class Transitions(NamedTuple):
    """Stacked per-step records, (B, T, ...)."""
    obs: torch.Tensor        # (B, T, 3, E+l) observation before the action
    action: torch.Tensor     # (B, T, A) env-space action in [0, 1]
    reward: torch.Tensor     # (B, T) f32, 0 after episode end
    next_obs: torch.Tensor   # (B, T, 3, E+l)
    done: torch.Tensor       # (B, T) f32 done flag after this step
    valid: torch.Tensor      # (B, T) bool, step executed before episode end
    extras: Dict[str, torch.Tensor]


class RolloutResult(NamedTuple):
    metrics: Dict[str, torch.Tensor]   # episode_metrics + return + length
    final_state: EV.EnvState
    transitions: Optional[Transitions]


def _freeze(done, new, old):
    """where(done, old, new) for every field, done (B,) broadcast."""
    return type(new)(*(torch.where(done.reshape(done.shape + (1,) * (n.ndim - 1)),
                                   o, n) for n, o in zip(new, old)))


def _loop(ecfg: EV.EnvConfig, traces: Dict, policy: Policy, params, gen,
          T: int, collect: bool, state: EV.EnvState, step) -> RolloutResult:
    """The eager decision loop: T decisions of `policy` and
    `step(state, action, queue) -> (state', queue', obs', reward, done)`,
    finished envs frozen."""
    B = traces["arr_time"].shape[0]
    dev = traces["arr_time"].device
    q, obs = EV.reset_view(ecfg, traces, state)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    total = torch.zeros((B,), dtype=torch.float32, device=dev)
    length = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps = []
    for _ in range(T):
        action, extras = policy(params, gen, traces, state, obs)
        nstate, nq, nobs, r, d = step(state, action, q)
        nstate = _freeze(done, nstate, state)
        nq = _freeze(done, nq, q)
        nobs = torch.where(done[:, None, None], obs, nobs)
        r = torch.where(done, 0.0, r)
        valid = ~done
        if collect:
            steps.append(Transitions(obs=obs, action=action, reward=r,
                                     next_obs=nobs, done=d.to(torch.float32),
                                     valid=valid, extras=extras))
        state, q, obs = nstate, nq, nobs
        done = done | d
        total = total + r
        length = length + valid.to(torch.int32)
    metrics = dict(EV.episode_metrics(ecfg, traces, state))
    metrics["episode_return"] = total
    metrics["episode_len"] = length
    traj = None
    if collect:
        traj = Transitions(
            *(torch.stack([getattr(s, f) for s in steps], dim=1)
              for f in Transitions._fields[:-1]),
            extras={k: torch.stack([s.extras[k] for s in steps], dim=1)
                    for k in steps[0].extras})
    return RolloutResult(metrics=metrics, final_state=state, transitions=traj)


def batch_rollout(ecfg: EV.EnvConfig, traces: Dict, policy: Policy, params,
                  *, generator: Optional[torch.Generator] = None,
                  num_steps: Optional[int] = None, collect: bool = False,
                  init_state: Optional[EV.EnvState] = None, device=None,
                  impl: str = "auto", fused: bool = True,
                  graph: bool = True) -> RolloutResult:
    """B episodes stepped together.

    `traces`: dict of (B, K) tensors (`workload.make_trace_batch`);
    `params` is shared by every env; `init_state`, when given, carries the
    (B,) axis and each env resumes from it. Traces, params and state are
    moved to `device` (None: the CUDA device; raises without one). `impl`
    picks the env step: "auto" (the kernel on the card, the plain version
    on the CPU) or "ref" (the plain version anywhere).

    The fused engine (the default) runs the decision of the policy's
    `actors.program.ActorProgram`: its body reads and writes two fixed
    sets of buffers in turn, and on the card every decision after the
    first replays a CUDA graph of it; on the CPU the same body runs
    eagerly. `graph=False` runs the eager loop instead, on the card too:
    it exists to measure the graph against it, and no path of the package
    passes it. `fused=False` is the unfused engine on the compositional
    `env.step_with_queue` (`impl` and `graph` do not apply); all three
    give equal results on the same inputs.

    The loop runs `num_steps` (default `max_steps`) decisions; an env that
    is done stays frozen, as in the reference."""
    dev = resolve_device(device)
    traces = to_device(traces, dev)
    params = to_device(params, dev)
    B = traces["arr_time"].shape[0]
    T = int(num_steps) if num_steps else ecfg.max_steps
    gen = torch.Generator(device=dev) if generator is None else generator
    state = (EV.reset(ecfg, B, device=dev) if init_state is None
             else to_device(init_state, dev))
    if not fused:
        def step(st, action, q):
            return EV.step_with_queue(ecfg, traces, st, q, action)[:5]
        return _loop(ecfg, traces, policy, params, gen, T, collect, state,
                     step)
    if graph:
        from repro_torch.actors.program import actor_program
        return actor_program(ecfg, policy).rollout(
            traces, params, gen, state, num_steps=T, collect=collect,
            impl=impl)
    statics = EV.decision_statics(ecfg, traces)
    return _loop(ecfg, traces, policy, params, gen, T, collect, state,
                 EK.env_stepper(ecfg, statics, B, dev, impl=impl))


def rollout_episode(ecfg: EV.EnvConfig, trace: Dict, policy: Policy, params,
                    *, generator: Optional[torch.Generator] = None,
                    num_steps: Optional[int] = None, collect: bool = False,
                    init_state: Optional[EV.EnvState] = None,
                    device=None) -> RolloutResult:
    """One episode on one trace (a dict of (K,) tensors): the unfused
    engine on a batch of one, returned without the batch axis (metrics
    0-d, transitions (T, ...)). `init_state` (unbatched) resumes from a
    carried state."""
    dev = resolve_device(device)
    traces = {k: v[None] for k, v in to_device(trace, dev).items()}
    st0 = (None if init_state is None else
           EV.EnvState(*(x[None] for x in to_device(init_state, dev))))
    res = batch_rollout(ecfg, traces, policy, params, generator=generator,
                        num_steps=num_steps, collect=collect,
                        init_state=st0, device=dev, fused=False)
    tr = None
    if collect:
        t = res.transitions
        tr = Transitions(*(getattr(t, f)[0] for f in Transitions._fields[:-1]),
                         extras={k: v[0] for k, v in t.extras.items()})
    return RolloutResult(
        metrics={k: v[0] for k, v in res.metrics.items()},
        final_state=EV.EnvState(*(x[0] for x in res.final_state)),
        transitions=tr)


# ----------------------------------------------------------------------
# policy factories, cached on their arguments as the reference's are: a
# policy's identity keys its `actors.program.ActorProgram` (and the CUDA
# graphs it holds), so the same arguments must give the same callable
@functools.lru_cache(maxsize=None)
def uniform_policy(ecfg: EV.EnvConfig) -> Policy:
    """Random baseline: uniform env-space action (paper §VI.A.3 Random).
    To replay given uniform draws, use `sequence_policy`."""
    def policy(params, generator, traces, state, obs):
        B = obs.shape[0]
        return torch.rand((B, ecfg.action_dim), generator=generator,
                          device=obs.device), {}
    return policy


@functools.lru_cache(maxsize=None)
def greedy_policy(ecfg: EV.EnvConfig) -> Policy:
    """Greedy baseline: immediate quality-first candidate search
    (`core.baselines.greedy_act`)."""
    from repro_torch.core import baselines as BL

    def policy(params, generator, traces, state, obs):
        return BL.greedy_act(ecfg, traces, state), {}
    return policy


@functools.lru_cache(maxsize=None)
def sequence_policy(ecfg: EV.EnvConfig) -> Policy:
    """Replay a given action sequence by decision index: env b at decision
    i plays `params["seq"][b, i]` ((B, T, A) in env space; clamped at the
    end), or `params["seq"][i]` for every env when the sequence is one
    (T, A) schedule (the reference's unbatched params). This is how a
    schedule optimised offline (genetic, harmony) or a teacher's collected
    actions run through the rollout."""
    def policy(params, generator, traces, state, obs):
        seq = params["seq"]
        idx = torch.clamp(state.steps_taken.to(torch.int64),
                          max=seq.shape[-2] - 1)
        if seq.ndim == 2:
            return seq[idx], {}
        return seq[torch.arange(seq.shape[0], device=seq.device), idx], {}
    return policy


@functools.lru_cache(maxsize=None)
def fifo_policy(ecfg: EV.EnvConfig, steps_frac: float = 0.5) -> Policy:
    """FIFO baseline: always try the earliest-arrived visible task (queue
    slot 0) at a fixed inference-step fraction; when its gang does not fit,
    the env no-ops and time advances (head-of-line blocking)."""
    def policy(params, generator, traces, state, obs):
        a = torch.zeros((obs.shape[0], ecfg.action_dim), device=obs.device)
        a[:, 1] = steps_frac
        a[:, 2] = 1.0                       # a_c = 0 (execute), slot 0
        return a, {}
    return policy
