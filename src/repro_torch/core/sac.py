"""EAT training (paper Algorithm 2; port of `repro/core/sac.py`): SAC with
double critics and target nets.

Actor loss (Eq. 15/16): maximise min-Q(s, a_theta(s)) + alpha H(N(mu,
sigma^2)), with gradients flowing through the T-step diffusion chain
(reparameterised; the plain differentiable `diffusion.reverse_sample`, as
in the reference: the chain kernel serves inference only). Critic loss
(Eq. 19/20): TD toward r + gamma min target-Q(s', a'(s')). Soft target
update (Eq. 22) with rate tau. Hyper-parameters from Table VIII.

Params are nested dicts of tensors; gradients come from
`torch.autograd.grad` over their leaves and the optimizer is the
reference's functional Adam (`training.optimizer`). Every draw of
`update_step` can be passed in (`draws`), else it comes from the
generator. Collection runs through the API facade's backends (the fused
`batch_rollout` by default), so on the card every decision launches the
env-step and chain kernels; replay stays on the host.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.actors import policies as POL
from repro_torch.common.device import resolve_device, to_device
from repro_torch.common.pytree import tree_map
from repro_torch.core import agent as AG
from repro_torch.core import diffusion as DF
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO
from repro_torch.core.replay import ReplayBuffer
from repro_torch.training.optimizer import (AdamState, adam_init, adam_update,
                                            apply_updates, value_and_grad)

#: names of the injectable draws of `update_step`: the critic target's
#: a_next (x_T, chain noises, eps on next_obs), the actor's (on obs) and
#: bc_loss's timestep indices and noise
DRAWS = ("next_x_T", "next_noises", "next_eps", "x_T", "noises", "eps",
         "bc_i", "bc_noise")


@dataclass(frozen=True)
class SACConfig:
    actor_lr: float = 3e-4        # eta_a
    critic_lr: float = 3e-4       # eta_c
    gamma: float = 0.95
    tau: float = 0.005
    batch_size: int = 512
    buffer_capacity: int = 1_000_000
    updates_per_step: int = 1
    update_every: int = 1         # gradient updates every N env steps
    warmup_steps: int = 256
    weight_decay: float = 1e-4    # lambda (Table VIII)
    bc_coef: float = 0.0          # optional diffusion BC regulariser


class TrainState(NamedTuple):
    actor: Any
    critic1: Any
    critic2: Any
    target1: Any
    target2: Any
    opt_actor: AdamState
    opt_critic1: AdamState
    opt_critic2: AdamState
    step: torch.Tensor            # () int32


def init_train_state(ecfg: EV.EnvConfig, acfg: AG.AgentConfig, *,
                     generator=None, device=None) -> TrainState:
    """Fresh actor and critics drawn from `generator`; the targets are
    copies of the critics."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    actor = AG.init_actor(ecfg, acfg, generator=gen, device=dev)
    c1 = AG.init_critic(ecfg, generator=gen, device=dev)
    c2 = AG.init_critic(ecfg, generator=gen, device=dev)
    return TrainState(
        actor=actor, critic1=c1, critic2=c2,
        target1=tree_map(torch.clone, c1), target2=tree_map(torch.clone, c2),
        opt_actor=adam_init(actor), opt_critic1=adam_init(c1),
        opt_critic2=adam_init(c2),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def _soft_update(target, online, tau: float):
    return tree_map(lambda t, o: (1 - tau) * t + tau * o, target, online)


def host_rng(generator: torch.Generator) -> np.random.Generator:
    """Host-side RNG (replay sampling) seeded from four 32-bit draws of the
    torch generator, never from the raw integer seed, which would couple
    replay sampling to network initialisation across seeds."""
    bits = torch.randint(0, 2 ** 32, (4,), generator=generator,
                         dtype=torch.int64, device=generator.device)
    return np.random.default_rng(bits.tolist())


def update_step(ts: TrainState, batch: Dict, *, ecfg: EV.EnvConfig,
                acfg: AG.AgentConfig, scfg: SACConfig, generator=None,
                draws: Optional[Dict] = None,
                sched: Optional[DF.DiffusionSchedule] = None
                ) -> Tuple[TrainState, Dict]:
    """One SAC update on `batch` (obs, action (agent space), reward,
    next_obs, done tensors on the train state's device), in the
    reference's order: both critics take an Adam step toward the target
    built from `a_next ~ actor(next_obs)`; the actor loss is then taken
    against the UPDATED critics and the actor takes its step; then the
    soft target update. `draws` (keys of `DRAWS`) replaces any of the
    draws, which otherwise come from `generator` in that order. Returns
    (train state', metrics): critic_loss, actor_loss, q_mean, entropy,
    q_batch, as 0-d tensors."""
    d = draws or {}
    unknown = set(d) - set(DRAWS)
    if unknown:
        raise ValueError(f"unknown draws {sorted(unknown)}; use {DRAWS}")
    obs, act, rew = batch["obs"], batch["action"], batch["reward"]
    nobs, done = batch["next_obs"], batch["done"]
    if sched is None:
        sched = DF.vp_schedule(acfg.T, device=obs.device)

    # ---- critic update ------------------------------------------------
    with torch.no_grad():     # y is a fixed target (stop_gradient)
        a_next, _, _, _ = AG.actor_sample(
            ts.actor, acfg, ecfg, sched, nobs, generator=generator,
            x_T=d.get("next_x_T"), noises=d.get("next_noises"),
            eps=d.get("next_eps"))
        q1t = AG.critic_apply(ts.target1, nobs, a_next)
        q2t = AG.critic_apply(ts.target2, nobs, a_next)
        y = rew + scfg.gamma * (1.0 - done) * torch.minimum(q1t, q2t)

    def critic_loss(cp):
        q = AG.critic_apply(cp, obs, act)
        return torch.mean(torch.square(y - q)), q.detach()

    l1, q1, g1 = value_and_grad(critic_loss, ts.critic1)
    l2, _, g2 = value_and_grad(critic_loss, ts.critic2)
    u1, oc1 = adam_update(g1, ts.opt_critic1, ts.critic1, scfg.critic_lr,
                          weight_decay=scfg.weight_decay)
    u2, oc2 = adam_update(g2, ts.opt_critic2, ts.critic2, scfg.critic_lr,
                          weight_decay=scfg.weight_decay)
    c1 = apply_updates(ts.critic1, u1)
    c2 = apply_updates(ts.critic2, u2)

    # ---- actor update (Eq. 15/16) -------------------------------------
    def actor_loss(ap):
        a, _, _, ent = AG.actor_sample(
            ap, acfg, ecfg, sched, obs, generator=generator,
            x_T=d.get("x_T"), noises=d.get("noises"), eps=d.get("eps"))
        q = torch.minimum(AG.critic_apply(c1, obs, a),
                          AG.critic_apply(c2, obs, a))
        loss = -torch.mean(q + acfg.entropy_alpha * ent)
        if scfg.bc_coef > 0.0 and acfg.policy == "diffusion":
            f_s = AG._encode(ap, acfg, obs)
            loss = loss + scfg.bc_coef * DF.bc_loss(
                ap["denoiser"], sched, f_s, act, generator=generator,
                i=d.get("bc_i"), noise=d.get("bc_noise"))
        return loss, (torch.mean(q).detach(), torch.mean(ent).detach())

    la, (qm, entm), ga = value_and_grad(actor_loss, ts.actor)
    ua, oa = adam_update(ga, ts.opt_actor, ts.actor, scfg.actor_lr,
                         weight_decay=scfg.weight_decay)
    actor = apply_updates(ts.actor, ua)

    ts = TrainState(actor=actor, critic1=c1, critic2=c2,
                    target1=_soft_update(ts.target1, c1, scfg.tau),
                    target2=_soft_update(ts.target2, c2, scfg.tau),
                    opt_actor=oa, opt_critic1=oc1, opt_critic2=oc2,
                    step=ts.step + 1)
    metrics = {"critic_loss": 0.5 * (l1 + l2), "actor_loss": la,
               "q_mean": qm, "entropy": entm, "q_batch": torch.mean(q1)}
    return ts, metrics


# ----------------------------------------------------------------------
def policy_act(actor_params, obs, *, ecfg: EV.EnvConfig,
               acfg: AG.AgentConfig, generator=None,
               deterministic: bool = False,
               sched: Optional[DF.DiffusionSchedule] = None):
    """An agent-space action (..., A) for obs (..., 3, E+l)."""
    if sched is None:
        sched = DF.vp_schedule(acfg.T, device=obs.device)
    with torch.no_grad():
        a, _, _, _ = AG.actor_sample(actor_params, acfg, ecfg, sched, obs,
                                     generator=generator,
                                     deterministic=deterministic)
    return a


# ----------------------------------------------------------------------
# rollout-engine policies
def actor_policy(ecfg: EV.EnvConfig, acfg: AG.AgentConfig,
                 deterministic: bool = False, *, device=None):
    """The actor as a batch_rollout policy with the full-chain "ddpm"
    sampler (`actors.policies.actor_policy`)."""
    return POL.actor_policy(ecfg, acfg, deterministic=deterministic,
                            sampler="ddpm", device=device)


@functools.lru_cache(maxsize=None)
def warmup_policy(ecfg: EV.EnvConfig):
    """Uniform agent-space exploration used until the buffer warms up."""
    def policy(params, generator, traces, state, obs):
        a = torch.rand((obs.shape[0], ecfg.action_dim), generator=generator,
                       device=obs.device) * 2.0 - 1.0
        return AG.to_env_action(a), {"agent_action": a}
    return policy


def flatten_valid_transitions(tr: RO.Transitions) -> Tuple[np.ndarray, ...]:
    """Stacked (B, T, ...) collected transitions -> flat (N, ...) numpy
    arrays of the valid steps, in the replay-buffer layout (obs,
    agent-space action, reward, next_obs, done), ordered env by env."""
    valid = tr.valid.reshape(-1)

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))[valid].cpu().numpy()
    return (flat(tr.obs), flat(tr.extras["agent_action"]), flat(tr.reward),
            flat(tr.next_obs), flat(tr.done))


def push_transitions(buffer: ReplayBuffer, tr: RO.Transitions) -> int:
    """Flatten the valid steps of stacked transitions into the buffer;
    returns the number of transitions added."""
    flat = flatten_valid_transitions(tr)
    buffer.add_batch(*flat)
    return len(flat[2])


def collect_batch(ecfg: EV.EnvConfig, acfg: AG.AgentConfig, actor_params,
                  traces: Dict, generator, buffer: ReplayBuffer, *,
                  warmup: bool = False, exec_spec=None,
                  device=None) -> Tuple[Dict, int]:
    """Roll out B parallel episodes and push the valid transitions into the
    replay buffer (agent-space actions). Returns (metrics of (B,) tensors,
    n added).

    `exec_spec` (an `api.ExecSpec`, default fused) picks the execution
    backend of the API facade (`api.backends.rollout_fn_for`)."""
    from repro_torch.api.backends import rollout_fn_for
    from repro_torch.api.specs import ExecSpec
    policy = (warmup_policy(ecfg) if warmup
              else actor_policy(ecfg, acfg, device=device))
    params = {} if warmup else actor_params
    rollout = rollout_fn_for(exec_spec or ExecSpec())
    res = rollout(ecfg, traces, policy, params, generator=generator,
                  collect=True, device=device)
    return res.metrics, push_transitions(buffer, res.transitions)


def _sample_batch(buffer: ReplayBuffer, rng, batch_size: int, device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in buffer.sample(rng, batch_size).items()}


def run_update_schedule(ts: TrainState, buffer: ReplayBuffer,
                        rng: np.random.Generator, generator, n_new: int, *,
                        ecfg: EV.EnvConfig, acfg: AG.AgentConfig,
                        scfg: SACConfig, max_updates: Optional[int] = None):
    """The per-step gradient schedule over `n_new` fresh env steps: once the
    buffer passes warmup, run (n_new // update_every) * updates_per_step
    update steps (capped by `max_updates`) on batches sampled with the host
    `rng`. The generator advances in place, so where the reference hands
    back its key this returns the last update's metrics (empty when none
    ran): (train state', updates run, metrics)."""
    n_upd, metrics = 0, {}
    if buffer.size >= scfg.warmup_steps:
        n_upd = (n_new // scfg.update_every) * scfg.updates_per_step
        if max_updates is not None:
            n_upd = min(n_upd, max_updates)
        dev = ts.step.device
        sched = DF.vp_schedule(acfg.T, device=dev)
        for _ in range(n_upd):
            batch = _sample_batch(buffer, rng, scfg.batch_size, dev)
            ts, metrics = update_step(ts, batch, ecfg=ecfg, acfg=acfg,
                                      scfg=scfg, generator=generator,
                                      sched=sched)
    return ts, n_upd, metrics


def run_episode(ecfg: EV.EnvConfig, trace: Dict, actor_params,
                acfg: AG.AgentConfig, *, generator=None,
                buffer: Optional[ReplayBuffer] = None,
                deterministic: bool = False, device=None) -> Dict:
    """One host-driven episode on one trace (a dict of (K,) tensors), one
    `env.step` per decision until done. Returns the episode metrics as
    floats, with episode_return and episode_len."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    tr = {k: v[None] for k, v in to_device(trace, dev).items()}
    params = to_device(actor_params, dev)
    sched = DF.vp_schedule(acfg.T, device=dev)
    state = EV.reset(ecfg, 1, device=dev)
    obs = EV.observe(ecfg, tr, state)
    total_r, steps, done = 0.0, 0, False
    while not done:
        a = policy_act(params, obs, ecfg=ecfg, acfg=acfg, generator=gen,
                       deterministic=deterministic, sched=sched)
        state, next_obs, r, d, _ = EV.step(ecfg, tr, state,
                                           AG.to_env_action(a))
        done = bool(d[0])
        if buffer is not None:
            buffer.add(obs[0].cpu().numpy(), a[0].cpu().numpy(), float(r[0]),
                       next_obs[0].cpu().numpy(), done)
        total_r += float(r[0])
        obs = next_obs
        steps += 1
    metrics = {k: float(v[0])
               for k, v in EV.episode_metrics(ecfg, tr, state).items()}
    metrics["episode_return"] = total_r
    metrics["episode_len"] = steps
    return metrics


def seed_with_demonstrations(buffer: ReplayBuffer, ecfg: EV.EnvConfig,
                             trace_fn: Callable, generator,
                             episodes: int = 8, *, device=None) -> int:
    """Fill the replay buffer with Greedy episodes (beyond the paper), so
    the off-policy critics see high-reward, reuse-aware transitions before
    the actor produces them; the actor is never behaviour-cloned. The
    `episodes` traces come from `trace_fn(generator, episodes)` and run
    together through the fused `batch_rollout` of `rollout.greedy_policy`
    to their ends; every valid step is stored episode by episode, with the
    action in the agent's [-1, 1] range. Returns the transitions added."""
    dev = resolve_device(device)
    traces = trace_fn(generator, episodes)
    res = RO.batch_rollout(ecfg, traces, RO.greedy_policy(ecfg), {},
                           generator=generator, collect=True, device=dev)
    tr = res.transitions
    tr = tr._replace(extras={"agent_action": tr.action * 2.0 - 1.0})
    return push_transitions(buffer, tr)


def train(ecfg: EV.EnvConfig, acfg: AG.AgentConfig, scfg: SACConfig,
          trace_fn: Callable, num_episodes: int, seed: int = 0,
          log_every: int = 10, callback=None, demo_episodes: int = 0,
          num_envs: int = 4, curriculum=None, exec_spec=None, *,
          device=None):
    """Full training loop (Algorithm 2). `trace_fn(generator, B)` returns a
    batch of B traces (dict of (B, K) tensors, e.g. `make_trace_batch`).

    Each round rolls out `num_envs` parallel envs on fresh traces through
    the fused `batch_rollout` (uniform exploration until the buffer holds
    `warmup_steps` transitions, then the actor), pushes every valid
    transition into the buffer and runs the update schedule
    (updates_per_step * new steps / update_every). Returns (train state,
    history): one row per episode with its metrics and, beyond the
    reference's rows, its round, whether the round was warmup, the updates
    the round ran and their last losses.

    `demo_episodes > 0` seeds the buffer with Greedy episodes first
    (`seed_with_demonstrations`, on traces from `trace_fn`). `curriculum`
    (a list of `scenarios.Scenario` sharing `ecfg`, e.g.
    `scenarios.training_curriculum(ecfg)`) replaces `trace_fn` for the
    collection rounds: each round samples one cell with the host rng.
    `exec_spec` (an `api.ExecSpec`) picks the collection execution backend
    (reference or fused, equal results)."""
    if exec_spec is not None:
        from repro_torch.api.backends import rollout_fn_for
        rollout_fn_for(exec_spec)         # a bad spec is refused up front
    if demo_episodes and trace_fn is None:
        raise ValueError("demo_episodes > 0 runs greedy_act demonstrations "
                         "on traces from trace_fn, which is None")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = host_rng(gen)
    pick = None
    if curriculum:
        from repro_torch.core.scenarios import curriculum_picker
        pick = curriculum_picker(ecfg, curriculum)
    ts = init_train_state(ecfg, acfg, generator=gen, device=dev)
    buffer = ReplayBuffer(scfg.buffer_capacity, ecfg.obs_shape,
                          ecfg.action_dim)
    if demo_episodes:
        n = seed_with_demonstrations(buffer, ecfg, trace_fn, gen,
                                     demo_episodes, device=dev)
        if log_every:
            print(f"[demo] seeded buffer with {n} greedy transitions")
    history = []
    ep, rnd = 0, 0
    while ep < num_episodes:
        B = min(num_envs, num_episodes - ep)
        round_trace_fn = pick(rng)[1] if pick else trace_fn
        traces = round_trace_fn(gen, B)
        warmup = buffer.size < scfg.warmup_steps
        metrics, n_new = collect_batch(ecfg, acfg, ts.actor, traces, gen,
                                       buffer, warmup=warmup,
                                       exec_spec=exec_spec, device=dev)
        ts, n_upd, losses = run_update_schedule(
            ts, buffer, rng, gen, n_new, ecfg=ecfg, acfg=acfg, scfg=scfg)
        host = {k: v.cpu() for k, v in metrics.items()}
        losses = {k: float(v) for k, v in losses.items()}
        for b in range(B):
            em = {k: float(v[b]) for k, v in host.items()}
            em.update(episode=ep, episode_len=int(host["episode_len"][b]),
                      round=rnd, warmup=warmup, updates=n_upd, **losses)
            history.append(em)
            if callback:
                callback(ep, em, ts)
            if log_every and ep % log_every == 0:
                print(f"[ep {ep:4d}] R={em['episode_return']:8.2f} "
                      f"len={em['episode_len']:4d} "
                      f"resp={em['avg_response']:7.2f} "
                      f"q={em['avg_quality']:.3f} "
                      f"reload={em['reload_rate']:.2f}")
            ep += 1
        rnd += 1
    return ts, history
