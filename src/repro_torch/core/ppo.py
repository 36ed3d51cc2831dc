"""PPO baseline (paper §VI.A.3, hyper-parameters from Table VIII; port of
`repro/core/ppo.py`).

On-policy clipped-surrogate PPO with GAE; a Gaussian MLP actor (mean = tanh
of a Mish MLP over the flattened state, a learned state-independent
log-sigma) and an MLP value head: the 256x256 architecture the paper
compares with. Gradients come from `torch.autograd.grad` over the params
dict's leaves and the optimizer is the reference's functional Adam
(`training.optimizer`). Collection runs the fused `batch_rollout`, so on
the card every decision replays the policy's decision graph (the MLPs and
one env_step launch).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import agent as AG
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO
from repro_torch.core.networks import init_mlp, mlp_apply
from repro_torch.models.layers import mish
from repro_torch.training.optimizer import (AdamState, adam_init, adam_update,
                                            apply_updates,
                                            clip_by_global_norm,
                                            value_and_grad)


@dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    gamma: float = 0.95
    gae_lambda: float = 0.95      # lambda_G
    clip_eps: float = 0.2         # epsilon
    value_coef: float = 0.5       # nu
    entropy_coef: float = 0.01    # beta
    max_grad_norm: float = 0.5    # g
    rollout_len: int = 1024
    minibatches: int = 8
    epochs: int = 4


class PPOState(NamedTuple):
    params: Any
    opt: AdamState
    step: torch.Tensor            # () int32


def init_ppo(ecfg: EV.EnvConfig, *, generator=None, device=None) -> PPOState:
    """Fresh actor and value MLPs drawn from `generator`, in that order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    obs_dim = ecfg.obs_shape[0] * ecfg.obs_shape[1]
    params = {
        "actor": init_mlp([obs_dim, 256, 256, ecfg.action_dim],
                          generator=gen, device=dev),
        "log_sigma": torch.full((ecfg.action_dim,), -0.5, device=dev),
        "value": init_mlp([obs_dim, 256, 256, 1], generator=gen, device=dev),
    }
    return PPOState(params=params, opt=adam_init(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _dist(params, obs):
    flat = obs.reshape(obs.shape[:-2] + (-1,))
    mean = torch.tanh(mlp_apply(params["actor"], flat, activation=mish))
    return mean, params["log_sigma"]


def _logp(mean, log_sigma, a):
    var = torch.exp(2 * log_sigma)
    return torch.sum(-0.5 * torch.square(a - mean) / var - log_sigma
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def value_of(params, obs):
    flat = obs.reshape(obs.shape[:-2] + (-1,))
    return mlp_apply(params["value"], flat, activation=mish)[..., 0]


def _sample(params, obs, generator=None, eps=None):
    mean, log_sigma = _dist(params, obs)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=obs.device)
    a = torch.clamp(mean + torch.exp(log_sigma) * eps, -1.0, 1.0)
    return a, _logp(mean, log_sigma, a)


def ppo_act(params, obs, *, ecfg: EV.EnvConfig, generator=None, eps=None):
    """(agent-space action, log-prob, value) for obs (..., 3, E+l); the
    Gaussian noise `eps` is drawn from `generator` unless given."""
    with torch.no_grad():
        a, logp = _sample(params, obs, generator, eps)
        return a, logp, value_of(params, obs)


@functools.lru_cache(maxsize=None)
def ppo_policy(ecfg: EV.EnvConfig):
    """The Gaussian MLP actor as a `batch_rollout` policy (agent action,
    log-prob and value in the extras)."""
    def policy(params, generator, traces, state, obs):
        a, logp = _sample(params, obs, generator)
        return AG.to_env_action(a), {"agent_action": a, "logp": logp,
                                     "value": value_of(params, obs)}
    return policy


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """numpy GAE over a rollout."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_v = last_value
    for t in reversed(range(T)):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * nonterm - values[t]
        last = delta + gamma * lam * nonterm * last
        adv[t] = last
        next_v = values[t]
    return adv, adv + values


def pool_gae(tr: RO.Transitions, pcfg: PPOConfig,
             last_values=None) -> Dict[str, np.ndarray]:
    """Per-episode GAE over the valid prefix of stacked (B, T, ...)
    transitions, pooled into one flat update batch (numpy).

    `last_values` ((B,) or None) bootstraps each row past its last valid
    step. None: the row ran to termination and its final done flag zeroes
    the bootstrap. Given: the row ended at a window seam, a truncation, so
    its final done flag is overridden and the value bootstraps."""
    def host(x):
        return x.detach().cpu().numpy()
    valid, done, reward = host(tr.valid), host(tr.done), host(tr.reward)
    obs = host(tr.obs)
    ex = {k: host(v) for k, v in tr.extras.items()}
    lens = valid.sum(axis=1)
    chunks = {k: [] for k in ("obs", "action", "logp", "adv", "ret")}
    for b in range(valid.shape[0]):
        L = int(lens[b])
        if L == 0:
            continue
        last_v = 0.0 if last_values is None else float(last_values[b])
        dones = done[b, :L]
        if last_values is not None:
            dones = dones.copy()
            dones[-1] = 0.0            # seam = truncation, keep the bootstrap
        adv, ret = compute_gae(reward[b, :L], ex["value"][b, :L], dones,
                               last_v, pcfg.gamma, pcfg.gae_lambda)
        chunks["obs"].append(obs[b, :L])
        chunks["action"].append(ex["agent_action"][b, :L])
        chunks["logp"].append(ex["logp"][b, :L])
        chunks["adv"].append(adv)
        chunks["ret"].append(ret)
    if not chunks["adv"]:
        shapes = {"obs": obs.shape[2:], "action": ex["agent_action"].shape[2:],
                  "logp": (), "adv": (), "ret": ()}
        return {k: np.zeros((0,) + tuple(s), np.float32)
                for k, s in shapes.items()}
    return {k: np.concatenate(v).astype(np.float32)
            for k, v in chunks.items()}


def ppo_update(st: PPOState, batch: Dict, *, ecfg: EV.EnvConfig,
               pcfg: PPOConfig) -> Tuple[PPOState, Dict]:
    """One clipped-surrogate step on `batch` (obs, action, logp, adv, ret
    tensors on the state's device). Returns (state', metrics: loss,
    value_loss, ratio, grad_norm as 0-d tensors)."""
    def loss_fn(params):
        mean, log_sigma = _dist(params, batch["obs"])
        logp = _logp(mean, log_sigma, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr = torch.minimum(ratio * adv, torch.clamp(
            ratio, 1 - pcfg.clip_eps, 1 + pcfg.clip_eps) * adv)
        v = value_of(params, batch["obs"])
        v_loss = torch.mean(torch.square(batch["ret"] - v))
        ent = torch.sum(log_sigma + 0.5 * math.log(2 * math.pi * math.e))
        loss = (-torch.mean(surr) + pcfg.value_coef * v_loss
                - pcfg.entropy_coef * ent)
        return loss, (v_loss.detach(), torch.mean(ratio).detach())

    loss, (vl, ratio), grads = value_and_grad(loss_fn, st.params)
    grads, gnorm = clip_by_global_norm(grads, pcfg.max_grad_norm)
    upd, opt = adam_update(grads, st.opt, st.params, pcfg.lr)
    params = apply_updates(st.params, upd)
    return PPOState(params=params, opt=opt, step=st.step + 1), \
        {"loss": loss, "value_loss": vl, "ratio": ratio, "grad_norm": gnorm}


def run_ppo_epochs(st: PPOState, data: Dict[str, np.ndarray], rng,
                   ecfg: EV.EnvConfig, pcfg: PPOConfig,
                   max_updates: Optional[int] = None) -> Tuple[PPOState, int]:
    """Clipped-surrogate epochs over one pooled batch, minibatches drawn
    by the host `rng`; `max_updates` caps the gradient steps. Returns
    (state, updates run)."""
    n = len(data["adv"])
    done = 0
    if n == 0:
        return st, 0
    dev = st.step.device
    for _ in range(pcfg.epochs):
        perm = rng.permutation(n)
        mb = max(1, n // pcfg.minibatches)
        for i in range(0, n, mb):
            if max_updates is not None and done >= max_updates:
                return st, done
            idx = perm[i:i + mb]
            batch = {k: torch.from_numpy(v[idx]).to(dev)
                     for k, v in data.items()}
            st, _ = ppo_update(st, batch, ecfg=ecfg, pcfg=pcfg)
            done += 1
    return st, done


def train_ppo(ecfg: EV.EnvConfig, pcfg: PPOConfig, trace_fn,
              num_episodes: int, seed: int = 0, log_every: int = 10,
              num_envs: int = 4, curriculum=None, exec_spec=None, *,
              device=None):
    """On-policy training on the batched rollout: each round collects
    `num_envs` episodes (`trace_fn(generator, B)` gives their traces, or a
    cell of `curriculum` each round, `scenarios.training_curriculum`), then
    runs the clipped-surrogate epochs over the pooled valid transitions
    with per-episode GAE. Returns (state, history: one row per episode
    with its metrics and, beyond the reference's rows, its round and the
    updates the round ran).

    `exec_spec` (an `api.ExecSpec`) picks the collection execution backend
    (reference or fused, equal results)."""
    from repro_torch.api.backends import rollout_fn_for
    from repro_torch.api.specs import ExecSpec
    from repro_torch.core.sac import host_rng
    rollout = rollout_fn_for(exec_spec or ExecSpec())
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = host_rng(gen)
    st = init_ppo(ecfg, generator=gen, device=dev)
    pick = None
    if curriculum:
        from repro_torch.core.scenarios import curriculum_picker
        pick = curriculum_picker(ecfg, curriculum)
    history = []
    ep, rnd = 0, 0
    while ep < num_episodes:
        B = min(num_envs, num_episodes - ep)
        round_trace_fn = pick(rng)[1] if pick else trace_fn
        traces = round_trace_fn(gen, B)
        res = rollout(ecfg, traces, ppo_policy(ecfg), st.params,
                      generator=gen, collect=True, device=dev)
        data = pool_gae(res.transitions, pcfg)
        st, n_upd = run_ppo_epochs(st, data, rng, ecfg, pcfg)
        host = {k: v.cpu() for k, v in res.metrics.items()}
        for b in range(B):
            em = {k: float(v[b]) for k, v in host.items()}
            em.update(episode=ep, episode_len=int(host["episode_len"][b]),
                      round=rnd, updates=n_upd)
            history.append(em)
            if log_every and ep % log_every == 0:
                print(f"[ppo ep {ep:4d}] R={em['episode_return']:8.2f} "
                      f"len={em['episode_len']:4d} "
                      f"resp={em['avg_response']:7.2f} "
                      f"q={em['avg_quality']:.3f}")
            ep += 1
        rnd += 1
    return st, history
