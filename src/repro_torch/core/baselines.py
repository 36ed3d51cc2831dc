"""Non-learned baselines (paper §VI.A.3; port of `repro/core/baselines.py`):
Random, Greedy, Genetic, Harmony.

* Random: a uniform action vector (`rollout.uniform_policy` in a rollout).
* Greedy: for each of B envs, the 1 + l·9 candidate actions (no-op, then
  every visible slot × a 9-point step grid) simulated with the env's
  decision step on one visible-queue view per env, the best immediate
  quality-first score taken. In a rollout on the card it runs inside the
  decision's CUDA graph.
* Genetic and Harmony: meta-heuristics that optimise a fixed action
  sequence (no feedback at run time, as the paper describes) with the
  episode return as fitness, evaluated by a `batch_rollout` of
  `sequence_policy` over the population: on the card one env_step launch a
  decision for the whole population.

Draws come from a `torch.Generator` or are passed in (`draws=`), which is
how the parity tests hand both sides the reference's draws. Selection sorts
stably, as `jnp.argsort` does: fitness ties are common among random
sequences.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import env as EV
from repro_torch.core import quality as Q
from repro_torch.core import rollout as RO


# ----------------------------------------------------------------------
def random_policy(generator: torch.Generator, ecfg: EV.EnvConfig):
    """One uniform env-space action (A,) on the generator's device."""
    return torch.rand((ecfg.action_dim,), generator=generator,
                      device=generator.device)


# ----------------------------------------------------------------------
def candidate_actions(ecfg: EV.EnvConfig, n_steps: int = 9) -> np.ndarray:
    """(1 + l*n_steps, action_dim) candidates in env space [0, 1]: the
    no-op (a_c > 0.5), then for each visible slot the step grid."""
    l, A = ecfg.queue_window, ecfg.action_dim
    acts = [np.full((A,), 0.9, np.float32)]
    for slot in range(l):
        for s in np.linspace(0.0, 1.0, n_steps, dtype=np.float32):
            a = np.zeros((A,), np.float32)          # a_c = 0 -> execute
            a[1] = s
            a[2 + slot] = 1.0
            acts.append(a)
    return np.stack(acts)


@functools.lru_cache(maxsize=None)
def _candidates(ecfg: EV.EnvConfig, device: torch.device) -> torch.Tensor:
    """`candidate_actions` on `device`, copied there once."""
    return torch.from_numpy(candidate_actions(ecfg)).to(device)


def greedy_act(ecfg: EV.EnvConfig, traces: Dict,
               state: EV.EnvState) -> torch.Tensor:
    """Quality-first candidate search (paper §VI.B.3) for B envs:
    (B, A) env actions.

    The quality part of the reward (alpha_q q - lambda_q I) is the primary
    criterion and the full reward only breaks ties, as in the reference:
    scoring by the raw reward drags the argmax to interior step counts.
    All C candidates of an env share its one visible-queue view; the B x C
    (env, candidate) pairs go through one batched decision step, and the
    first best candidate wins (argmax's first index, as jnp.argmax)."""
    cands = _candidates(ecfg, state.time.device)
    C, B = cands.shape[0], state.time.shape[0]
    q = EV.visible_queue(ecfg, traces, state)
    st = EV.decision_statics(ecfg, traces)

    def rep(x):
        return x.repeat_interleave(C, dim=0)
    _, r, _, info = EV._decide(
        ecfg, {k: rep(v) for k, v in st.items()},
        EV.EnvState(*map(rep, state)), cands.repeat(B, 1),
        EV.QueueView(*map(rep, q)))
    qk = info["quality"]
    pen = Q.quality_penalty(qk, ecfg.q_min, ecfg.p_quality)
    qual = torch.where(info["scheduled"],
                       ecfg.alpha_q * qk - ecfg.lambda_q * pen + 1e-6, 0.0)
    scores = (1e3 * qual + r).reshape(B, C)
    return cands[torch.argmax(scores, dim=1)]


# ----------------------------------------------------------------------
# sequence rollouts for the meta-heuristics
def rollout_sequence(ecfg: EV.EnvConfig, trace: Dict, seq: torch.Tensor):
    """seq (T, action_dim) in [0, 1] replayed on one trace (dict of (K,)
    tensors), the visible queue threaded through the decision step (no
    observation). Returns (return, final state without the batch axis)."""
    tr = {k: v[None] for k, v in trace.items()}
    dev = seq.device
    state = EV.reset(ecfg, 1, device=dev)
    st = EV.decision_statics(ecfg, tr)
    q = EV.visible_queue(ecfg, tr, state)
    total = torch.zeros((1,), device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    for a in seq:
        nstate, r, d, _ = EV._decide(ecfg, st, state, a[None], q)
        nq = EV.visible_queue(ecfg, tr, nstate)
        state = RO._freeze(done, nstate, state)
        q = RO._freeze(done, nq, q)
        total = total + torch.where(done, 0.0, r)
        done = done | d
    return total[0], EV.EnvState(*(x[0] for x in state))


def sequence_fitness(ecfg: EV.EnvConfig, trace: Dict, seqs: torch.Tensor,
                     *, device=None) -> torch.Tensor:
    """Episode return of each of P sequences (P, T, A) on one trace: a
    `batch_rollout` of `sequence_policy` with B = P, T decisions (what
    `rollout_sequence` gives each, in one batched rollout)."""
    dev = resolve_device(device)
    P, T = seqs.shape[0], seqs.shape[1]
    traces = {k: v.to(dev)[None].expand((P,) + tuple(v.shape)).contiguous()
              for k, v in trace.items()}
    res = RO.batch_rollout(ecfg, traces, RO.sequence_policy(ecfg),
                           {"seq": seqs}, num_steps=T, device=dev)
    return res.metrics["episode_return"]


@dataclass(frozen=True)
class GeneticConfig:
    population: int = 64
    generations: int = 32
    parents: int = 10
    crossover_prob: float = 1.0
    mutation_prob: float = 0.1
    elites: int = 1
    seq_len: int = 2048


def genetic_draws(gcfg: GeneticConfig, T: int, A: int, *, generator):
    """One generation's draws, in this order: the two parent indices, the
    crossover mask, the mutation mask and the mutation values."""
    n = gcfg.population - gcfg.elites
    dev = generator.device
    i1 = torch.randint(0, gcfg.parents, (n,), generator=generator,
                       device=dev)
    i2 = torch.randint(0, gcfg.parents, (n,), generator=generator,
                       device=dev)
    xmask = torch.rand((n, T, A), generator=generator, device=dev) < 0.5
    mmask = torch.rand((n, T, A), generator=generator,
                       device=dev) < gcfg.mutation_prob
    mval = torch.rand((n, T, A), generator=generator, device=dev)
    return {"i1": i1, "i2": i2, "xmask": xmask, "mmask": mmask,
            "mval": mval}


def _genetic_generation(ecfg: EV.EnvConfig, gcfg: GeneticConfig,
                        trace: Dict, pop: torch.Tensor, *, generator=None,
                        draws: Optional[Dict] = None):
    """One generation: fitness of `pop` (P, T, A), stable selection by
    fitness, uniform crossover of two parents, mutation, elites kept.
    Returns (next population, fitness of `pop`)."""
    T, A = pop.shape[1], pop.shape[2]
    fit = sequence_fitness(ecfg, trace, pop, device=pop.device)
    pop = pop[torch.argsort(-fit, stable=True)]
    parents = pop[:gcfg.parents]
    d = draws if draws is not None else genetic_draws(
        gcfg, T, A, generator=generator)
    d = to_device(d, pop.device)
    # a parent index past a population smaller than `parents` is clamped,
    # as a JAX gather clamps it
    i1, i2 = (torch.clamp(d[k].to(torch.int64), max=parents.shape[0] - 1)
              for k in ("i1", "i2"))
    children = torch.where(d["xmask"], parents[i1], parents[i2])
    children = torch.where(d["mmask"], d["mval"], children)
    return torch.cat([pop[:gcfg.elites], children]), fit


def genetic_schedule(ecfg: EV.EnvConfig, trace: Dict,
                     gcfg: GeneticConfig = GeneticConfig(), *,
                     generator=None, device=None):
    """(best action sequence (T, A), its fitness)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    trace = to_device(trace, dev)
    pop = torch.rand((gcfg.population, gcfg.seq_len, ecfg.action_dim),
                     generator=gen, device=dev)
    for _ in range(gcfg.generations):
        pop, _ = _genetic_generation(ecfg, gcfg, trace, pop, generator=gen)
    fit = sequence_fitness(ecfg, trace, pop, device=dev)
    best = torch.argmax(fit)
    return pop[best], fit[best]


@dataclass(frozen=True)
class HarmonyConfig:
    memory_size: int = 64
    improvisations: int = 64     # total candidates (across batched rounds)
    improv_batch: int = 16       # candidates improvised/evaluated per round
    hmcr: float = 0.8            # memory consideration
    par: float = 0.2             # pitch adjustment
    bandwidth: float = 0.05      # continuous-action pitch bandwidth
    seq_len: int = 2048


def harmony_draws(hcfg: HarmonyConfig, n: int, T: int, A: int, *,
                  generator):
    """One round's draws for n candidates, in this order: the memory row
    picked per (step, dim), memory consideration, the random values, pitch
    adjustment and its bandwidth factor in [-1, 1)."""
    dev = generator.device
    shape = (n, T, A)
    pick = torch.randint(0, hcfg.memory_size, shape, generator=generator,
                         device=dev)
    use_mem = torch.rand(shape, generator=generator, device=dev) < hcfg.hmcr
    rand = torch.rand(shape, generator=generator, device=dev)
    adj = torch.rand(shape, generator=generator, device=dev) < hcfg.par
    bw = torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0
    return {"pick": pick, "use_mem": use_mem, "rand": rand, "adj": adj,
            "bw": bw}


def _harmony_improvise(memory: torch.Tensor, hcfg: HarmonyConfig,
                       draws: Dict) -> torch.Tensor:
    """Candidates (n, T, A) from the memory (M, T, A), classic harmony
    search improvisation on the given draws."""
    T, A = memory.shape[1], memory.shape[2]
    d = to_device(draws, memory.device)
    iT = torch.arange(T, device=memory.device)[:, None]
    iA = torch.arange(A, device=memory.device)[None, :]
    from_mem = memory[d["pick"].to(torch.int64), iT, iA]
    new = torch.where(d["use_mem"], from_mem, d["rand"])
    return torch.where(d["adj"] & d["use_mem"],
                       torch.clamp(new + hcfg.bandwidth * d["bw"], 0, 1),
                       new)


def _harmony_merge(memory, fit, new, f_new):
    """Fold evaluated candidates into (memory, fit) one at a time: each
    replaces the then-worst entry iff it beats it (argmin's first index).
    Device ops only, no host sync."""
    memory, fit = memory.clone(), fit.clone()
    for cand, fc in zip(new, f_new):
        worst = torch.argmin(fit)
        better = fc > fit[worst]
        memory[worst] = torch.where(better, cand, memory[worst])
        fit[worst] = torch.where(better, fc, fit[worst])
    return memory, fit


def harmony_schedule(ecfg: EV.EnvConfig, trace: Dict,
                     hcfg: HarmonyConfig = HarmonyConfig(), *,
                     generator=None, device=None):
    """Batched harmony search: each round improvises `improv_batch`
    candidates from the current memory, scores them in one batched
    sequence rollout and merges them in order. Returns (best sequence,
    its fitness)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    trace = to_device(trace, dev)
    A, T = ecfg.action_dim, hcfg.seq_len
    nb = max(1, min(hcfg.improv_batch, hcfg.improvisations))
    rounds = -(-hcfg.improvisations // nb)
    memory = torch.rand((hcfg.memory_size, T, A), generator=gen, device=dev)
    fit = sequence_fitness(ecfg, trace, memory, device=dev)
    remaining = hcfg.improvisations
    for _ in range(rounds):
        nb_r = min(nb, remaining)      # the last round is trimmed so the
        remaining -= nb_r              # total stays `improvisations`
        new = _harmony_improvise(memory, hcfg, harmony_draws(
            hcfg, nb_r, T, A, generator=gen))
        f_new = sequence_fitness(ecfg, trace, new, device=dev)
        memory, fit = _harmony_merge(memory, fit, new, f_new)
    best = torch.argmax(fit)
    return memory[best], fit[best]


# ----------------------------------------------------------------------
def evaluate_policy(ecfg: EV.EnvConfig, trace: Dict, act_fn, generator,
                    max_steps: int = 4096, *, device=None) -> Dict:
    """Host-loop evaluation on one trace (dict of (K,) tensors):
    `act_fn(generator, state, obs)` gives an env action (A,) or (1, A), one
    `env.step` per decision until done. Metrics as floats, the return
    accumulated in f32 as the batched rollout does."""
    dev = resolve_device(device)
    tr = {k: v[None] for k, v in to_device(trace, dev).items()}
    state = EV.reset(ecfg, 1, device=dev)
    obs = EV.observe(ecfg, tr, state)
    total, done, n = np.float32(0.0), False, 0
    while not done and n < max_steps:
        a = act_fn(generator, state, obs)
        state, obs, r, d, _ = EV.step(ecfg, tr, state,
                                      a.reshape(1, ecfg.action_dim))
        total = total + np.float32(r[0].item())
        done = bool(d[0])
        n += 1
    m = {k: float(v[0])
         for k, v in EV.episode_metrics(ecfg, tr, state).items()}
    m.update(episode_return=float(total), episode_len=n)
    return m


def evaluate_policy_batch(ecfg: EV.EnvConfig, traces: Dict, policy,
                          generator=None, params=None,
                          num_steps: Optional[int] = None, *,
                          device=None) -> Dict[str, np.ndarray]:
    """Deprecated: use `repro_torch.api.evaluate_batch` (same per-episode
    metric arrays, plus PolicySpec resolution and pluggable execution
    backends).

    Batched evaluation: B traces (dict of (B, K) tensors) in one fused
    rollout; `policy` follows the rollout protocol. Returns per-episode
    (B,) numpy metric arrays."""
    import warnings
    warnings.warn(
        "baselines.evaluate_policy_batch is deprecated; use "
        "repro_torch.api.evaluate_batch", DeprecationWarning, stacklevel=2)
    from repro_torch.api import evaluate_batch
    return evaluate_batch(ecfg, traces, policy, generator, params=params,
                          num_steps=num_steps, device=device)
