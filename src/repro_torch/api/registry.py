"""Policy registry: one name -> (rollout policy, params, provenance) (port
of `repro/api/registry.py`).

Unifies every scheduler the repo knows under the rollout policy protocol
(`core.rollout`): the non-learned baselines (`random`, `fifo`, `greedy`),
the learned agents (`eat` diffusion-SAC actor and its ablation variants,
`ppo`), and the offline meta-heuristics (`genetic`, `harmony`) — the latter
optimise a fixed action sequence on a workload trace at resolve time and
replay it through `rollout.sequence_policy`.

Resolution is explicit about weight provenance: a learned policy resolved
without `params` or `checkpoint` gets *fresh-initialised* weights, is marked
``trained=False`` and emits an `UntrainedPolicyWarning` — sweep summaries
carry the flag, so an untrained agent can never masquerade as the paper's.

    rp = resolve(PolicySpec("eat", checkpoint="runs/eat"), ecfg)
    batch_rollout(ecfg, traces, rp.policy, rp.params, generator=g)

Randomness: a fresh init draws from `torch.Generator(device)
.manual_seed(spec.seed)` (the eat student, when one is drawn, from the
same generator after the actor), and the offline schedules draw their
trace from a generator seeded `spec.seed` and their search from one seeded
`spec.seed + 1`, where the reference uses `PRNGKey(spec.seed)`, its
`fold_in(., 1)` and `PRNGKey(spec.seed + 1)`. Philox and threefry never
agree, so fresh weights differ from the reference's fresh ones; parity
with the reference is held on carried weights (`params=` or a reference
`checkpoint=`).

Builders lazy-import agent/sac/ppo so importing `repro_torch.api` stays
cheap.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api.checkpoints import restore_params
from repro_torch.api.specs import PolicySpec
from repro_torch.common.device import resolve_device
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO

BASELINE, LEARNED, OFFLINE = "baseline", "learned", "offline"

# trace_fn(generator) -> one trace (dict of (K,) tensors); offline builders
# optimise their sequence on it
TraceFn = Callable[[torch.Generator], Dict]


class UntrainedPolicyWarning(UserWarning):
    """A learned policy resolved to fresh-initialised weights."""


@dataclass
class ResolvedPolicy:
    name: str
    policy: Callable
    params: Any
    trained: bool          # False iff a learned policy got fresh weights
    kind: str              # "baseline" | "learned" | "offline"
    meta: Dict[str, Any] = field(default_factory=dict)
    #: the shared decision layer's view of this policy
    #: (`repro_torch.actors.ActorProgram`), attached by `resolve` —
    #: consumers that need the per-decision program take it from here
    #: instead of re-deriving their own
    program: Any = None


_BUILDERS: Dict[str, Tuple[str, Callable]] = {}


def register(name: str, kind: str = BASELINE):
    """Register a builder: fn(spec, ecfg, trace_fn, device) ->
    ResolvedPolicy."""
    def deco(fn):
        _BUILDERS[name] = (kind, fn)
        return fn
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(_BUILDERS)


def policy_kind(name: str) -> str:
    if name not in _BUILDERS:
        raise ValueError(f"unknown policy {name!r}; "
                         f"choose from {available_policies()}")
    return _BUILDERS[name][0]


def resolve(spec, ecfg: EV.EnvConfig, *,
            trace_fn: Optional[TraceFn] = None,
            device=None) -> ResolvedPolicy:
    """Resolve a PolicySpec (or bare name) against an env configuration,
    with fresh or restored weights on `device` (None: the CUDA device).

    `trace_fn` supplies the workload trace the offline meta-heuristics
    optimise their action sequence on (the Simulator passes its scenario's
    trace sampler); baselines and learned policies ignore it.
    """
    if isinstance(spec, str):
        spec = PolicySpec(name=spec)
    if spec.name not in _BUILDERS:
        raise ValueError(f"unknown policy {spec.name!r}; "
                         f"choose from {available_policies()}")
    _kind, builder = _BUILDERS[spec.name]
    rp = builder(spec, ecfg, trace_fn, resolve_device(device))
    if rp.program is None:
        from repro_torch.actors.program import actor_program
        rp.program = actor_program(ecfg, rp.policy)
    return rp


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(int(seed))


# ----------------------------------------------------------------------
# learned-weight provenance shared by the eat/ppo builders
def _load_weights(spec: PolicySpec, fresh_init: Callable[[], Any]):
    """(params, trained): explicit weights > checkpoint > fresh + warning."""
    if spec.params is not None:
        return spec.params, True
    params = fresh_init()
    if spec.checkpoint:
        return restore_params(spec.checkpoint, params), True
    # stacklevel 4 = the caller of resolve() (builder <- resolve <- caller)
    warnings.warn(
        f"policy {spec.name!r} resolved with fresh-initialised weights "
        "(no checkpoint= or params= given) — results reflect an UNTRAINED "
        "agent and are flagged trained=False",
        UntrainedPolicyWarning, stacklevel=4)
    return params, False


# ----------------------------------------------------------------------
@register("random", BASELINE)
def _build_random(spec, ecfg, trace_fn, dev):
    return ResolvedPolicy("random", RO.uniform_policy(ecfg), {}, True,
                          BASELINE)


@register("fifo", BASELINE)
def _build_fifo(spec, ecfg, trace_fn, dev):
    steps_frac = float(spec.options.get("steps_frac", 0.5))
    return ResolvedPolicy("fifo", RO.fifo_policy(ecfg, steps_frac), {}, True,
                          BASELINE, {"steps_frac": steps_frac})


@register("greedy", BASELINE)
def _build_greedy(spec, ecfg, trace_fn, dev):
    return ResolvedPolicy("greedy", RO.greedy_policy(ecfg), {}, True,
                          BASELINE)


@register("eat", LEARNED)
def _build_eat(spec, ecfg, trace_fn, dev):
    from repro_torch import actors as ACT
    from repro_torch.core import agent as AG
    acfg = spec.options.get("acfg")
    if acfg is None:
        kw = {k: spec.options[k] for k in ("variant", "T")
              if k in spec.options}
        acfg = AG.AgentConfig(**kw)
    deterministic = bool(spec.options.get("deterministic", True))
    # sampler selection is the one registry knob every consumer inherits:
    # Simulator, StreamRunner, stream training and serving all receive the
    # policy the actor layer builds for it (spec.sampler wins over the
    # options key)
    sampler = ACT.normalize_sampler(
        spec.sampler if spec.sampler is not None
        else spec.options.get("sampler"))

    def fresh():
        gen = _seeded(spec.seed, dev)
        p = AG.init_actor(ecfg, acfg, generator=gen, device=dev)
        if sampler == "distilled":
            p["student"] = ACT.init_student(ecfg, acfg, generator=gen,
                                            device=dev)
        return p

    params, trained = _load_weights(spec, fresh)
    if sampler == "distilled" and "student" not in params:
        raise ValueError(
            "sampler='distilled' needs params['student'] (a denoiser-shaped "
            "head from repro_torch.training.distill.distill_actor or "
            "repro_torch.actors.init_student); the given weights have none")
    policy = ACT.actor_policy(ecfg, acfg, deterministic=deterministic,
                              sampler=sampler, device=dev)
    return ResolvedPolicy(
        "eat", policy, params, trained, LEARNED,
        {"variant": acfg.variant, "sampler": sampler})


@register("ppo", LEARNED)
def _build_ppo(spec, ecfg, trace_fn, dev):
    from repro_torch.core import ppo as PPO
    params, trained = _load_weights(
        spec, lambda: PPO.init_ppo(ecfg, generator=_seeded(spec.seed, dev),
                                   device=dev).params)
    return ResolvedPolicy("ppo", PPO.ppo_policy(ecfg), params, trained,
                          LEARNED)


# ----------------------------------------------------------------------
def _offline_trace(spec, ecfg, trace_fn, algo: str, dev):
    if trace_fn is None:
        raise ValueError(
            f"policy {algo!r} optimises an action sequence on a workload "
            "trace; resolve it through a Simulator (which supplies its "
            "scenario's traces) or pass trace_fn=")
    return trace_fn(_seeded(spec.seed, dev))


@register("genetic", OFFLINE)
def _build_genetic(spec, ecfg, trace_fn, dev):
    from repro_torch.core import baselines as BL
    gcfg = spec.options.get("gcfg")
    if gcfg is None:
        kw = {k: spec.options[k] for k in
              ("population", "generations", "parents", "elites", "seq_len",
               "mutation_prob") if k in spec.options}
        gcfg = BL.GeneticConfig(**kw)
    trace = _offline_trace(spec, ecfg, trace_fn, "genetic", dev)
    seq, fit = BL.genetic_schedule(ecfg, trace, gcfg,
                                   generator=_seeded(spec.seed + 1, dev),
                                   device=dev)
    return ResolvedPolicy("genetic", RO.sequence_policy(ecfg), {"seq": seq},
                          True, OFFLINE, {"fitness": float(fit)})


@register("harmony", OFFLINE)
def _build_harmony(spec, ecfg, trace_fn, dev):
    from repro_torch.core import baselines as BL
    hcfg = spec.options.get("hcfg")
    if hcfg is None:
        kw = {k: spec.options[k] for k in
              ("memory_size", "improvisations", "improv_batch", "seq_len")
              if k in spec.options}
        hcfg = BL.HarmonyConfig(**kw)
    trace = _offline_trace(spec, ecfg, trace_fn, "harmony", dev)
    seq, fit = BL.harmony_schedule(ecfg, trace, hcfg,
                                   generator=_seeded(spec.seed + 1, dev),
                                   device=dev)
    return ResolvedPolicy("harmony", RO.sequence_policy(ecfg), {"seq": seq},
                          True, OFFLINE, {"fitness": float(fit)})
