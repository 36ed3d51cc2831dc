"""DEPRECATED policy-adapter layer — use `repro_torch.api` instead (port of
`repro/traffic/policies.py`).

`make_policy(name, ecfg, ...)` predates the unified facade; the policy
registry (`repro_torch.api.registry`) now resolves every scheduler —
baselines, EAT/PPO (with uniform checkpoint restore via
`api.restore_params`), and the offline meta-heuristics — under one
protocol, with weight provenance made explicit (`ResolvedPolicy.trained`).
This module survives as a thin wrapper so pre-facade callers keep working;
no module of the port calls it.

    # old                                # new
    make_policy("eat", ecfg,             api.resolve(
        checkpoint=d)                        api.PolicySpec("eat",
                                                 checkpoint=d), ecfg)
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import env as EV

BASELINES = ("random", "fifo", "greedy")
LEARNED = ("eat", "ppo")


def available_policies() -> Tuple[str, ...]:
    """Names this wrapper can build: the registry minus the offline
    meta-heuristics (they need a workload trace to optimise on, which the
    tuple-returning `make_policy` interface cannot supply — resolve them
    through `api.Simulator` / `api.resolve(..., trace_fn=)`)."""
    from repro_torch.api import registry as REG
    return tuple(n for n in REG.available_policies()
                 if REG.policy_kind(n) != REG.OFFLINE)


def make_policy(name: str, ecfg: EV.EnvConfig, *, acfg=None,
                checkpoint: Optional[str] = None, params=None,
                seed: int = 0, device=None) -> Tuple[Callable, Dict]:
    """Deprecated: resolve a PolicySpec through `repro_torch.api` instead.

    Thin wrapper over `api.registry.resolve`; same (policy_fn, params)
    return. A learned policy resolved to fresh weights emits an
    `UntrainedPolicyWarning` (the registry's `trained=False` flag is
    dropped by this tuple interface — another reason to migrate)."""
    warnings.warn(
        "traffic.policies.make_policy is deprecated; use repro_torch.api "
        "(registry.resolve / PolicySpec)", DeprecationWarning, stacklevel=2)
    from repro_torch.api import registry as REG
    from repro_torch.api.specs import PolicySpec
    options = {"acfg": acfg} if acfg is not None else {}
    rp = REG.resolve(PolicySpec(name=name, checkpoint=checkpoint,
                                params=params, seed=seed, options=options),
                     ecfg, device=device)
    return rp.policy, rp.params
