"""Pluggable execution backends for the batched rollout engine (port of
`repro/api/backends.py`).

Every backend is one callable with the port's `batch_rollout` calling
convention:

    fn(ecfg, traces, policy, params, *, generator=None, num_steps=None,
       collect=False, init_state=None, device=None) -> RolloutResult

(a `torch.Generator` where the reference takes per-env `keys`), so
episodic evaluation, streaming windows (`StreamRunner(rollout_fn=...)`)
and training collection all swap engines through one seam:

* ``reference`` — the unfused engine on the compositional
  `env.step_with_queue` (`batch_rollout(fused=False)`); the oracle.
* ``fused`` — the fused engine (`batch_rollout(fused=True,
  impl=spec.fused_impl)`): one env_step launch per decision inside the
  decision's CUDA graphs on the card, the default.
* ``sharded`` — the batch axis over several devices. Not ported (ROADMAP
  Queue 1 item 15): resolving it raises. `device_count` and
  `resolve_shards` keep the reference's arithmetic for that item.
* ``serving`` — the real serving cluster (`repro_torch.serving.backend`):
  one physical pool (batch must be 1) whose scheduler state is a mirror
  `EnvState` advanced by the env_step kernel at batch 1, with real weight
  loads and patch-parallel prefill/decode per scheduled task. Virtual time
  equals ``fused`` at batch 1; wall-clock mode patches measured latencies
  back into rewards and observations. The returned callable is STATEFUL
  (the pool persists across calls — that is the point); build one per
  consumer via `rollout_fn_for` and `reset()` it between runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.api.specs import BACKENDS, ExecSpec
from repro_torch.core import rollout as RO

#: what `ExecSpec(backend="sharded")` raises until the multi-device port
SHARDED_NOT_PORTED = (
    "the sharded backend (the batch axis over a device mesh) is not ported "
    "yet (ROADMAP Queue 1 item 15); use backend='fused'")


def device_count() -> int:
    """CUDA devices visible to the sharded backend."""
    return torch.cuda.device_count()


def resolve_shards(batch: int, spec: ExecSpec) -> int:
    """Mesh size the sharded backend would use for a batch: the requested
    device count (0 = all local), degraded to gcd(batch, devices) when the
    batch axis does not divide evenly."""
    want = spec.mesh_devices or device_count()
    if want > device_count():
        raise ValueError(
            f"ExecSpec.mesh_devices={spec.mesh_devices} but only "
            f"{device_count()} local devices exist")
    return math.gcd(int(batch), want)


def rollout_fn_for(spec: ExecSpec = ExecSpec()):
    """Resolve an ExecSpec to a rollout callable (`batch_rollout`
    convention). The callable is safe to reuse across calls and batch
    sizes; each policy's decision program (and its CUDA graphs) is cached
    underneath by `actors.program.actor_program`."""
    if not isinstance(spec, ExecSpec):
        raise ValueError("exec_spec must be the API facade's "
                         "repro_torch.api.ExecSpec, got "
                         f"{type(spec).__name__}")
    if spec.backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS}, got {spec.backend!r}")

    if spec.backend == "serving":
        # lazy: the serving stack (model zoo, executor) is heavy and only
        # needed when actually serving. Fresh state per resolution — each
        # consumer owns its own pool, persistent across its windows/rounds.
        from repro_torch.serving.backend import serving_rollout
        return serving_rollout(spec)

    if spec.backend == "sharded":
        raise NotImplementedError(SHARDED_NOT_PORTED)

    fused = spec.backend == "fused"

    def fn(ecfg, traces, policy, params, *, generator=None, num_steps=None,
           collect=False, init_state=None, device=None):
        return RO.batch_rollout(ecfg, traces, policy, params,
                                generator=generator, num_steps=num_steps,
                                collect=collect, init_state=init_state,
                                device=device, fused=fused,
                                impl=spec.fused_impl)
    fn.backend = spec.backend
    return fn
