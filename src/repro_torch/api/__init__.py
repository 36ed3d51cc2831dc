"""repro_torch.api — the unified simulation facade (port of `repro.api`).

One door to everything the repo simulates:

    Simulator(WorkloadSpec, ExecSpec).run(PolicySpec, generator) -> SimResult

* `PolicySpec` + the policy registry (`api.registry`): every scheduler —
  baselines, the EAT/PPO agents (checkpoint restore via
  `api.checkpoints.restore_params`, the reference's npz format), the
  offline meta-heuristics — under one protocol, with weight provenance
  (`trained`) made explicit.
* `WorkloadSpec`: episodic trace grids or streaming arrival processes,
  built on `core.scenarios` + `traffic.arrivals`.
* `ExecSpec`: pluggable execution backends — "reference" (the unfused
  engine), "fused" (the env_step kernel in the decision's CUDA graphs,
  default), "serving" (one physical serving cluster); "sharded" waits for
  ROADMAP Queue 1 item 15.

Consumers: SAC/PPO training collection, `traffic.sweep` and
`training.stream_train`. The pre-facade doors
(`traffic.policies.make_policy`, `baselines.evaluate_policy_batch`)
survive as thin deprecated wrappers.
"""
from repro_torch.api.backends import (device_count, resolve_shards,
                                      rollout_fn_for)
from repro_torch.api.checkpoints import restore_params
from repro_torch.api.registry import (ResolvedPolicy, UntrainedPolicyWarning,
                                      available_policies, policy_kind,
                                      register, resolve)
from repro_torch.api.simulator import (SimResult, Simulator, evaluate_batch,
                                       resolve_cell)
from repro_torch.api.specs import (BACKENDS, MODES, SIM_BACKENDS, ExecSpec,
                                   PolicySpec, WorkloadSpec)

__all__ = [
    "Simulator", "SimResult", "evaluate_batch", "resolve_cell",
    "PolicySpec", "WorkloadSpec", "ExecSpec", "BACKENDS", "SIM_BACKENDS",
    "MODES",
    "ResolvedPolicy", "UntrainedPolicyWarning", "available_policies",
    "policy_kind", "register", "resolve",
    "rollout_fn_for", "resolve_shards", "device_count",
    "restore_params",
]
