"""Declarative specs for the unified simulation facade (port of
`repro/api/specs.py`).

One simulation = (what schedules) x (what arrives) x (how it executes):

    PolicySpec   — a registered policy name plus weight provenance
                   (checkpoint dir / in-memory params / fresh seed) and
                   builder options. Resolved by `api.registry`.
    WorkloadSpec — an episodic trace grid or a streaming arrival process,
                   built from a `core.scenarios.Scenario` cell.
    ExecSpec     — which execution backend runs the batched rollout:
                   "reference" (the unfused engine on the compositional
                   `env.step_with_queue`), "fused" (the env_step kernel
                   inside the decision's CUDA graphs, the default),
                   "sharded" (several devices; not ported, ROADMAP Queue
                   1 item 15), or "serving" (the real serving cluster:
                   one physical pool running actual model prefill/decode).

`Simulator(workload, exec_spec).run(policy_spec, generator)` is the single
door; every spec is data, so a sweep is a list of specs, not a bespoke
loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

from repro_torch.core.scenarios import Scenario
from repro_torch.faults import FaultSpec
from repro_torch.placement import PlacementSpec
from repro_torch.telemetry.trace import TraceConfig

BACKENDS = ("reference", "fused", "sharded", "serving")
#: batch-parallel simulated backends — "serving" drives ONE physical
#: cluster (batch/streams must be 1), so sweeps over arbitrary batch
#: sizes should iterate these instead of BACKENDS.
SIM_BACKENDS = ("reference", "fused", "sharded")
MODES = ("episodic", "streaming")
#: the fused engine's env step: "auto" (the kernel on the card, the plain
#: version on the CPU) or "ref" (the plain version anywhere)
FUSED_IMPLS = ("auto", "ref")


@dataclass(frozen=True, eq=False)
class PolicySpec:
    """Name -> policy, with weight provenance made explicit.

    `params` short-circuits loading (already-trained in-memory weights);
    `checkpoint` restores the latest step via `api.checkpoints
    .restore_params`; neither means learned policies resolve to *fresh*
    weights and are flagged `trained=False` (with an `UntrainedPolicyWarning`)
    so sweep summaries cannot pass off an untrained agent as the paper's.
    `options` feeds the registry builder (e.g. ``{"acfg": AgentConfig(...)}``
    for "eat", ``{"seq_len": 512}`` for the offline meta-heuristics).

    `sampler` selects how a diffusion actor turns its denoiser into an
    action mean (``"ddpm"`` — the full T-step chain, the default —
    ``"ddim:K"`` strided deterministic sampling, or ``"distilled"`` — the
    one-call student head trained by `training.distill`; see
    `repro_torch.actors`). Ignored by non-diffusion policies only in the sense
    that they reject anything but the default. ``None`` means "ddpm".
    """
    name: str
    checkpoint: Optional[str] = None
    params: Any = None
    seed: int = 0
    options: Mapping[str, Any] = field(default_factory=dict)
    sampler: Optional[str] = None


@dataclass(frozen=True, eq=False)
class WorkloadSpec:
    """What the simulator schedules: one scenario cell, episodic or streaming.

    * ``mode="episodic"``: `batch` fresh traces of the cell run to completion
      (`num_steps` caps the decision budget; `collect=True` returns stacked
      transitions for training consumers).
    * ``mode="streaming"``: `batch` parallel open-loop streams, `num_windows`
      windows of `window_tasks` tasks each (`window_tasks=None` keeps the
      cell's episodic `max_tasks`), with the cell's arrival process (Poisson
      at the cell rate when the scenario has none). `collect=True` is the
      streaming *training* mode: each window's stacked (B, T, ...)
      transitions come back on `SimResult.raw.transitions` for training
      consumers (`repro.training.stream_train` drives the window engine
      directly for bounded memory).
    """
    scenario: Scenario
    mode: str = "episodic"
    batch: int = 32
    num_steps: Optional[int] = None
    collect: bool = False
    # streaming-only knobs (mirror traffic.stream.StreamConfig)
    num_windows: int = 16
    window_tasks: Optional[int] = None
    max_steps_per_window: Optional[int] = None
    max_carry: Optional[int] = None
    resp_sla: float = 120.0
    chunk_size: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")

    @classmethod
    def episodic(cls, scenario: Scenario, *, batch: int = 32,
                 num_steps: Optional[int] = None,
                 collect: bool = False) -> "WorkloadSpec":
        return cls(scenario=scenario, mode="episodic", batch=batch,
                   num_steps=num_steps, collect=collect)

    @classmethod
    def streaming(cls, scenario: Scenario, *, streams: int = 32,
                  num_windows: int = 16, window_tasks: Optional[int] = None,
                  max_steps_per_window: Optional[int] = None,
                  max_carry: Optional[int] = None, resp_sla: float = 120.0,
                  chunk_size: int = 0, collect: bool = False) -> "WorkloadSpec":
        return cls(scenario=scenario, mode="streaming", batch=streams,
                   num_windows=num_windows, window_tasks=window_tasks,
                   max_steps_per_window=max_steps_per_window,
                   max_carry=max_carry, resp_sla=resp_sla,
                   chunk_size=chunk_size, collect=collect)


@dataclass(frozen=True)
class ExecSpec:
    """How the batched rollout executes. Hashable.

    * ``backend="fused"`` (default): the fused env-step engine
      (`batch_rollout(fused=True, impl=fused_impl)`) — one env_step launch
      advances all B envs per decision, inside the decision's CUDA graph.
    * ``backend="reference"``: the unfused engine on the compositional
      `env.step_with_queue` (`batch_rollout(fused=False)`; equal results,
      slower; the oracle).
    * ``backend="sharded"``: the fused engine over a 1-D device mesh
      (`launch.mesh.make_data_mesh`, driven from one process) — the
      batch/stream axis splits over `mesh_devices` devices (0 = all CUDA
      devices, or one on the host, where any count may be asked for;
      degraded to gcd(batch, devices) when the batch does not divide).
      One shard equals "fused" in every tensor; with n shards, shard s
      draws from child s of `api.simulator.split_generator(generator, n)`
      (`api.backends.rollout_fn_for`), and policies that draw nothing
      equal "fused" for any n.
    * ``backend="serving"``: the real serving cluster
      (`repro_torch.serving.backend.ServingRollout`) — ONE physical pool
      (batch/streams must be 1) running actual weight loads and
      patch-parallel prefill/decode per scheduled task. In virtual time
      (``serving_wall_clock=False``, default) the decision process equals
      "fused" at batch 1 in every tensor; with ``serving_wall_clock=True``
      measured execution seconds feed latencies, rewards, and
      observations (the sim-to-real loop).

    Serving knobs (`serving_*`) are ignored by the simulated backends.
    `serving_archs=()` resolves to `common.config.ASSIGNED_ARCHS` (all ten
    families); `serving_execute=False` skips real model execution (pure-mirror mode
    for fast parity checks — pool economics still accrue).

    ``faults`` turns on deterministic fault injection
    (`repro_torch.faults.FaultSpec`): seeded per-server crash/recovery windows,
    straggler slowdowns, and cold-restart cache wipes enter the decision
    step of every backend through extra trace columns, and the serving
    backend additionally arms its executor-level error/timeout injector
    with retry + degraded-fallback handling. ``None`` (the default) and
    ``FaultSpec.none()`` are bitwise-identical to a fault-free run — the
    fault branch is keyed off the trace columns, so the decision program
    is exactly the pre-fault one.

    ``placement`` turns on the slow timescale (`repro_torch.placement`):
    a `PlacementSpec` names a placement policy ("static" | "lfu" |
    "forecast" | registered) that decides at every stream-window seam
    which models stay resident on which idle servers, pre-forming
    complete gangs the fast scheduler reuses without a cold start (the
    serving backend additionally prefetches/evicts the real weights off
    the timed path). Streaming-only — it acts at window seams, so the
    Simulator rejects it in episodic mode. ``None`` (the default) and
    ``PlacementSpec.none()`` are bitwise-identical to a placement-free
    run on every backend: placement only rewrites host-side carry state
    between windows and never touches a decision program.

    ``trace`` is the observability front door
    (`repro_torch.telemetry.TraceConfig`): with ``enabled=True`` every layer a
    run touches — Simulator, StreamRunner, the streaming trainers, the
    serving backend — emits host-side spans into ONE trace file
    (Chrome trace-event JSON + JSONL), and `TraceConfig.profile_decisions`
    adds a per-decision policy-inference latency probe to the result
    summary. Disabled (the default) it is the shared no-op tracer: zero
    overhead, bitwise-identical results.
    """
    backend: str = "fused"
    fused_impl: str = "auto"       # fused: "auto" | "ref"
    mesh_devices: int = 0          # sharded: devices on the mesh (0 = all)
    mesh_axis: str = "data"        # sharded: mesh axis name
    serving_archs: tuple = ()      # serving: model zoo archs (by env model id)
    serving_reduced: bool = True   # serving: reduced-config real models
    serving_wall_clock: bool = False   # serving: measured latencies feed MDP
    serving_execute: bool = True   # serving: run real prefill/decode
    serving_prompt_len: int = 8    # serving: synthetic prompt tokens
    serving_max_new_tokens: int = 16   # serving: request decode budget
    serving_seed: int = 0          # serving: prompt/weight-init PRNG seed
    serving_warmup: Optional[bool] = None  # serving: run each executor
    #                                  shape once before timing tasks (None
    #                                  = on iff serving_wall_clock)
    faults: Optional[FaultSpec] = None  # deterministic fault injection
    placement: Optional[PlacementSpec] = None  # slow-timescale placement
    trace: TraceConfig = TraceConfig()  # telemetry front door (see above)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.fused_impl not in FUSED_IMPLS:
            raise ValueError(
                f"fused_impl must be one of {FUSED_IMPLS}, got "
                f"{self.fused_impl!r}")
