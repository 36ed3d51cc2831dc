"""`FaultSpec` — the frozen, hashable description of a fault regime (port
of `repro/faults/spec.py`, a copy: the module has no JAX in it).

One spec covers every fault class the stack can inject and the tolerance
policy that answers it:

* **server crashes**: each server alternates Exp(`mtbf`) up-time with
  Exp(`mttr`) down-time (a classic renewal availability process). A down
  server is masked out of gang selection; a gang whose member crashes
  mid-execution fails in-flight (task status 3) and its servers free at the
  crash instant. With `cold_restart` a crash also wipes the server's cached
  model + gang metadata — recovery pays the full reload (the model-load
  storm EAT schedules around).
* **stragglers**: per (window, server) with probability `straggler_prob`
  the server's execution slows by `straggler_factor`; a gang runs at its
  slowest member's speed (the DistriFusion sync barrier).
* **executor faults** (serving backend only): transient prefill/decode
  errors injected with `exec_error_prob`, plus a wall-clock `exec_timeout_s`
  on real generation; both are answered by retry (`exec_max_attempts`) and
  a final graceful-degradation attempt at `degrade_steps_frac` of the
  requested inference steps.
* **requeue policy** (streaming engine): failed gangs re-enter the backlog
  with capped exponential backoff (`backoff_base` * 2^retries, capped at
  `backoff_cap`) under a per-task budget of `max_retries` and a hard age
  deadline `retry_deadline` — a retry that could not possibly be re-served
  inside the deadline is dropped immediately (deadline-aware).

The spec rides on ``StreamConfig(faults=...)``; it is frozen and hashable
so it can key program caches. Everything is seeded (`seed`) and
host-generated, so the same spec produces the identical fault schedule on
every device, and the same one as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FaultSpec:
    seed: int = 0
    # -- server crash/recovery renewal process (stream seconds) ----------
    mtbf: float = 0.0              # mean up-time; 0 disables crashes
    mttr: float = 60.0             # mean down-time
    max_down_events: int = 16      # per-window down-interval slots/server
    cold_restart: bool = True      # recovery wipes cached model + gang
    # -- stragglers ------------------------------------------------------
    straggler_prob: float = 0.0    # P(server straggles) per window
    straggler_factor: float = 4.0  # exec-time multiplier when straggling
    # -- gang requeue policy (host, StreamRunner) ------------------------
    max_retries: int = 3           # fail budget per task; 0 = naive drop
    backoff_base: float = 2.0      # s; delay = base * 2^(retries-1)
    backoff_cap: float = 60.0      # s; exponential backoff ceiling
    retry_deadline: float = 480.0  # s; max age at re-admission, else drop
    # -- serving executor faults + tolerance -----------------------------
    exec_error_prob: float = 0.0   # injected transient prefill/decode error
    exec_timeout_s: float = 0.0    # wall budget per attempt; 0 = none
    exec_max_attempts: int = 3     # generation attempts before giving up
    degrade_steps_frac: float = 0.5  # last-attempt steps fraction; 0 = off

    def __post_init__(self):
        if self.mtbf < 0 or self.mttr <= 0:
            raise ValueError(
                f"mtbf must be >= 0 and mttr > 0, got {self.mtbf}/{self.mttr}")
        if self.max_down_events < 1:
            raise ValueError("max_down_events must be >= 1")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError("straggler_prob must be in [0, 1]")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1")
        if self.max_retries < 0 or self.exec_max_attempts < 1:
            raise ValueError("max_retries >= 0 and exec_max_attempts >= 1")
        if self.backoff_base < 0 or self.backoff_cap < 0:
            raise ValueError("backoff_base/backoff_cap must be >= 0")
        if not 0.0 <= self.exec_error_prob <= 1.0:
            raise ValueError("exec_error_prob must be in [0, 1]")
        if not 0.0 <= self.degrade_steps_frac <= 1.0:
            raise ValueError("degrade_steps_frac must be in [0, 1]")

    # ------------------------------------------------------------------
    @property
    def active(self) -> bool:
        """True when this spec injects any fault at all. An inactive spec
        (``FaultSpec.none()``) attaches nothing to the rollout: the decision
        programs — and therefore every result — are bitwise-identical to
        running with ``faults=None``."""
        return (self.mtbf > 0.0 or self.straggler_prob > 0.0
                or self.exec_error_prob > 0.0 or self.exec_timeout_s > 0.0)

    @classmethod
    def none(cls) -> "FaultSpec":
        """The explicit no-faults spec (all injection rates zero)."""
        return cls()

    @classmethod
    def chaos(cls, seed: int = 0) -> "FaultSpec":
        """An aggressive everything-on regime for smoke tests: frequent
        crashes, slow recovery relative to task service times, stragglers,
        and injected executor errors."""
        return cls(seed=seed, mtbf=120.0, mttr=30.0, straggler_prob=0.25,
                   straggler_factor=3.0, max_retries=2, backoff_base=1.0,
                   backoff_cap=16.0, retry_deadline=600.0,
                   exec_error_prob=0.5, exec_timeout_s=30.0,
                   exec_max_attempts=2, degrade_steps_frac=0.5)


def faults_active(spec) -> bool:
    """None-tolerant activity test used by every plumbing layer."""
    return spec is not None and spec.active
