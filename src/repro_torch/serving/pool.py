"""Logical edge-server pool: loaded weights, gang bookkeeping, cold-start
economics (port of `repro/serving/pool.py`; pure Python, copied).

`ServerPool` holds the N logical edge servers of the paper's Fig.-1 system.
Each server carries at most one loaded model (real params on the device),
the gang it last served (leader id + size) and when it frees up. Loading is
real work (weight materialisation via `model.init`); reuse skips it —
exactly the cold-start economics the scheduler is trained around (paper
Eq. 1, §V.B.4). The host-loop `ServingEngine` (`serving.engine`) asks the
pool for gangs (`find_reusable_gang` / `pick_fresh`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class LogicalServer:
    sid: int
    model_name: Optional[str] = None
    params: Optional[object] = None
    gang: int = -1                # request id of last gang
    gang_size: int = 0
    busy_until: float = 0.0


class ServerPool:
    def __init__(self, num_servers: int):
        self.servers = [LogicalServer(i) for i in range(num_servers)]
        self.load_count = 0
        self.reuse_count = 0
        # fault-tolerance ledger (the reference's serving backend fills
        # it): kept OUT of `counters()`, whose key set is pinned by tests
        self.exec_failures = 0        # transient errors + timeouts observed
        self.exec_retries = 0         # re-attempts after a transient failure
        self.exec_degraded = 0        # reduced-steps fallback completions
        self.exec_gave_up = 0         # tasks abandoned after the last attempt
        self.crashed_tasks = 0        # gangs skipped: server down at dispatch

    def idle(self, now: float) -> List[LogicalServer]:
        return [s for s in self.servers if s.busy_until <= now]

    def find_reusable_gang(self, arch: str, c: int, now: float):
        """A complete idle gang with matching model and size (paper Eq. 1).

        Exact-match semantics: every member must be idle, hold `arch`, and
        belong to the same gang whose recorded size is exactly `c` — a
        broken gang (any member busy or re-assigned) never matches. Ties
        resolve to the lowest gang id."""
        groups: Dict[int, List[LogicalServer]] = {}
        for s in self.idle(now):
            if s.model_name == arch and s.gang_size == c and s.gang >= 0:
                groups.setdefault(s.gang, []).append(s)
        for gid, members in sorted(groups.items()):
            if len(members) == c:
                return members
        return None

    def pick_fresh(self, c: int, now: float,
                   arch: Optional[str] = None) -> Optional[List[LogicalServer]]:
        """Fragmentation-aware greedy (§V.B.4): prefer breaking already-broken
        gangs; among intact gangs break the smallest.

        Among equally fragmented candidates, servers already holding `arch`
        rank first — a fresh gang on warm idle servers skips their weight
        loads instead of cold-loading next to them. Pool-only: the
        simulated `_select_servers` keeps its own order (`arch=None`
        reproduces it)."""
        idle = self.idle(now)
        if len(idle) < c:
            return None
        idle_ids = {s.sid for s in idle}

        def intact(s: LogicalServer) -> bool:
            if s.gang < 0:
                return False
            members = [t for t in self.servers
                       if t.gang == s.gang and t.gang_size == s.gang_size]
            return all(t.sid in idle_ids for t in members)

        def arch_miss(s: LogicalServer) -> int:
            return 0 if (arch is None or s.model_name == arch) else 1

        idle.sort(key=lambda s: (intact(s) * (100 + 10 * s.gang_size),
                                 arch_miss(s), s.sid))
        return idle[:c]

    # -- economics ------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return {"model_loads": self.load_count,
                "model_reuses": self.reuse_count}

    def fault_counters(self) -> Dict[str, int]:
        """The fault-tolerance ledger (all zero in a fault-free run)."""
        return {"exec_failures": self.exec_failures,
                "exec_retries": self.exec_retries,
                "exec_degraded": self.exec_degraded,
                "exec_gave_up": self.exec_gave_up,
                "crashed_tasks": self.crashed_tasks}

    def reset(self) -> None:
        """Drop every loaded model and the load/reuse ledger (fresh cluster)."""
        for s in self.servers:
            s.model_name, s.params = None, None
            s.gang, s.gang_size, s.busy_until = -1, 0, 0.0
        self.load_count = 0
        self.reuse_count = 0
        self.exec_failures = 0
        self.exec_retries = 0
        self.exec_degraded = 0
        self.exec_gave_up = 0
        self.crashed_tasks = 0
