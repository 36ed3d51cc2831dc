"""Two-timescale model placement: proactive caching ahead of the fast
scheduler (port of `repro/placement`; see docs/placement.md).

The fast timescale — the paper's per-task scheduler — is untouched. The
slow timescale decides at every stream-window seam which models stay
resident on which idle servers, forming complete synthetic gangs the fast
scheduler's reuse test recognises, so matching tasks skip the ~Table-VI
cold-start penalty. `placement=None` is bitwise-identical to a run without
the subsystem: placement only ever rewrites the carried state between
windows.
"""
from repro_torch.placement.manager import PlacementDecision, PlacementManager
from repro_torch.placement.plan import StreamPlacement, plan_gangs, plan_stream
from repro_torch.placement.policies import (get_placement_policy,
                                            known_policies, prior_weights,
                                            register_placement)
from repro_torch.placement.spec import PlacementSpec, placement_active
from repro_torch.placement.stats import DemandStats

__all__ = [
    "DemandStats", "PlacementDecision", "PlacementManager", "PlacementSpec",
    "StreamPlacement", "get_placement_policy", "known_policies",
    "placement_active", "plan_gangs", "plan_stream", "prior_weights",
    "register_placement",
]
