"""Unified resource arbitration (paper §4.2, promoted to cluster level).

One :class:`ResourceArbiter` per :class:`PilotComputeService` mediates every
consumer's demand — pipeline stages, the broker, training jobs — against
the shared ``DevicePool``: weighted fair share within priority tiers, gang
(all-or-nothing) grants for ``colocate_with`` groups, online bin-packing
for placement (:class:`OnlinePacker` — bins are amended, not recomputed),
preemption under pressure. Consumers file :class:`ResourceRequest`\\ s
instead of acquiring pilots themselves and receive grants back.
"""
from repro_torch.scheduler.arbiter import (
    PoolTenant,
    ResourceArbiter,
    colocation_groups,
    weighted_fair_share,
)
from repro_torch.scheduler.packing import OnlinePacker
from repro_torch.scheduler.request import DEVICES, HOSTS, ResourceRequest

__all__ = [
    "DEVICES",
    "HOSTS",
    "OnlinePacker",
    "PoolTenant",
    "ResourceArbiter",
    "ResourceRequest",
    "colocation_groups",
    "weighted_fair_share",
]
