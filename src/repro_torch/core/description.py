"""Pilot-Compute-Description — the paper's Listing 2 key/value spec.

All SAGA-style attributes map 1:1 onto this dataclass; ``resource`` selects
the backend ("local://localhost" = in-process devices; a real deployment
would register slurm://... adaptors the same way).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class PilotComputeDescription:
    resource: str = "local://localhost"
    working_directory: str = "/tmp/pilot-streaming"
    number_of_nodes: int = 1
    cores_per_node: int = 1
    framework: str = "taskpool"  # registered plugin name (paper: "type")
    walltime: int = 3600
    queue: str = "normal"
    project: str = ""
    #: extension (paper Listing 4): lease is added to the parent's cluster
    parent: Optional[Any] = None
    #: framework-native configuration (paper §4.2 "custom configurations")
    config: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "PilotComputeDescription":
        """Accept the paper's key style (``pilot_compute_description`` dict)."""
        known = {f for f in cls.__dataclass_fields__}
        kw = {}
        extra = {}
        for k, v in d.items():
            k2 = k.lower()
            if k2 == "type":  # paper uses "type": "spark" | "kafka" | "dask"
                k2 = "framework"
            if k2 in known:
                kw[k2] = v
            else:
                extra[k] = v
        pcd = cls(**kw)
        pcd.config.update(extra)
        return pcd
