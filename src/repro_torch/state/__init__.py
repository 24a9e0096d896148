"""Partitioned keyed state for the continuous engine.

Keys hash onto a fixed ring of state partitions; elasticity remaps
partitions to owners (contiguous ranges), and a grow/shrink migrates only
the partitions whose owner changed — quiesce -> snapshot -> reassign ->
restore, with an atomic on-disk spool. ``tests/test_torch_state.py`` holds
the subsystem to the JAX package's answers and to its invariants: every key
has exactly one live owner, and no ``(key, window)`` buffer is ever lost,
duplicated, or reordered across any sequence of rescales.

An owner is any hashable: the continuous engine's plugin passes pilot
*slots* (the device pool's entry indices), not devices, so N slots of one
card own and move partitions as N distinct devices would.
"""
from repro_torch.state.migrator import MigrationReport, StateMigrator
from repro_torch.state.partition import (
    DEFAULT_PARTITIONS,
    LOCAL_OWNER,
    key_bytes,
    moved_partitions,
    normalize_key,
    partition_for,
    range_assignment,
)
from repro_torch.state.store import (
    PartitionedStateStore,
    StatePartition,
    deserialize_partition,
    serialize_partition,
)

__all__ = [
    "DEFAULT_PARTITIONS",
    "LOCAL_OWNER",
    "MigrationReport",
    "PartitionedStateStore",
    "StateMigrator",
    "StatePartition",
    "deserialize_partition",
    "key_bytes",
    "moved_partitions",
    "normalize_key",
    "partition_for",
    "range_assignment",
    "serialize_partition",
]
