"""Key -> partition -> owner mapping for partitioned keyed state.

The keyed window state of the continuous engine is sharded over a *fixed*
ring of ``n_partitions`` state partitions (Flink's "key groups"): a key is
hashed onto a partition once and forever, and elasticity only ever remaps
*partitions* to owners. A grow/shrink therefore moves whole partitions, not
individual keys, and the set of moved partitions is exactly the assignment
diff — the property the :class:`~repro_torch.state.migrator.StateMigrator` and the
``tests/test_torch_state.py`` suite are built on.

Hashing must be stable across processes and runs (``hash()`` is salted per
process for str/bytes), so keys are canonically encoded and digested with
blake2b. Numeric keys are normalized the same way Python dict equality
treats them (``3 == 3.0 == True`` share a bucket), so a store keyed by a
mix of ints and floats cannot split one dict key over two partitions.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Any, Hashable, Mapping, Sequence

import numpy as np

#: default ring size — enough granularity to split across tens of owners
#: while keeping per-partition bookkeeping cheap
DEFAULT_PARTITIONS = 64

#: owner sentinel for state that has not (yet) been spread across pilots
LOCAL_OWNER = "__local__"


def normalize_key(key: Hashable) -> Hashable:
    """Fold a key to the canonical member of its dict-equality class:
    ``np.int64(3)``, ``3.0``, ``True`` and ``3`` are ONE dict key and must
    normalize (and therefore hash and serialize) identically. The single
    normalization step shared by :func:`key_bytes` and the partition serde
    — two independent ladders would inevitably drift.
    """
    if isinstance(key, np.generic):  # np.int64/np.float64/np.str_ key_fns
        key = key.item()
    if isinstance(key, bool):
        return int(key)
    if isinstance(key, float) and key.is_integer():
        # floats equal to an int must fold to the int (0.0 == 0, and
        # float(2**53) == 2**53); int() is exact for any integral float
        return int(key)
    if isinstance(key, tuple):
        return tuple(normalize_key(k) for k in key)
    return key


def key_bytes(key: Hashable) -> bytes:
    """Canonical encoding of a state key.

    ``None``, bool, int, float, str, bytes and tuples thereof (the types
    the engines produce) encode process-stably, with equal-comparing
    numerics encoding identically — mirroring dict-key semantics. Any
    other hashable falls back to a repr-based encoding (deterministic
    in-process, so routing stays correct; see below).
    """
    key = normalize_key(key)
    if key is None:
        return b"\x00"
    if isinstance(key, float):  # non-integral after normalization
        return b"\x03" + struct.pack("<d", key)
    if isinstance(key, int):
        return b"\x02" + str(key).encode("ascii")
    if isinstance(key, str):
        return b"\x04" + key.encode("utf-8")
    if isinstance(key, (bytes, bytearray)):
        return b"\x05" + bytes(key)
    if isinstance(key, tuple):
        parts = [key_bytes(k) for k in key]
        return b"\x06" + b"".join(
            struct.pack("<I", len(p)) + p for p in parts
        )
    # any other hashable (frozenset, frozen dataclass, ...): the engine's
    # key_fn contract predates this module and allows them. repr is
    # deterministic within a process — enough for routing (equal keys are
    # one dict key and must repr equally) — though unlike the types above
    # it is not guaranteed stable across interpreter runs.
    return b"\x07" + type(key).__qualname__.encode() + b"\x00" + repr(key).encode()


def partition_for(key: Hashable, n_partitions: int = DEFAULT_PARTITIONS) -> int:
    """The partition a key permanently belongs to (consistent across
    processes, runs, and rescales)."""
    digest = hashlib.blake2b(key_bytes(key), digest_size=8).digest()
    return int.from_bytes(digest, "big") % n_partitions


def range_assignment(n_partitions: int, owners: Sequence[Any]) -> dict[int, Any]:
    """Assign partitions to owners as contiguous ranges (Flink key-group
    ranges): owner ``i`` of ``k`` gets ``[i*N//k, (i+1)*N//k)``.

    Contiguous ranges (rather than ``p % k`` striping) keep the assignment
    diff small under grow/shrink: going ``k -> k+1`` only moves the range
    tails, not every other partition. Every partition gets exactly one
    owner; with more owners than partitions the surplus owners get none.
    """
    owners = list(owners)
    if not owners:
        raise ValueError("range_assignment needs at least one owner")
    k = len(owners)
    assignment: dict[int, Any] = {}
    for i, owner in enumerate(owners):
        for p in range(i * n_partitions // k, (i + 1) * n_partitions // k):
            assignment[p] = owner
    return assignment


def moved_partitions(old: Mapping[int, Any], new: Mapping[int, Any]) -> list[int]:
    """Partitions whose owner differs between two assignments — the only
    state a migration may touch."""
    return sorted(p for p in new if old.get(p) != new[p])
