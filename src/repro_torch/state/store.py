"""PartitionedStateStore — the keyed window state of the continuous engine.

Each ``(key, window)`` buffer lives in the partition its key hashes to
(:func:`~repro_torch.state.partition.partition_for`); the store also keeps the
per-partition record/late counters and max event time, so a partition is a
self-contained unit of state that can be snapshotted, shipped and restored
without touching its neighbors. The serde (msgpack envelope + the broker's
npy value encoding) round-trips buffers *exactly*: key types, window
bounds, per-buffer message order, and counters all survive a migration —
the invariant ``tests/test_torch_state.py`` drives.
"""
from __future__ import annotations

import math
import pickle
from dataclasses import dataclass, field
from typing import Any, Iterable

import msgpack
import numpy as np

from repro_torch.broker.consumer import Message
from repro_torch.broker.records import decode_array, encode_array
from repro_torch.state.partition import (
    DEFAULT_PARTITIONS,
    LOCAL_OWNER,
    key_bytes,
    normalize_key,
    partition_for,
    range_assignment,
)

#: a window is the half-open interval [start, end) — streaming/windows.py
Window = tuple[float, float]


@dataclass
class StatePartition:
    """One shard of keyed state: buffers + counters, migratable as a unit."""

    pid: int
    buffers: dict[tuple, list] = field(default_factory=dict)  # (key, w) -> [Message]
    records: int = 0
    late_records: int = 0
    max_event_time: float = -math.inf

    @property
    def buffered_records(self) -> int:
        return sum(len(msgs) for msgs in self.buffers.values())


def merge_session_into(part: StatePartition, key, merged: Window) -> None:
    """Fold every buffered window of ``key`` overlapping ``merged`` into the
    ``(key, merged)`` buffer (session-window merge), preserving canonical
    event-time order. Shared by the in-process store and the worker-process
    runtime (``repro_torch.workers``) so both executors merge identically."""
    victims = [
        (k, w) for (k, w) in part.buffers
        if k == key and w != merged
        and not (w[1] <= merged[0] or w[0] >= merged[1])
    ]
    if not victims:
        return
    target = part.buffers.setdefault((key, merged), [])
    for kw in victims:
        target.extend(part.buffers.pop(kw))
    # canonical event-time order: plain fold order would depend on dict
    # insertion order, which a migration round trip permutes (restored
    # buffers come back in canonical serde order) — an order-sensitive
    # window_fn would then see rescale-dependent float low bits
    target.sort(key=lambda m: (m.timestamp, m.partition, m.offset))


def ready_buffers(partitions: Iterable[StatePartition],
                  watermark: float) -> list[tuple[Any, Window, int]]:
    """Buffers whose window closed at ``watermark``, in the deterministic
    firing order both executors share: (window end, window start, partition,
    key encoding). Dict insertion order — which a migration round trip (or a
    worker restart replay) may permute — never decides firing order."""
    out = []
    for part in partitions:
        for (key, w) in part.buffers:
            if w[1] <= watermark:
                out.append((key, w, part.pid))
    out.sort(key=lambda kwp: (kwp[1][1], kwp[1][0], kwp[2], key_bytes(kwp[0])))
    return out


class PartitionedStateStore:
    """Fixed ring of ``n_partitions`` state partitions plus the live
    partition -> owner assignment.

    All partitions are resident in-process (this reproduction is single
    host); the assignment still matters because it defines which partitions
    a rescale *moves* — and moved partitions take the full serialize ->
    spool -> deserialize round trip a real hand-off would.
    """

    def __init__(self, n_partitions: int = DEFAULT_PARTITIONS,
                 owners: Iterable[Any] | None = None):
        if n_partitions < 1:
            raise ValueError("need at least one state partition")
        self.n_partitions = n_partitions
        self.partitions: dict[int, StatePartition] = {
            p: StatePartition(p) for p in range(n_partitions)
        }
        owners = list(owners) if owners else [LOCAL_OWNER]
        self.assignment: dict[int, Any] = range_assignment(n_partitions, owners)
        # keyed streams repeat keys heavily; memoize the blake2b routing so
        # the per-record hot path pays one dict lookup, not a digest
        self._pid_cache: dict = {}

    # -- key routing ----------------------------------------------------------

    def partition_of(self, key) -> int:
        pid = self._pid_cache.get(key)
        if pid is None:
            if len(self._pid_cache) > 65536:  # pathological key cardinality
                self._pid_cache.clear()
            pid = self._pid_cache[key] = partition_for(key, self.n_partitions)
        return pid

    def owner_of(self, key) -> Any:
        return self.assignment[self.partition_of(key)]

    @property
    def owners(self) -> list:
        """Distinct owners in assignment order (partition 0 upward)."""
        out: list = []
        for p in range(self.n_partitions):
            o = self.assignment[p]
            if not out or out[-1] != o:
                out.append(o)
        return out

    # -- write path (engine ingest) -------------------------------------------

    def append(self, key, window: Window, msg: Message) -> None:
        """Buffer one message into one window (call once per assigned
        window; per-record counters live in :meth:`observe`)."""
        part = self.partitions[self.partition_of(key)]
        part.buffers.setdefault((key, window), []).append(msg)

    def observe(self, key, ts: float) -> None:
        """Per-record bookkeeping, exactly once per ingested record — a
        sliding assigner appends the same record to several windows, which
        must not inflate the partition's record count."""
        part = self.partitions[self.partition_of(key)]
        part.records += 1
        if ts > part.max_event_time:
            part.max_event_time = ts

    def record_late(self, key) -> None:
        self.partitions[self.partition_of(key)].late_records += 1

    def merge_session(self, key, merged: Window) -> None:
        """Fold every buffered window of ``key`` overlapping ``merged`` into
        the ``(key, merged)`` buffer (session-window merge). Buffer order is
        preserved: earlier windows' messages keep their relative order."""
        merge_session_into(self.partitions[self.partition_of(key)], key, merged)

    # -- read path (engine firing) ----------------------------------------------

    def _ready(self, watermark: float) -> list[tuple[Any, Window, int]]:
        return ready_buffers(self.partitions.values(), watermark)

    def pop_ready(self, watermark: float) -> list[tuple[Any, Window, list]]:
        return [
            (key, w, self.partitions[pid].buffers.pop((key, w)))
            for key, w, pid in self._ready(watermark)
        ]

    # -- aggregate views ----------------------------------------------------------

    @property
    def buffered_windows(self) -> int:
        return sum(len(p.buffers) for p in self.partitions.values())

    @property
    def buffered_records(self) -> int:
        return sum(p.buffered_records for p in self.partitions.values())

    def items(self) -> Iterable[tuple[tuple, list]]:
        """Every live ``((key, window), msgs)`` buffer across partitions."""
        for p in range(self.n_partitions):
            yield from self.partitions[p].buffers.items()


# ---------------------------------------------------------------------------
# partition serde — the wire format of a migration
# ---------------------------------------------------------------------------

_INF = float("inf")


def _enc_key(key) -> list:
    key = normalize_key(key)  # the ONE folding rule, shared with key_bytes
    if key is None:
        return ["n"]
    if isinstance(key, int):
        return ["i", str(key)]  # str: msgpack ints cap at 64 bits
    if isinstance(key, float):  # non-integral after normalization
        return ["f", key]
    if isinstance(key, str):
        return ["s", key]
    if isinstance(key, (bytes, bytearray)):
        return ["y", bytes(key)]
    if isinstance(key, tuple):
        return ["t", [_enc_key(k) for k in key]]
    # arbitrary hashable (see key_bytes): pickle restores an equal object
    return ["p", pickle.dumps(key, protocol=4)]


def _dec_key(enc: list):
    tag = enc[0]
    if tag == "n":
        return None
    if tag == "i":
        return int(enc[1])
    if tag == "t":
        return tuple(_dec_key(e) for e in enc[1])
    if tag == "p":
        return pickle.loads(enc[1])
    return enc[1]


def _enc_value(value) -> list:
    if isinstance(value, np.ndarray):
        return ["npy", encode_array(value)]
    if isinstance(value, np.generic):  # numpy scalar: keep dtype
        return ["nps", encode_array(np.asarray(value))]
    if isinstance(value, tuple):
        return ["tup", [_enc_value(v) for v in value]]
    if isinstance(value, list):
        return ["list", [_enc_value(v) for v in value]]
    return ["raw", value]  # msgpack-native (None/bool/num/str/bytes/dict)


def _dec_value(enc: list):
    tag, body = enc
    if tag == "npy":
        return decode_array(body)
    if tag == "nps":
        return decode_array(body)[()]
    if tag == "tup":
        return tuple(_dec_value(v) for v in body)
    if tag == "list":
        return [_dec_value(v) for v in body]
    return body


def serialize_partition(part: StatePartition) -> bytes:
    """Self-contained snapshot of one partition. Buffers are emitted in a
    canonical order (key encoding, then window) so equal states serialize
    identically regardless of insertion history.

    Array values are stored *columnar*: all messages sharing a (dtype,
    shape) signature stack into one contiguous blob, so restore pays one
    ``frombuffer`` per group instead of one numpy call per message —
    per-message envelopes dominated migration latency at large state
    sizes.
    """
    groups: dict[tuple, list] = {}  # (dtype.str, shape) -> [gid, [arrays]]
    # flat per-message columns (msgpack C-packs homogeneous lists fast and
    # decode rebuilds all messages in one comprehension — per-buffer nested
    # structures cost a frame per buffer, which dominated at scale)
    buffers_meta: list = []  # [enc_key, w_start, w_end, n_msgs]
    mpart: list[int] = []
    moff: list[int] = []
    mts: list[float] = []
    vgid: list[int] = []  # value group id, -1 = see vother
    vrow: list[int] = []
    vother: list = []  # [flat_index, _enc_value(...)] pairs

    for (key, w), msgs in sorted(
        part.buffers.items(), key=lambda kw: (key_bytes(kw[0][0]), kw[0][1])
    ):
        buffers_meta.append([_enc_key(key), w[0], w[1], len(msgs)])
        for m in msgs:
            mpart.append(m.partition)
            moff.append(m.offset)
            mts.append(m.timestamp)
            value = m.value
            # structured dtypes must keep the npy envelope: dtype.str for
            # them is an opaque '|V8'-style void dropping field metadata
            if (isinstance(value, np.ndarray) and value.ndim >= 1
                    and not value.dtype.hasobject
                    and value.dtype.names is None):
                arr = np.ascontiguousarray(value)
                g = groups.setdefault((arr.dtype.str, arr.shape), [len(groups), []])
                g[1].append(arr)
                vgid.append(g[0])
                vrow.append(len(g[1]) - 1)
            else:
                vother.append([len(vgid), _enc_value(value)])
                vgid.append(-1)
                vrow.append(-1)
    payload = {
        "v": 2,
        "pid": part.pid,
        "records": part.records,
        "late_records": part.late_records,
        # msgpack refuses -inf on some strict decoders; None = "no events"
        "max_event_time": None if part.max_event_time == -_INF else part.max_event_time,
        "buffers": buffers_meta,
        "mpart": mpart,
        "moff": moff,
        "mts": mts,
        "vgid": vgid,
        "vrow": vrow,
        "vother": vother,
        # dict insertion order == gid order, so a plain list round-trips
        "groups": [
            [dtype, list(shape), len(arrs), b"".join(a.tobytes() for a in arrs)]
            for (dtype, shape), (_gid, arrs) in groups.items()
        ],
    }
    return msgpack.packb(payload, use_bin_type=True)


def deserialize_partition(data: bytes) -> StatePartition:
    payload = msgpack.unpackb(data, raw=False, strict_map_key=False)
    part = StatePartition(
        pid=payload["pid"],
        records=payload["records"],
        late_records=payload["late_records"],
        max_event_time=(-_INF if payload["max_event_time"] is None
                        else payload["max_event_time"]),
    )
    # one frombuffer + copy per value group; rows are writable views that
    # own disjoint slices, so per-message mutation stays per-message
    groups = [
        np.frombuffer(blob, dtype=np.dtype(dtype)).reshape([n, *shape]).copy()
        for dtype, shape, n, blob in payload.get("groups", ())
    ]
    other = {i: _dec_value(enc) for i, enc in payload["vother"]}
    values = [
        groups[g][r] if g >= 0 else other[i]
        for i, (g, r) in enumerate(zip(payload["vgid"], payload["vrow"]))
    ]
    msgs_flat = [
        Message(p, off, ts, v)
        for p, off, ts, v in zip(payload["mpart"], payload["moff"],
                                 payload["mts"], values)
    ]
    pos = 0
    for enc_key, ws, we, n in payload["buffers"]:
        part.buffers[(_dec_key(enc_key), (ws, we))] = msgs_flat[pos:pos + n]
        pos += n
    return part
