"""Columnar batch frames: one header, raw array bytes, frombuffer views.

A frame is a batch of messages encoded once: arrays are grouped by
``(dtype, shape)`` — the same columnar idiom as
``repro_torch.state.store.serialize_partition`` — with a single msgpack header
(group table, per-element placement, per-element event timestamps,
optional key) followed by the groups' raw bytes back to back. Same-host
consumers decode a frame into ``numpy.frombuffer`` **views** over the
shared-memory slot: zero per-message serde, zero per-message copies.

Unlike the state store's serializer, dtypes travel as
``np.lib.format`` descriptors, so structured dtypes round-trip exactly
(``dtype.str`` is lossy for them — the property suite pins this).

``ShmArrayView`` makes the zero-copy contract explicit and portable:
it remembers which ring slot (and epoch) backs it, pickles to a slot
descriptor instead of its bytes, and reattaches by segment name in
another process — the multiprocess-worker payoff. ``verify()`` detects
a reclaim that happened under the view (epoch mismatch) instead of
letting recycled bytes pass silently.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import msgpack
import numpy as np

from repro_torch.transport.ring import SlotReclaimedError, get_ring


def _records():
    # repro_torch.broker.consumer imports this module, so a top-level import of
    # repro_torch.broker.records would cycle when repro_torch.transport loads first;
    # the npy fallback codec is only needed per non-columnar value anyway
    from repro_torch.broker import records

    return records

_LEN = 4  # u32 header-length prefix in a packed frame


def _descr_from_wire(d):
    """msgpack turns dtype-descr tuples into lists; rebuild the tuple
    shape ``descr_to_dtype`` expects (recursively, for nested records)."""
    if isinstance(d, str):
        return d
    out = []
    for f in d:
        f = list(f)
        if not isinstance(f[1], str):
            f[1] = _descr_from_wire(f[1])
        if len(f) == 3:
            f[2] = tuple(f[2])
        out.append(tuple(f))
    return out


@dataclass
class FrameBatch:
    """A decoded frame: per-element values/timestamps plus the slot
    provenance needed to validate zero-copy views after the fact."""

    values: list
    timestamps: list | None
    key: bytes | None = None
    #: (ring_name, slot, epoch) when the values are views into a ring slot
    source: tuple[str, int, int] | None = None
    zero_copy: bool = False

    def __len__(self) -> int:
        return len(self.values)

    def verify(self) -> None:
        """Detect-on-reclaim: raise :class:`SlotReclaimedError` if the
        backing slot was recycled since decode. Call after consuming
        zero-copy values; a no-op for copied-out frames."""
        if not self.zero_copy or self.source is None:
            return
        name, slot, epoch = self.source
        if not get_ring(name).is_valid(slot, epoch):
            raise SlotReclaimedError(
                f"frame views into {name} slot {slot} outlived the slot")


class ShmArrayView(np.ndarray):
    """ndarray view into a ring slot that survives pickling by descriptor.

    ``__reduce__`` ships (segment name, slot, epoch, byte offset, dtype
    descriptor, shape) — a few hundred bytes — and the receiving process
    reattaches the segment by name and rebuilds the view, epoch-checked.
    ``verify()`` re-checks the epoch after a read."""

    #: (name, slot, epoch, byte_off of the wrapped array, its data pointer)
    _slot_ref: tuple[str, int, int, int, int] | None = None

    @classmethod
    def wrap(cls, arr: np.ndarray, name: str, slot: int, epoch: int,
             byte_off: int) -> "ShmArrayView":
        view = arr.view(cls)
        view._slot_ref = (name, slot, epoch, byte_off, view.ctypes.data)
        return view

    def __array_finalize__(self, obj):
        # derived views (rows of a wrapped block, slices) inherit the
        # parent's ref untouched — this runs once per row on the decode
        # hot path, so the per-view byte offset is resolved lazily from
        # the pointer delta only when pickling or verifying
        if obj is not None and self._slot_ref is None:
            self._slot_ref = getattr(obj, "_slot_ref", None)

    def verify(self) -> None:
        if self._slot_ref is None:
            return
        name, slot, epoch = self._slot_ref[:3]
        if not get_ring(name).is_valid(slot, epoch):
            raise SlotReclaimedError(
                f"view into {name} slot {slot} outlived the slot")

    def __reduce__(self):
        if self._slot_ref is None:  # detached view: fall back to a copy
            arr = np.asarray(self)
            return (np.array, (arr.tolist(), arr.dtype))
        name, slot, epoch, base_off, base_ptr = self._slot_ref
        byte_off = base_off + (self.ctypes.data - base_ptr)
        return (_reattach_view, (
            name, slot, epoch, byte_off,
            np.lib.format.dtype_to_descr(self.dtype), self.shape))


def _reattach_view(name, slot, epoch, byte_off, descr, shape) -> ShmArrayView:
    ring = get_ring(name)
    buf = ring.view(slot, epoch)  # raises SlotReclaimedError when recycled
    dtype = np.lib.format.descr_to_dtype(descr)
    n = math.prod(shape)
    arr = np.frombuffer(buf, dtype=dtype, count=n, offset=byte_off).reshape(shape)
    return ShmArrayView.wrap(arr, name, slot, epoch, byte_off)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _groupable(arr: np.ndarray) -> bool:
    return arr.ndim >= 1 and not arr.dtype.hasobject


#: dtype -> (descr, hashable-key): dtype_to_descr costs ~13us and detector
#: batches call it once per frame element — cache by dtype identity
_DESCR_CACHE: dict = {}


def _descr_for(dtype: np.dtype) -> tuple:
    entry = _DESCR_CACHE.get(dtype)
    if entry is None:
        descr = np.lib.format.dtype_to_descr(dtype)
        entry = (descr, repr(descr))
        if len(_DESCR_CACHE) < 1024:
            _DESCR_CACHE[dtype] = entry
    return entry


def _encode_uniform(arrs, timestamps, key: bytes | None):
    """Single-group encode for the detector-ingest common case: every
    value is a contiguous ndarray of one dtype and shape, so the group
    table, placement vectors, and parts fall out without per-element
    grouping machinery."""
    n = len(arrs)
    a0 = arrs[0]
    descr, _ = _descr_for(a0.dtype)
    header = msgpack.packb({
        "v": 1,
        "n": n,
        "groups": [[descr, list(a0.shape), n, 0]],
        "vgid": [0] * n,
        "vrow": list(range(n)),
        "other": [],
        "ts": list(timestamps) if timestamps is not None else None,
        "key": key,
    }, use_bin_type=True)
    return header, [memoryview(a).cast("B") for a in arrs]


def encode_frame(values, timestamps=None, key: bytes | None = None):
    """Columnar-encode a batch into ``(header_bytes, parts)`` where
    ``parts`` are buffer-protocol views over the source arrays (no
    intermediate concatenation — the only copy happens when a caller
    writes the parts into a ring slot or joins them inline)."""
    if values and isinstance(values[0], np.ndarray):
        a0 = values[0]
        # dtype identity (not equality) short-circuits: a false negative
        # just takes the general path below, which handles everything
        if (a0.ndim >= 1 and not a0.dtype.hasobject and all(
                isinstance(v, np.ndarray) and v.dtype is a0.dtype
                and v.shape == a0.shape and v.flags.c_contiguous
                for v in values)):
            return _encode_uniform(values, timestamps, key)
    groups: dict[tuple[str, tuple], list] = {}
    vgid: list[int] = []
    vrow: list[int] = []
    other: list[tuple[int, bytes]] = []
    group_list: list[list] = []
    parts: list = []
    for i, v in enumerate(values):
        arr = v if isinstance(v, np.ndarray) else None
        if arr is None and isinstance(v, (int, float, list, tuple)):
            arr = np.asarray(v)
        if arr is not None and _groupable(arr):
            arr = np.ascontiguousarray(arr)
            # structured descrs are (unhashable) nested lists: key on repr
            descr, rkey = _descr_for(arr.dtype)
            gkey = (rkey, arr.shape)
            entry = groups.get(gkey)
            if entry is None:
                entry = [len(group_list), 0]
                groups[gkey] = entry
                group_list.append([descr, list(arr.shape), 0, arr.dtype.itemsize])
            vgid.append(entry[0])
            vrow.append(entry[1])
            entry[1] += 1
            group_list[entry[0]][2] += 1
            parts.append((entry[0], memoryview(arr).cast("B")))
        else:
            # non-columnar fallback: npy envelope inside the frame (0-d,
            # object arrays, raw bytes...) — still one header per batch
            blob = v if isinstance(v, bytes) else _records().encode_array(np.asarray(v))
            tag = 0 if isinstance(v, bytes) else 1
            vgid.append(-1)
            vrow.append(len(other))
            other.append((tag, blob))
    # lay groups out contiguously: group 0's rows, then group 1's, ...
    parts.sort(key=lambda t: t[0])
    payload_parts = [p for _, p in parts]
    offsets, off = [], 0
    for g in group_list:
        offsets.append(off)
        off += g[2] * g[3] * math.prod(g[1])
    header = msgpack.packb({
        "v": 1,
        "n": len(values),
        "groups": [[g[0], g[1], g[2], o] for g, o in zip(group_list, offsets)],
        "vgid": vgid,
        "vrow": vrow,
        "other": [[t, b] for t, b in other],
        "ts": list(timestamps) if timestamps is not None else None,
        "key": key,
    }, use_bin_type=True)
    return header, payload_parts


def pack_frame(values, timestamps=None, key: bytes | None = None) -> bytes:
    """One contiguous buffer: u32 header length, header, payload — the
    exact layout a ring slot holds, reusable as an inline (copy-out)
    record value."""
    header, parts = encode_frame(values, timestamps, key)
    return b"".join([len(header).to_bytes(_LEN, "little"), header, *parts])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_frame(buf, *, zero_copy: bool = False,
                 source: tuple[str, int, int] | None = None) -> FrameBatch:
    """Decode a packed frame. ``zero_copy=True`` returns views into
    ``buf`` (:class:`ShmArrayView` when ``source`` names the backing ring
    slot); the default copies out — one bulk copy per *group*, never per
    message, so the batch win survives even on the safe path."""
    mv = memoryview(buf)
    hlen = int.from_bytes(mv[:_LEN], "little")
    header = msgpack.unpackb(mv[_LEN:_LEN + hlen], raw=False)
    payload = mv[_LEN + hlen:]
    rows_by_group: list[list] = []
    for descr, shape, n, off in header["groups"]:
        dtype = np.lib.format.descr_to_dtype(_descr_from_wire(descr))
        shape = tuple(shape)
        per = math.prod(shape)
        block = np.frombuffer(payload, dtype=dtype, count=n * per, offset=off)
        block = block.reshape((n, *shape))
        if not zero_copy:
            block = block.copy()
        if zero_copy and source is not None:
            name, slot, epoch = source
            block = ShmArrayView.wrap(block, name, slot, epoch,
                                      _LEN + hlen + off)
        rows = list(block)
        rows_by_group.append(rows)
    other = header["other"]
    values: list[Any] = []
    for gid, row in zip(header["vgid"], header["vrow"]):
        if gid >= 0:
            values.append(rows_by_group[gid][row])
        else:
            tag, blob = other[row]
            values.append(blob if tag == 0 else _records().decode_array(blob))
    return FrameBatch(values=values, timestamps=header["ts"], key=header["key"],
                      source=source, zero_copy=zero_copy)


def unpack_frame(buf, *, zero_copy: bool = False,
                 source: tuple[str, int, int] | None = None) -> FrameBatch:
    """Alias kept next to :func:`pack_frame` for symmetry."""
    return decode_frame(buf, zero_copy=zero_copy, source=source)
