"""Control plane / data plane split: ring slot handles in the log.

``ShmTransport`` mounts one :class:`SharedMemoryRing` per topic. The
:class:`PartitionLog` keeps doing everything it already does — offset
assignment, acks-all replication metadata, retention, blocking reads —
but for shm topics a record's *value* shrinks to an ``S``-tagged slot
handle (ring name, slot, epoch, element row): a few dozen bytes of
control plane, while the payload sits in shared memory, written once.

Slot lifetime is tied to consumer progress, not log retention: the
cluster reports commit/replay floors (min over registered groups, with
checkpointing streams pinning their replay horizon) and
``reclaim_below`` releases every slot whose frame is wholly below the
floor. A full ring therefore stalls the *producer* — backpressure —
until consumers commit, and the stall feeds the same saturation signal
as the token buckets.

Copy-out rules: replication_factor > 1 means a slot
handle would alias one mutable payload across replicas whose logs must
survive the ring's host — so ``use_ring`` refuses and the producer falls
back to inline per-record serde. Oversized frames (> slot_bytes) fall
back the same way. Consumers that outlive a slot get
:class:`SlotReclaimedError` (epoch mismatch), never recycled bytes.
"""
from __future__ import annotations

import struct
import threading
from collections import OrderedDict, deque

from repro_torch.transport.frames import decode_frame
from repro_torch.transport.ring import SharedMemoryRing, get_ring

TAG_SLOT = b"S"

# fixed-layout wire format (struct beats msgpack ~5x on this hot path):
# b"S" | u8 name_len | name | u32 slot | u64 epoch | u32 row
_SLOT_TAIL = struct.Struct("<IQI")


def slot_record_prefix(ring_name: str, slot: int, epoch: int) -> bytes:
    """Everything but the row — producers emit one record per frame
    element, so the shared prefix is built once per frame."""
    nb = ring_name.encode()
    return b"".join((TAG_SLOT, bytes((len(nb),)), nb,
                     struct.pack("<IQ", slot, epoch)))


_ROW = struct.Struct("<I")
pack_row = _ROW.pack


def encode_slot_record(ring_name: str, slot: int, epoch: int, row: int) -> bytes:
    """The entire on-log value of one shm-transported message."""
    nb = ring_name.encode()
    return b"".join((TAG_SLOT, bytes((len(nb),)), nb,
                     _SLOT_TAIL.pack(slot, epoch, row)))


def decode_slot_record(data: bytes):
    """-> (ring_name, slot, epoch, row)"""
    ln = data[1]
    slot, epoch, row = _SLOT_TAIL.unpack_from(data, 2 + ln)
    return data[2:2 + ln].decode(), slot, epoch, row


class FrameCache:
    """Small per-consumer LRU of decoded frames keyed by slot incarnation:
    expanding N records of one frame decodes the header exactly once."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._frames: OrderedDict[tuple, object] = OrderedDict()

    def get(self, key):
        frame = self._frames.get(key)
        if frame is not None:
            self._frames.move_to_end(key)
        return frame

    def put(self, key, frame) -> None:
        self._frames[key] = frame
        self._frames.move_to_end(key)
        while len(self._frames) > self.capacity:
            self._frames.popitem(last=False)

    def clear(self) -> None:
        """Drop cached frames (and any zero-copy views they pin) so ring
        segments can close cleanly — consumers call this on shutdown."""
        self._frames.clear()


class ShmTransport:
    """Per-topic rings plus the offset→slot bookkeeping that drives
    consumer-progress reclaim. Attach to a cluster with
    ``cluster.attach_transport(transport)``."""

    def __init__(self, *, slot_bytes: int = 1 << 20, n_slots: int = 64):
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots
        self._rings: dict[str, SharedMemoryRing] = {}
        #: (topic, partition) -> deque[(last_offset_of_frame, slot, epoch)]
        self._tracked: dict[tuple[str, int], deque] = {}
        #: last reclaim floor seen per partition (for the lazy pass)
        self._floors: dict[tuple[str, int], int] = {}
        self._lock = threading.Lock()

    # ---- mounting -----------------------------------------------------------

    def mount(self, topic: str, *, slot_bytes: int | None = None,
              n_slots: int | None = None) -> SharedMemoryRing:
        with self._lock:
            ring = self._rings.get(topic)
            if ring is None:
                ring = SharedMemoryRing(slot_bytes=slot_bytes or self.slot_bytes,
                                        n_slots=n_slots or self.n_slots)
                self._rings[topic] = ring
            return ring

    def unmount(self, topic: str) -> None:
        with self._lock:
            ring = self._rings.pop(topic, None)
            for key in [k for k in self._tracked if k[0] == topic]:
                del self._tracked[key]
        if ring is not None:
            ring.destroy()

    def ring_for(self, topic: str) -> SharedMemoryRing | None:
        with self._lock:
            return self._rings.get(topic)

    def serves(self, topic: str) -> bool:
        with self._lock:
            return topic in self._rings

    # ---- producer path ------------------------------------------------------

    def use_ring(self, topic: str, replication_factor: int) -> SharedMemoryRing | None:
        """The copy-out gate: a ring, or None when payloads must travel
        inline (topic not mounted, or rf>1 — replica logs must not alias
        one reclaimable slot)."""
        if replication_factor > 1:
            return None
        return self.ring_for(topic)

    def write_frame(self, topic: str, header: bytes, parts,
                    *, deadline: float | None = None) -> tuple[int, int]:
        """Allocate a slot (stalling on a full ring = backpressure; a lazy
        reclaim pass runs first) and write one packed frame into it.
        Returns (slot, epoch); ValueError for oversized frames,
        :class:`RingTimeout` past the deadline."""
        ring = self.ring_for(topic)
        total = 4 + len(header) + sum(len(p) for p in parts)
        if total > ring.slot_bytes:
            raise ValueError(f"frame of {total}B exceeds slot size")
        slot, epoch = ring.alloc(
            deadline=deadline,
            reclaim_hook=lambda: self._reclaim_pending(topic))
        ring.write(slot, epoch,
                   [len(header).to_bytes(4, "little"), header, *parts])
        return slot, epoch

    def track(self, topic: str, partition: int, last_offset: int,
              slot: int, epoch: int) -> None:
        """Bind a written slot to the log offset of its frame's last
        record; reclaim releases it once the floor passes that offset."""
        with self._lock:
            self._tracked.setdefault((topic, partition), deque()).append(
                (last_offset, slot, epoch))

    def release(self, topic: str, slot: int, epoch: int) -> None:
        """Untracked release — a producer whose append ultimately failed
        gives the slot straight back."""
        ring = self.ring_for(topic)
        if ring is not None:
            ring.release(slot, epoch)

    # ---- reclaim (consumer progress) ----------------------------------------

    def reclaim_below(self, topic: str, partition: int, floor: int) -> int:
        """Release every slot whose frame ends below ``floor`` (the min
        commit/replay offset across the topic's consumer groups). Returns
        the number of slots released."""
        ring = self.ring_for(topic)
        if ring is None:
            return 0
        released = []
        with self._lock:
            dq = self._tracked.get((topic, partition))
            if not dq:
                return 0
            while dq and dq[0][0] < floor:
                released.append(dq.popleft())
            self._floors[(topic, partition)] = floor
        for _, slot, epoch in released:
            ring.release(slot, epoch)
        return len(released)

    def _reclaim_pending(self, topic: str) -> None:
        """Lazy pass used by a stalling allocator: re-apply the last known
        floors for the topic (a commit may have landed while no producer
        was allocating)."""
        with self._lock:
            floors = dict(self._floors)
        for (t, p), floor in floors.items():
            if t == topic:
                self.reclaim_below(t, p, floor)

    # ---- saturation / lifecycle ---------------------------------------------

    def stall_seconds(self) -> float:
        """Cumulative producer stall on full rings — summed into
        ``BrokerCluster.io_stall_seconds`` next to token-bucket stall so
        the broker saturation probe (and elasticity) sees ring pressure."""
        with self._lock:
            return sum(r.stall_seconds for r in self._rings.values())

    def ring_names(self) -> dict[str, str]:
        with self._lock:
            return {t: r.name for t, r in self._rings.items()}

    def close(self) -> None:
        with self._lock:
            rings = list(self._rings.values())
            self._rings.clear()
            self._tracked.clear()
        for ring in rings:
            ring.destroy()


def expand_slot_value(data: bytes, *, zero_copy: bool = False):
    """Resolve an ``S``-tagged record value to its decoded
    :class:`FrameBatch` (no cache — see ``Consumer`` for the cached path)."""
    name, slot, epoch, row = decode_slot_record(data)
    ring = get_ring(name)
    frame = decode_frame(ring.view(slot, epoch), zero_copy=zero_copy,
                         source=(name, slot, epoch))
    if not zero_copy:
        # the copy already happened; make sure it didn't race a reclaim
        frame.zero_copy = True
        frame.verify()
        frame.zero_copy = False
    return frame, row
