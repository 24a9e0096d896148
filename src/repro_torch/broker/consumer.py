"""Consumer groups: partition assignment, rebalance, offset commits, lag.

Matches the Kafka semantics that the streaming engines rely on:
* group members share a topic's partitions (range assignment; deterministic);
* membership changes (join/leave/failure) trigger rebalance;
* offsets are explicit — commit-after-process gives at-least-once, and
  committing atomically with a state checkpoint gives exactly-once
  (engines/microbatch.py).

Fault tolerance: a group registers with its cluster so a broker-node loss
bumps the generation (members re-sync against promoted leaders on their
next poll). ``poll`` treats :class:`BrokerUnavailable` from a failover
blackout as "no data yet" — counted in ``retries``, never raised into an
engine loop. An optional ``max_lag`` turns unbounded lag into graceful
degradation: records beyond the bound are shed (skipped and counted in
``shed_records`` / the ``broker.shed_records`` gauge) so a slow consumer
falls behind by a bounded amount instead of indefinitely.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.broker.cluster import BrokerCluster
from repro_torch.broker.errors import BrokerUnavailable
from repro_torch.broker.records import decode_array, decode_compressed, decode_msg
from repro_torch.transport.frames import FrameBatch, decode_frame
from repro_torch.transport.plane import TAG_SLOT, FrameCache, decode_slot_record
from repro_torch.transport.ring import SlotReclaimedError, get_ring


@dataclass(slots=True)
class Message:
    partition: int
    offset: int
    timestamp: float
    value: Any


@dataclass
class PolledBatch:
    """One frame's worth of messages from :meth:`Consumer.poll_batch` —
    values decoded once per frame (views into the ring when zero-copy),
    offsets/timestamps per element so commits stay record-granular."""

    partition: int
    offsets: list[int]
    timestamps: list[float]
    values: list
    #: the backing FrameBatch when this came off a ring slot (call
    #: ``frame.verify()`` after consuming zero-copy values); None for
    #: plain log records
    frame: FrameBatch | None = None

    def __len__(self) -> int:
        return len(self.values)


def _deserialize(data: bytes) -> Any:
    """Explicit dispatch on the serde tag byte (records.py): ``N`` = npy,
    ``M`` = msgpack, ``Z`` = zstd-compressed either (the payload is sniffed
    after decompression). ``S`` (a transport slot handle) is resolved by
    the Consumer, which holds the frame cache — here it passes through.
    Unknown tags pass through as raw bytes; decode errors propagate
    instead of being masked by a cross-format fallback."""
    tag = data[:1]
    if tag == b"N":
        return decode_array(data)
    if tag == b"M":
        return decode_msg(data)
    if tag == b"Z":
        return decode_compressed(data)
    return data


class ConsumerGroup:
    """Coordinator for one (group, topic)."""

    def __init__(self, cluster: BrokerCluster, group: str, topic: str):
        self.cluster = cluster
        self.group = group
        self.topic = topic
        self._members: list[str] = []
        self._lock = threading.RLock()
        self._generation = 0
        register = getattr(cluster, "register_group", None)
        if register is not None:
            register(self)

    def join(self, member_id: str) -> None:
        with self._lock:
            if member_id not in self._members:
                self._members.append(member_id)
                self._members.sort()
                self._generation += 1

    def leave(self, member_id: str) -> None:
        with self._lock:
            if member_id in self._members:
                self._members.remove(member_id)
                self._generation += 1

    def on_cluster_change(self) -> None:
        """Cluster callback after a node loss/failover: bump the generation
        so every member refreshes its assignment (and clamps positions
        against the promoted leaders) on its next poll."""
        with self._lock:
            self._generation += 1

    def assignment(self, member_id: str) -> list[int]:
        """Range assignment of partitions for this member."""
        with self._lock:
            if member_id not in self._members:
                return []
            n_parts = self.cluster.topic(self.topic).n_partitions
            idx = self._members.index(member_id)
            n = len(self._members)
            per, extra = divmod(n_parts, n)
            start = idx * per + min(idx, extra)
            count = per + (1 if idx < extra else 0)
            return list(range(start, start + count))

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation


class Consumer:
    """One group member. ``poll`` round-robins its assigned partitions."""

    def __init__(
        self,
        cluster: BrokerCluster,
        group: ConsumerGroup,
        member_id: str,
        *,
        deserialize: bool = True,
        from_committed: bool = True,
        max_lag: int | None = None,
        metrics: Any | None = None,
        zero_copy: bool = False,
    ):
        self.cluster = cluster
        self.group = group
        self.member_id = member_id
        self.deserialize = deserialize
        #: shm topics only: hand out frombuffer views into the ring instead
        #: of copying frames out. Safe when values are consumed before the
        #: next commit advances the reclaim floor (micro-batch, bulk
        #: loaders); buffering consumers keep the default copy-out.
        self.zero_copy = zero_copy
        self._frames = FrameCache()
        #: lag bound per partition: poll sheds (skips) records older than
        #: ``high_watermark - max_lag`` instead of falling behind unboundedly.
        #: None = consume everything.
        self.max_lag = max_lag
        #: duck-typed MetricsBus: consumption counters are published per
        #: non-empty poll when set
        self.metrics = metrics
        group.join(member_id)
        self._positions: dict[int, int] = {}
        self._generation = -1
        self._from_committed = from_committed
        self.consumed_records = 0
        self.consumed_bytes = 0
        #: polls that hit a failover blackout and treated it as empty
        self.retries = 0
        #: records skipped by the max_lag degraded mode
        self.shed_records = 0
        #: extra sleep before every poll — the ``slow_consumer`` fault knob;
        #: processing slows down, outputs stay identical
        self.injected_poll_delay = 0.0

    def _refresh_assignment(self) -> None:
        if self._generation == self.group.generation:
            return
        self._generation = self.group.generation
        parts = self.group.assignment(self.member_id)
        positions = {}
        for p in parts:
            if p in self._positions:
                positions[p] = self._positions[p]
            elif self._from_committed:
                positions[p] = self.cluster.committed(self.group.group, self.group.topic, p)
            else:
                positions[p] = self.cluster.topic(self.group.topic).partitions[p].high_watermark
        self._positions = positions

    @property
    def assignment(self) -> list[int]:
        self._refresh_assignment()
        return sorted(self._positions)

    def seek(self, partition: int, offset: int) -> None:
        self._positions[partition] = offset

    def _shed_locked(self, p: int, pos: int) -> int:
        """Degraded mode: jump the position forward when lag exceeds
        ``max_lag``, counting the skipped records as shed."""
        hw = self.cluster.topic(self.group.topic).partitions[p].high_watermark
        floor = hw - self.max_lag
        if pos < floor:
            self.shed_records += floor - pos
            if self.metrics is not None:
                self.metrics.publish("broker.shed_records", self.shed_records,
                                     member=self.member_id)
            self._positions[p] = floor
            return floor
        return pos

    def poll(self, max_records: int = 512, timeout: float = 0.0) -> list[Message]:
        if self.injected_poll_delay > 0:
            time.sleep(self.injected_poll_delay)
        self._refresh_assignment()
        out: list[Message] = []
        deadline = time.monotonic() + timeout
        while not out:
            for p, pos in list(self._positions.items()):
                budget = max_records - len(out)
                if budget <= 0:
                    break
                if self.max_lag is not None:
                    pos = self._shed_locked(p, pos)
                try:
                    recs = self.cluster.read(self.group.topic, p, pos, budget)
                except BrokerUnavailable:
                    # leader election in flight — same as "nothing yet";
                    # the next poll retries against the promoted leader
                    self.retries += 1
                    if self.metrics is not None:
                        self.metrics.publish("broker.retries", self.retries,
                                             member=self.member_id)
                    continue
                deser = self.deserialize
                frame_value = self._frame_value
                append = out.append
                consumed = 0
                for r in recs:
                    v = r.value
                    if deser and v[:1] == TAG_SLOT:
                        val = frame_value(v)
                        nb = getattr(val, "nbytes", None)
                        consumed += int(nb) if nb is not None else r.size()
                    else:
                        val = _deserialize(v) if deser else v
                        consumed += r.size()
                    append(Message(p, r.offset, r.timestamp, val))
                self.consumed_bytes += consumed
                if recs:
                    self._positions[p] = recs[-1].offset + 1
            if out or time.monotonic() >= deadline:
                break
            time.sleep(0.002)
        self.consumed_records += len(out)
        if out and self.metrics is not None:
            self.metrics.publish("consumer.records", self.consumed_records,
                                 member=self.member_id)
            self.metrics.publish("consumer.bytes", self.consumed_bytes,
                                 member=self.member_id)
        return out

    # ---- shm frames (repro_torch.transport) ---------------------------------------

    def _decoded_frame(self, name: str, slot: int, epoch: int) -> FrameBatch:
        """Decode a slot's frame once per (slot, epoch) incarnation; every
        record of the frame resolves against the cached decode."""
        key = (name, slot, epoch, self.zero_copy)
        frame = self._frames.get(key)
        if frame is None:
            ring = get_ring(name)
            frame = decode_frame(ring.view(slot, epoch), zero_copy=self.zero_copy,
                                 source=(name, slot, epoch))
            if not self.zero_copy and not ring.is_valid(slot, epoch):
                # the copy-out raced a reclaim: the copied bytes may be torn
                raise SlotReclaimedError(
                    f"{name} slot {slot} reclaimed during copy-out")
            self._frames.put(key, frame)
        return frame

    def _frame_value(self, data: bytes):
        # the cache key is the record's raw prefix (ring name + slot +
        # epoch, everything but the trailing row) — the 15 siblings of a
        # frame's first record hit the cache without parsing anything
        key = (data[:-4], self.zero_copy)
        frame = self._frames.get(key)
        if frame is None:
            name, slot, epoch, _ = decode_slot_record(data)
            frame = self._decoded_frame(name, slot, epoch)
            self._frames.put(key, frame)
        return frame.values[int.from_bytes(data[-4:], "little")]

    def poll_batch(self, max_records: int = 512, timeout: float = 0.0,
                   *, zero_copy: bool | None = None) -> list[PolledBatch]:
        """Frame-granular poll: runs of records backed by the same ring
        slot come back as ONE :class:`PolledBatch` (decoded once, values
        as views when zero-copy), plain records as singleton batches.
        Positions advance exactly as :meth:`poll` — ``commit()`` after
        processing keeps the at-least-once contract unchanged."""
        if zero_copy is None:
            zero_copy = self.zero_copy
        if self.injected_poll_delay > 0:
            time.sleep(self.injected_poll_delay)
        self._refresh_assignment()
        out: list[PolledBatch] = []
        deadline = time.monotonic() + timeout
        while not out:
            for p, pos in list(self._positions.items()):
                if self.max_lag is not None:
                    pos = self._shed_locked(p, pos)
                try:
                    recs = self.cluster.read(self.group.topic, p, pos, max_records)
                except BrokerUnavailable:
                    self.retries += 1
                    continue
                i = 0
                while i < len(recs):
                    r = recs[i]
                    if self.deserialize and r.value[:1] == TAG_SLOT:
                        name, slot, epoch, _ = decode_slot_record(r.value)
                        rows, offsets, stamps = [], [], []
                        while i < len(recs) and recs[i].value[:1] == TAG_SLOT:
                            n2, s2, e2, row2 = decode_slot_record(recs[i].value)
                            if (n2, s2, e2) != (name, slot, epoch):
                                break
                            rows.append(row2)
                            offsets.append(recs[i].offset)
                            stamps.append(recs[i].timestamp)
                            i += 1
                        saved, self.zero_copy = self.zero_copy, zero_copy
                        try:
                            frame = self._decoded_frame(name, slot, epoch)
                        finally:
                            self.zero_copy = saved
                        values = [frame.values[row] for row in rows]
                        out.append(PolledBatch(p, offsets, stamps, values, frame))
                        self.consumed_bytes += sum(
                            int(getattr(v, "nbytes", 0)) for v in values)
                    else:
                        val = _deserialize(r.value) if self.deserialize else r.value
                        out.append(PolledBatch(p, [r.offset], [r.timestamp], [val]))
                        self.consumed_bytes += r.size()
                        i += 1
                if recs:
                    self._positions[p] = recs[-1].offset + 1
            if out or time.monotonic() >= deadline:
                break
            time.sleep(0.002)
        n = sum(len(b) for b in out)
        self.consumed_records += n
        if out and self.metrics is not None:
            self.metrics.publish("consumer.records", self.consumed_records,
                                 member=self.member_id)
        return out

    def positions(self) -> dict[int, int]:
        return dict(self._positions)

    def commit(self, offsets: dict[int, int] | None = None) -> None:
        offsets = offsets if offsets is not None else self._positions
        for p, off in offsets.items():
            self.cluster.commit(self.group.group, self.group.topic, p, off)

    def rewind_to_committed(self) -> None:
        """Failure recovery: replay from last commit (exactly-once resume)."""
        for p in list(self._positions):
            self._positions[p] = self.cluster.committed(self.group.group, self.group.topic, p)

    def release_frames(self) -> None:
        """Drop the decoded-frame cache: zero-copy frames pin ring buffers,
        and a pinned buffer blocks clean segment unlink at shutdown.
        Engines call this on stop; it does not leave the group."""
        self._frames.clear()

    def close(self) -> None:
        self.release_frames()
        self.group.leave(self.member_id)
