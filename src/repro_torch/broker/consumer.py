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

Log plane only: a slot-tagged record (the shared-memory transport's
handle) raises ``NotImplementedError``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.broker.cluster import SHM_NOT_PORTED, BrokerCluster
from repro_torch.broker.errors import BrokerUnavailable
from repro_torch.broker.records import decode_array, decode_compressed, decode_msg

#: serde tag of a shared-memory slot handle (not ported yet)
TAG_SLOT = b"S"


@dataclass(slots=True)
class Message:
    partition: int
    offset: int
    timestamp: float
    value: Any


def _deserialize(data: bytes) -> Any:
    """Explicit dispatch on the serde tag byte (records.py): ``N`` = npy,
    ``M`` = msgpack, ``Z`` = zstd-compressed either (the payload is sniffed
    after decompression). ``S`` (a transport slot handle) raises. Unknown
    tags pass through as raw bytes; decode errors propagate instead of
    being masked by a cross-format fallback."""
    tag = data[:1]
    if tag == b"N":
        return decode_array(data)
    if tag == b"M":
        return decode_msg(data)
    if tag == b"Z":
        return decode_compressed(data)
    if tag == TAG_SLOT:
        raise NotImplementedError(SHM_NOT_PORTED)
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
    ):
        self.cluster = cluster
        self.group = group
        self.member_id = member_id
        self.deserialize = deserialize
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
                for r in recs:
                    val = _deserialize(r.value) if deser else r.value
                    self.consumed_bytes += r.size()
                    out.append(Message(p, r.offset, r.timestamp, val))
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

    def close(self) -> None:
        self.group.leave(self.member_id)
