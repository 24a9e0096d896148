"""Broker cluster: topics, replicated partition placement, elastic scaling,
failures.

The unit Pilot-Streaming provisions ("a Kafka cluster on N nodes"). Each
node has a token-bucket I/O budget so broker-side contention — the
1-broker-bottleneck effect in the paper's Figs. 8/9 — is reproducible.
``add_node``/``remove_node`` rebalance partition placement at runtime
(the paper's cluster-extension capability, Listing 4).

Fault tolerance: ``create_topic(replication_factor=r)`` places each
partition's log on ``r`` distinct nodes — one leader, ``r-1`` followers
kept in sync by acks-all appends (an append returns only once every replica
holds the record, so an *acked* record survives any single node loss).
``fail_node`` is a real crash: the dead node's logs are dropped; partitions
with a surviving follower promote it (``failovers`` counts these, published
as ``broker.failovers``), partitions without one lose their retained
records (``lost_records``). An optional ``blackout`` window keeps the
affected partitions unavailable for a moment, the leader-election gap that
exercises producer/consumer retry paths (``BrokerUnavailable``).

An attached :class:`~repro_torch.transport.ShmTransport` is the data plane
of the topics it serves: their records carry slot handles into a shared
memory ring, and consumer progress reclaims the slots.
"""
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field

from repro_torch.broker.errors import BrokerTimeout, BrokerUnavailable
from repro_torch.broker.log import PartitionLog
from repro_torch.broker.records import Record


class TokenBucket:
    """Byte-rate limiter emulating a node's NIC/disk budget."""

    def __init__(self, rate_bytes_per_s: float | None):
        self.rate = rate_bytes_per_s
        self._tokens = float(rate_bytes_per_s or 0)
        self._last = time.monotonic()
        self._lock = threading.Lock()
        #: cumulative seconds callers spent blocked waiting for tokens —
        #: the saturation signal broker elasticity scales on
        self.stall_seconds = 0.0

    def consume(self, n: int, *, deadline: float | None = None) -> None:
        """Take ``n`` tokens, sleeping until the budget allows it. With a
        ``deadline`` (monotonic), a stall past it raises
        :class:`BrokerTimeout` instead of blocking forever."""
        if not self.rate:
            return
        with self._lock:
            while True:
                now = time.monotonic()
                self._tokens = min(self.rate, self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens >= n:
                    self._tokens -= n
                    return
                if deadline is not None and now >= deadline:
                    raise BrokerTimeout(
                        f"token bucket stalled past deadline ({n}B wanted, "
                        f"{self._tokens:.0f} available at {self.rate:.0f} B/s)")
                wait = min((n - self._tokens) / self.rate, 0.1)
                if deadline is not None:
                    wait = min(wait, max(deadline - now, 0.001))
                self.stall_seconds += wait
                time.sleep(wait)


@dataclass
class BrokerNode:
    node_id: int
    io_rate: float | None = None  # bytes/s budget (None = unlimited)
    alive: bool = True
    bucket: TokenBucket = field(init=False)

    def __post_init__(self):
        self.bucket = TokenBucket(self.io_rate)


class Topic:
    """A named set of replicated partitions.

    ``replicas[p]`` maps node id -> that node's :class:`PartitionLog` copy;
    ``leaders[p]`` names the node whose copy serves reads and assigns
    offsets. ``partitions`` resolves to the current leader copies.
    """

    def __init__(self, name: str, n_partitions: int, *,
                 replication_factor: int = 1, make_log=None):
        self.name = name
        self._n = n_partitions
        self.replication_factor = replication_factor
        self.replicas: dict[int, dict[int, PartitionLog]] = {
            p: {} for p in range(n_partitions)
        }
        self.leaders: dict[int, int] = {}
        self._make_log = make_log or (lambda p, base=0: PartitionLog(name, p, base_offset=base))

    @property
    def n_partitions(self) -> int:
        return self._n

    @property
    def partitions(self) -> list[PartitionLog]:
        return [self.replicas[p][self.leaders[p]] for p in range(self._n)]

    def leader_log(self, partition: int) -> PartitionLog:
        return self.replicas[partition][self.leaders[partition]]

    def holders(self, partition: int) -> list[int]:
        """Node ids holding a replica of ``partition`` (leader first)."""
        leader = self.leaders[partition]
        return [leader] + sorted(n for n in self.replicas[partition] if n != leader)


class BrokerCluster:
    """A set of broker nodes hosting replicated topic partitions."""

    def __init__(self, n_nodes: int = 1, *, io_rate_per_node: float | None = None,
                 metrics=None):
        self._lock = threading.RLock()
        self._nodes: dict[int, BrokerNode] = {}
        self._topics: dict[str, Topic] = {}
        self._offsets: dict[tuple[str, str, int], int] = {}  # (group, topic, part) -> committed
        self._next_node = 0
        self.io_rate_per_node = io_rate_per_node
        #: duck-typed MetricsBus: failover/loss gauges published when set
        self.metrics = metrics
        #: leader promotions after node loss (one per partition failed over)
        self.failovers = 0
        #: retained acked records dropped because a partition's only replica
        #: died — stays zero whenever replication_factor >= 2
        self.lost_records = 0
        #: injected extra latency per append/read
        self.io_delay = 0.0
        #: (topic, partition) -> monotonic instant until which the partition
        #: is leaderless (election in progress) — appends/reads raise
        #: BrokerUnavailable, producers/consumers retry through it
        self._blackout: dict[tuple[str, int], float] = {}
        #: per-partition placement epoch: bumped on any leader/holder change
        #: so an append that slept in a token bucket across a failover
        #: retries instead of landing on a stale replica set
        self._epoch: dict[tuple[str, int], int] = {}
        #: consumer groups to nudge (generation bump) after a node loss
        self._groups: list[weakref.ref] = []
        #: stall accumulated by since-removed nodes — keeps
        #: ``io_stall_seconds`` monotonic across scale-downs
        self._retired_stall = 0.0
        #: optional shm data plane (repro_torch.transport.ShmTransport); payload
        #: bytes then bypass the token buckets by design (same-host shared
        #: memory is not NIC traffic) but its allocator stall joins
        #: ``io_stall_seconds`` so saturation stays observable
        self.transport = None
        #: (group, topic, partition) -> replay horizon pinned by a
        #: checkpointing stream: slots must survive down to it, not just to
        #: the commit position, or crash recovery would replay into
        #: reclaimed frames
        self._replay_floors: dict[tuple[str, str, int], int] = {}
        for _ in range(n_nodes):
            self.add_node()

    # ---- cluster membership (elastic) -------------------------------------

    def add_node(self, io_rate: float | None = None) -> int:
        with self._lock:
            nid = self._next_node
            self._next_node += 1
            self._nodes[nid] = BrokerNode(nid, io_rate or self.io_rate_per_node)
            self._rebalance_locked()
            return nid

    def remove_node(self, node_id: int) -> None:
        """Graceful decommission: replicas are copied off before the node
        leaves, so no data is lost regardless of replication factor."""
        with self._lock:
            node = self._nodes.pop(node_id, None)
            if node is not None:
                self._retired_stall += node.bucket.stall_seconds
            self._rebalance_locked()

    def fail_node(self, node_id: int, *, blackout: float = 0.0) -> None:
        """Simulated crash: the node's replica logs are gone. Partitions it
        led promote a surviving follower (no acked-record loss — sync
        replication means followers hold everything ever acked); partitions
        whose *only* replica lived here lose their retained records, counted
        in ``lost_records``. ``blackout`` holds the affected partitions
        unavailable (``BrokerUnavailable``) for that many seconds — the
        leader-election window producer/consumer retries ride out."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            node.alive = False
            self._retired_stall += node.bucket.stall_seconds
            until = time.monotonic() + blackout
            survivors = self._alive_nodes()
            for topic in self._topics.values():
                for p in range(topic.n_partitions):
                    if node_id not in topic.replicas[p]:
                        continue
                    dead_log = topic.replicas[p].pop(node_id)
                    self._epoch[(topic.name, p)] = self._epoch.get((topic.name, p), 0) + 1
                    if topic.leaders[p] != node_id:
                        continue  # follower loss: leader unaffected
                    if blackout > 0:
                        self._blackout[(topic.name, p)] = until
                    if topic.replicas[p]:
                        # promote the lowest surviving follower
                        topic.leaders[p] = min(topic.replicas[p])
                        self.failovers += 1
                        if self.metrics is not None:
                            self.metrics.publish("broker.failovers", self.failovers)
                    elif survivors:
                        # sole replica died: restart the partition empty at
                        # the old high watermark so offsets stay monotonic
                        lost = dead_log.high_watermark - dead_log.earliest
                        self.lost_records += lost
                        if self.metrics is not None:
                            self.metrics.publish("broker.lost_records", self.lost_records)
                        nid = survivors[0]
                        fresh = topic._make_log(p, base=dead_log.high_watermark)
                        topic.replicas[p][nid] = fresh
                        topic.leaders[p] = nid
            self._rebalance_locked()
            # nudge every consumer group: assignments are unchanged (the
            # partition count is), but members re-sync positions against the
            # promoted leaders on their next poll
            for ref in list(self._groups):
                group = ref()
                if group is None:
                    self._groups.remove(ref)
                else:
                    group.on_cluster_change()

    def _alive_nodes(self) -> list[int]:
        return sorted(n for n, node in self._nodes.items() if node.alive)

    def _rebalance_locked(self) -> None:
        """Re-spread leadership and restore each partition's replication
        factor over the alive node set (round-robin, deterministic). New
        holders bootstrap by copying the current leader's log — the
        in-process stand-in for follower catch-up replication."""
        nodes = self._alive_nodes()
        if not nodes:
            return
        for topic in sorted(self._topics):
            t = self._topics[topic]
            rf = min(t.replication_factor, len(nodes))
            for p in range(t.n_partitions):
                want = [nodes[(p + k) % len(nodes)] for k in range(rf)]
                want = list(dict.fromkeys(want))
                have = t.replicas[p]
                leader = t.leaders.get(p)
                src = have.get(leader)
                changed = False
                for nid in want:
                    if nid not in have:
                        log = t._make_log(p)
                        if src is not None:
                            log.replicate_from(src)
                        have[nid] = log
                        changed = True
                for nid in list(have):
                    if nid not in want:
                        del have[nid]
                        changed = True
                if t.leaders.get(p) != want[0]:
                    changed = True
                t.leaders[p] = want[0]
                if changed:
                    self._epoch[(topic, p)] = self._epoch.get((topic, p), 0) + 1

    @property
    def n_nodes(self) -> int:
        with self._lock:
            return len(self._alive_nodes())

    def io_stall_seconds(self) -> float:
        """Total time producers/consumers have spent blocked in this
        cluster's token buckets (cumulative and monotonic — removed nodes'
        stall is retained). The broker demand estimator differentiates
        this into a stall *fraction*. With an shm transport attached, slot
        allocator stall is included — a full ring is saturation too."""
        with self._lock:
            stall = self._retired_stall + sum(
                n.bucket.stall_seconds for n in self._nodes.values()
            )
            transport = self.transport
        if transport is not None:
            stall += transport.stall_seconds()
        return stall

    # ---- shm data plane (repro_torch.transport) -----------------------------------

    def attach_transport(self, transport) -> None:
        """Mount an :class:`~repro_torch.transport.ShmTransport` as this
        cluster's data plane. Topics the transport serves carry slot
        handles instead of payloads (rf==1 only)."""
        with self._lock:
            self.transport = transport

    def set_replay_floor(self, group: str, topic: str,
                         positions: dict[int, int]) -> None:
        """A checkpointing stream pins its replay horizon: ring slots for
        ``topic`` stay live down to these offsets even as commits advance,
        so ``recover()`` can re-read from the checkpoint cut. Advancing
        the floor triggers a reclaim pass."""
        with self._lock:
            for p, off in positions.items():
                self._replay_floors[(group, topic, p)] = off
        for p in positions:
            self._maybe_reclaim(topic, p)

    def _reclaim_floor_locked(self, topic: str, partition: int) -> int | None:
        """min over registered consumer groups of each group's replay
        floor (when pinned) else its committed offset. None = no group is
        consuming this topic yet — nothing may be reclaimed."""
        floor = None
        for ref in self._groups:
            g = ref()
            if g is None or g.topic != topic:
                continue
            key = (g.group, topic, partition)
            pos = self._replay_floors.get(key)
            if pos is None:
                pos = self._offsets.get((g.group, topic, partition))
            if pos is None:
                return None  # registered group with no progress: hold all
            floor = pos if floor is None else min(floor, pos)
        return floor

    def _maybe_reclaim(self, topic: str, partition: int) -> None:
        with self._lock:
            transport = self.transport
            if transport is None or not transport.serves(topic):
                return
            floor = self._reclaim_floor_locked(topic, partition)
        if floor is not None:
            transport.reclaim_below(topic, partition, floor)

    # ---- fault-injection knobs ------------------------------------------------

    def set_io_delay(self, seconds: float) -> None:
        """Add ``seconds`` of latency to every append/read (the
        ``delay_io`` fault — a degraded interconnect/disk)."""
        self.io_delay = max(float(seconds), 0.0)

    def register_group(self, group) -> None:
        """Consumer groups register for post-failover generation bumps
        (held weakly; a closed group just drops out)."""
        with self._lock:
            self._groups.append(weakref.ref(group))

    # ---- topics ------------------------------------------------------------

    def create_topic(
        self,
        name: str,
        n_partitions: int,
        *,
        max_buffer_bytes: int = 1 << 30,
        backpressure: str = "block",
        replication_factor: int = 1,
    ) -> Topic:
        with self._lock:
            if name in self._topics:
                raise ValueError(f"topic {name!r} exists")
            if replication_factor < 1:
                raise ValueError("replication_factor must be >= 1")

            def make_log(p: int, base: int = 0) -> PartitionLog:
                return PartitionLog(name, p, max_buffer_bytes=max_buffer_bytes,
                                    backpressure=backpressure, base_offset=base)

            topic = Topic(name, n_partitions,
                          replication_factor=replication_factor,
                          make_log=make_log)
            self._topics[name] = topic
            self._rebalance_locked()
            return topic

    def topic(self, name: str) -> Topic:
        with self._lock:
            return self._topics[name]

    def delete_topic(self, name: str) -> None:
        with self._lock:
            topic = self._topics.pop(name, None)
            transport = self.transport
            if topic:
                for logs in topic.replicas.values():
                    for log in logs.values():
                        log.close()
        if topic and transport is not None:
            transport.unmount(name)  # unlinks the shm segment

    def close(self) -> None:
        """Tear the cluster down: close every log and unlink every shm
        segment (the pilot plugin's cancel path — a crashed or cancelled
        broker must not leak /dev/shm entries)."""
        for name in list(self._topics):
            self.delete_topic(name)
        with self._lock:
            transport = self.transport
            self.transport = None
        if transport is not None:
            transport.close()

    # ---- data plane (throttled by node budgets) ------------------------------

    def _check_available_locked(self, topic: str, partition: int) -> None:
        until = self._blackout.get((topic, partition))
        if until is not None:
            if time.monotonic() < until:
                raise BrokerUnavailable(
                    f"{topic}[{partition}]: leader election in progress")
            del self._blackout[(topic, partition)]

    def _resolve_locked(self, topic: str, partition: int):
        """(leader bucket | None, leader log, follower logs, epoch) — the
        placement snapshot one append/read operates on."""
        self._check_available_locked(topic, partition)
        t = self._topics[topic]
        leader = t.leaders[partition]
        node = self._nodes.get(leader)
        bucket = node.bucket if node is not None and node.alive else None
        followers = [log for nid, log in t.replicas[partition].items() if nid != leader]
        return bucket, t.replicas[partition][leader], followers, \
            self._epoch.get((topic, partition), 0)

    def append(self, topic: str, partition: int, record: Record,
               *, deadline: float | None = None) -> int:
        """Append with acks-all replication: the returned offset means every
        replica holds the record. Raises :class:`BrokerUnavailable` during a
        failover blackout (or when placement moved mid-append) — transient,
        the producer's retry loop handles it — and :class:`BrokerTimeout`
        when ``deadline`` passes inside the token bucket."""
        if self.io_delay:
            time.sleep(self.io_delay)
        with self._lock:
            bucket, _, _, epoch = self._resolve_locked(topic, partition)
        # the bucket may sleep; never hold the cluster lock across it
        if bucket is not None:
            bucket.consume(record.size(), deadline=deadline)
        with self._lock:
            self._check_available_locked(topic, partition)
            bucket2, leader, followers, epoch2 = self._resolve_locked(topic, partition)
            if epoch2 != epoch:
                raise BrokerUnavailable(
                    f"{topic}[{partition}]: placement changed mid-append")
            remaining = None if deadline is None else max(deadline - time.monotonic(), 0.001)
            offset = leader.append(record, timeout=remaining if deadline is not None else 30.0)
            if offset >= 0:
                for log in followers:  # acks=all: replicate before returning
                    log.append(record, timeout=remaining if deadline is not None else 30.0)
            return offset

    def append_many(self, topic: str, partition: int, records: list[Record],
                    *, deadline: float | None = None) -> list[int]:
        """Batch append with the same acks-all / blackout / epoch-recheck
        contract as :meth:`append`, but one token-bucket consume and one
        log lock acquisition for the whole batch."""
        if not records:
            return []
        if self.io_delay:
            time.sleep(self.io_delay)
        with self._lock:
            bucket, _, _, epoch = self._resolve_locked(topic, partition)
        total = sum(r.size() for r in records)
        if bucket is not None:
            bucket.consume(total, deadline=deadline)
        with self._lock:
            self._check_available_locked(topic, partition)
            _, leader, followers, epoch2 = self._resolve_locked(topic, partition)
            if epoch2 != epoch:
                raise BrokerUnavailable(
                    f"{topic}[{partition}]: placement changed mid-append")
            remaining = None if deadline is None else max(deadline - time.monotonic(), 0.001)
            timeout = remaining if deadline is not None else 30.0
            offsets = leader.append_many(records, timeout=timeout,
                                         total_bytes=total)
            appended = [r for r, o in zip(records, offsets) if o >= 0]
            for log in followers:  # acks=all: replicate before returning
                log.append_many(appended, timeout=timeout)
            return offsets

    def read(self, topic: str, partition: int, offset: int, max_records: int = 512,
             timeout: float = 0.0):
        if self.io_delay:
            time.sleep(self.io_delay)
        with self._lock:
            bucket, leader, _, _ = self._resolve_locked(topic, partition)
        recs = leader.read(offset, max_records, timeout)
        if recs and bucket is not None:
            bucket.consume(sum(r.size() for r in recs))
        return recs

    # ---- consumer-group offsets ------------------------------------------------

    def commit(self, group: str, topic: str, partition: int, offset: int) -> None:
        with self._lock:
            self._offsets[(group, topic, partition)] = offset
            has_transport = self.transport is not None
        if has_transport:
            # consumer progress is what frees ring slots
            self._maybe_reclaim(topic, partition)

    def committed(self, group: str, topic: str, partition: int) -> int:
        with self._lock:
            return self._offsets.get((group, topic, partition), 0)

    def lag(self, group: str, topic: str) -> dict[int, int]:
        t = self.topic(topic)
        return {
            p.partition: p.high_watermark - self.committed(group, topic, p.partition)
            for p in t.partitions
        }
