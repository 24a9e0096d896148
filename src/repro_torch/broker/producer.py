"""Producer: partition routing, serialization, rate control, retry, metrics.

Fault tolerance: ``send`` retries through transient
:class:`BrokerUnavailable` windows (leader election after a node loss) with
jittered exponential backoff, bounded by ``retry_timeout``; ``send_timeout``
additionally bounds the *total* time a single send may block — including a
stalled broker :class:`TokenBucket` — raising a typed
:class:`BrokerTimeout` instead of hanging. Retries are counted in
``retries`` and published as the ``broker.retries`` gauge when a metrics
bus is attached.

``send_batch`` on a topic an attached shared-memory transport serves
writes the batch once into a ring slot as one columnar frame; each record
then carries only the slot's handle.
"""
from __future__ import annotations

import itertools
import random
import threading
import time
import zlib
from typing import Any

import numpy as np

from repro_torch.broker.cluster import BrokerCluster
from repro_torch.broker.errors import BrokerTimeout, BrokerUnavailable
from repro_torch.broker.records import Record, encode_array, encode_msg
from repro_torch.transport.frames import encode_frame
from repro_torch.transport.plane import pack_row, slot_record_prefix
from repro_torch.transport.ring import RingTimeout


class Producer:
    def __init__(
        self,
        cluster: BrokerCluster,
        topic: str,
        *,
        serializer: str = "npy",  # "npy" | "msgpack" | "raw"
        compress: bool = False,
        rate_msgs_per_s: float | None = None,
        send_timeout: float | None = None,
        retry_timeout: float = 10.0,
        metrics: Any | None = None,
        seed: int | None = None,
    ):
        self.cluster = cluster
        self.topic = topic
        self.serializer = serializer
        self.compress = compress
        self.rate = rate_msgs_per_s
        #: overall deadline for one ``send`` (token-bucket stalls included);
        #: None = block as long as it takes
        self.send_timeout = send_timeout
        #: how long to keep retrying through BrokerUnavailable before
        #: giving up with BrokerTimeout
        self.retry_timeout = retry_timeout
        #: duck-typed MetricsBus: broker.retries published when set
        self.metrics = metrics
        self._rng = random.Random(seed)
        self._rr = itertools.count()
        #: start of the next unclaimed send slot on the rate schedule
        self._next_send = 0.0
        self._lock = threading.Lock()
        self.sent_records = 0
        self.sent_bytes = 0
        #: sends that hit a transient failover window and were reattempted
        self.retries = 0
        #: batch records sent inline although a shared-memory ring serves the
        #: topic (rf > 1, or a frame larger than a slot)
        self.copied_out_records = 0

    def _partition_for(self, key: bytes | None) -> int:
        n = self.cluster.topic(self.topic).n_partitions
        if key is None:
            return next(self._rr) % n
        return zlib.crc32(key) % n

    def _serialize(self, value: Any) -> bytes:
        if self.serializer == "raw":
            return value
        if self.serializer == "npy":
            return encode_array(np.asarray(value), compress=self.compress)
        return encode_msg(value, compress=self.compress)

    def _reserve_sends(self, n: int = 1) -> None:
        """Rate control without the convoy: claim the next ``n`` slots on
        the schedule *under* the lock (cheap), sleep until the claimed
        start *outside* it — concurrent sender threads each wait for their
        own slot instead of serializing behind one in-lock sleeper."""
        rate = self.rate
        if not rate:
            return
        with self._lock:
            now = time.monotonic()
            start = max(self._next_send, now)
            self._next_send = start + n / rate
        if start > now:
            time.sleep(start - now)

    def send(self, value: Any, *, key: bytes | None = None, timestamp: float | None = None) -> int:
        self._reserve_sends()
        payload = self._serialize(value)
        rec = Record(payload, key, timestamp if timestamp is not None else time.time())
        part = self._partition_for(key)
        offset = self._append_with_retry(part, rec)
        if offset >= 0:
            self.sent_records += 1
            self.sent_bytes += rec.size()
        return offset

    def send_batch(self, values, *, key: bytes | None = None,
                   timestamps: list[float] | None = None) -> list[int]:
        """Send a batch as one columnar frame. On an shm-mounted rf==1
        topic the payload is written ONCE into a ring slot and each record
        carries only an epoch-tagged slot handle; otherwise (rf>1, no
        transport, or a frame bigger than a slot) the copy-out path
        serializes per record through the log — same offsets-per-message
        semantics either way. The whole batch lands in one
        :meth:`BrokerCluster.append_many` (single lock/notify)."""
        if not len(values):
            return []
        n = len(values)
        self._reserve_sends(n)
        part = self._partition_for(key)
        deadline = None if self.send_timeout is None else time.monotonic() + self.send_timeout
        ts_list = list(timestamps) if timestamps is not None else None
        base_ts = time.time()
        transport = getattr(self.cluster, "transport", None)
        ring = None
        if transport is not None:
            rf = self.cluster.topic(self.topic).replication_factor
            ring = transport.use_ring(self.topic, rf)
        if ring is not None:
            header, parts = encode_frame(values, ts_list, key)
            total = 4 + len(header) + sum(len(p) for p in parts)
            if total <= ring.slot_bytes:
                return self._send_frame(part, transport, ring, header, parts,
                                        total, n, ts_list, base_ts, key, deadline)
        if transport is not None and transport.serves(self.topic):
            self.copied_out_records += n  # rf > 1 or a frame past the slot
        records = [
            Record(self._serialize(v), key,
                   ts_list[row] if ts_list is not None else base_ts)
            for row, v in enumerate(values)
        ]
        offsets = self._append_many_with_retry(part, records, deadline)
        for rec, off in zip(records, offsets):
            if off >= 0:
                self.sent_records += 1
                self.sent_bytes += rec.size()
        return offsets

    def _send_frame(self, part, transport, ring, header, parts, total, n,
                    ts_list, base_ts, key, deadline) -> list[int]:
        try:
            slot, epoch = transport.write_frame(
                self.topic, header, parts, deadline=deadline)
        except RingTimeout as exc:
            raise BrokerTimeout(str(exc)) from None
        prefix = slot_record_prefix(ring.name, slot, epoch)
        records = [
            Record(prefix + pack_row(row), key,
                   ts_list[row] if ts_list is not None else base_ts)
            for row in range(n)
        ]
        try:
            offsets = self._append_many_with_retry(part, records, deadline)
        except Exception:
            transport.release(self.topic, slot, epoch)
            raise
        acked = [off for off in offsets if off >= 0]
        if not acked:
            transport.release(self.topic, slot, epoch)
            return offsets
        transport.track(self.topic, part, max(acked), slot, epoch)
        self.sent_records += len(acked)
        self.sent_bytes += total
        return offsets

    def _retry_wait(self, part: int, retry_until: float, backoff: float) -> float:
        """Count one retry and sleep a jittered ``backoff``; raise
        :class:`BrokerTimeout` once ``retry_until`` has passed. Returns the
        next backoff."""
        self.retries += 1
        if self.metrics is not None:
            self.metrics.publish("broker.retries", self.retries)
        now = time.monotonic()
        if now >= retry_until:
            raise BrokerTimeout(
                f"{self.topic}[{part}]: still unavailable after "
                f"{self.retry_timeout:.1f}s of retries") from None
        sleep = min(backoff * (0.5 + self._rng.random()), retry_until - now)
        if sleep > 0:
            time.sleep(sleep)
        return min(backoff * 2, 0.25)

    def _append_many_with_retry(self, part: int, records: list[Record],
                                deadline: float | None) -> list[int]:
        retry_until = time.monotonic() + self.retry_timeout
        if deadline is not None:
            retry_until = min(retry_until, deadline)
        backoff = 0.005
        while True:
            try:
                return self.cluster.append_many(self.topic, part, records,
                                                deadline=deadline)
            except BrokerUnavailable:
                backoff = self._retry_wait(part, retry_until, backoff)

    def _append_with_retry(self, part: int, rec: Record) -> int:
        """Append, riding out failover blackouts with jittered exponential
        backoff. An offset is returned only once the record is on every
        replica (acks=all), so a retried send never loses an acked record."""
        now = time.monotonic()
        deadline = None if self.send_timeout is None else now + self.send_timeout
        retry_until = now + self.retry_timeout
        if deadline is not None:
            retry_until = min(retry_until, deadline)
        backoff = 0.005
        while True:
            try:
                return self.cluster.append(self.topic, part, rec, deadline=deadline)
            except BrokerUnavailable:
                backoff = self._retry_wait(part, retry_until, backoff)
