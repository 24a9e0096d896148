"""Append-only partition log: offsets, retention, blocking reads, backpressure.

The in-memory equivalent of a Kafka partition. Thread-safe; producers block
(or drop/raise, per policy) when the partition's buffered bytes exceed
``max_buffer_bytes`` — this is the back-pressure mechanism whose system-level
consequences the paper is about.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from repro_torch.broker.records import Record


class BackpressureError(RuntimeError):
    pass


@dataclass
class PartitionStats:
    appended_records: int = 0
    appended_bytes: int = 0
    dropped_records: int = 0
    blocked_seconds: float = 0.0


class PartitionLog:
    """One partition: an append-only record log with absolute offsets."""

    def __init__(
        self,
        topic: str,
        partition: int,
        *,
        max_buffer_bytes: int = 1 << 30,
        retention_bytes: int | None = None,
        backpressure: str = "block",  # "block" | "drop" | "error"
        base_offset: int = 0,
    ):
        self.topic = topic
        self.partition = partition
        self.max_buffer_bytes = max_buffer_bytes
        self.retention_bytes = retention_bytes or max_buffer_bytes
        self.backpressure = backpressure
        self.stats = PartitionStats()
        self._records: list[Record] = []
        #: offset of _records[0]; a non-zero start keeps the offset space
        #: monotonic when a replacement log is created after data loss
        self._base_offset = base_offset
        self._bytes = 0
        self._lock = threading.Lock()
        self._data_ready = threading.Condition(self._lock)
        self._space_ready = threading.Condition(self._lock)
        self._closed = False

    # ---- producer side -----------------------------------------------------

    def _append_one_locked(self, record: Record, deadline: float | None,
                           timeout: float | None) -> int:
        """Backpressure + append for one record; caller holds the lock."""
        size = record.size()
        while self._bytes + size > self.max_buffer_bytes and not self._closed:
            if self.backpressure == "drop":
                self.stats.dropped_records += 1
                return -1
            if self.backpressure == "error":
                raise BackpressureError(
                    f"{self.topic}[{self.partition}] full ({self._bytes}B buffered)"
                )
            t0 = time.monotonic()
            remaining = None if deadline is None else deadline - t0
            if remaining is not None and remaining <= 0:
                raise BackpressureError(
                    f"{self.topic}[{self.partition}] blocked > {timeout}s"
                )
            self._space_ready.wait(timeout=remaining if remaining else 1.0)
            self.stats.blocked_seconds += time.monotonic() - t0
        if self._closed:
            raise RuntimeError("partition closed")
        offset = self._base_offset + len(self._records)
        rec = Record(record.value, record.key, record.timestamp, offset, record.headers)
        self._records.append(rec)
        self._bytes += size
        self.stats.appended_records += 1
        self.stats.appended_bytes += size
        return offset

    def append(self, record: Record, *, timeout: float | None = 30.0) -> int:
        with self._lock:
            deadline = None if timeout is None else time.monotonic() + timeout
            offset = self._append_one_locked(record, deadline, timeout)
            self._trim_locked()
            self._data_ready.notify_all()
            return offset

    def append_many(self, records: list[Record], *, timeout: float | None = 30.0,
                    total_bytes: int | None = None) -> list[int]:
        """Batch append under ONE lock acquisition with ONE ``notify_all``
        — the per-record lock/notify cost is what made a naive
        ``send_batch`` loop pointless. Offsets are contiguous (modulo
        drop-policy ``-1`` holes); backpressure policy applies per record
        against the shared deadline. ``total_bytes`` lets a caller that
        already summed record sizes (the token-bucket pass) skip the
        re-walk."""
        with self._lock:
            total = (sum(r.size() for r in records)
                     if total_bytes is None else total_bytes)
            if self._bytes + total <= self.max_buffer_bytes and not self._closed:
                # fast path: everything fits, so skip the per-record
                # backpressure machinery and bulk-assign offsets. Records
                # fresh off a producer (offset -1) are adopted in place —
                # the frozen-dataclass re-construction per record was the
                # hottest line of the batch produce path; anything already
                # offset-stamped (a replica pass) still gets a copy
                base = self._base_offset + len(self._records)
                store = self._records.append
                for i, r in enumerate(records):
                    if r.offset == -1:
                        r.offset = base + i
                        store(r)
                    else:
                        store(Record(r.value, r.key, r.timestamp,
                                     base + i, r.headers))
                self._bytes += total
                self.stats.appended_records += len(records)
                self.stats.appended_bytes += total
                offsets = list(range(base, base + len(records)))
            else:
                deadline = None if timeout is None else time.monotonic() + timeout
                offsets = [self._append_one_locked(r, deadline, timeout)
                           for r in records]
            self._trim_locked()
            self._data_ready.notify_all()
            return offsets

    def _trim_locked(self) -> None:
        while self._bytes > self.retention_bytes and len(self._records) > 1:
            victim = self._records.pop(0)
            self._bytes -= victim.size()
            self._base_offset += 1
            self._space_ready.notify_all()

    # ---- consumer side -------------------------------------------------------

    def read(self, offset: int, max_records: int = 512, timeout: float = 0.0) -> list[Record]:
        """Records with offsets >= ``offset`` (up to the high watermark)."""
        with self._lock:
            if timeout > 0:
                deadline = time.monotonic() + timeout
                while offset >= self._base_offset + len(self._records) and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._data_ready.wait(timeout=remaining)
            start = max(offset, self._base_offset) - self._base_offset
            if start >= len(self._records):
                return []
            return self._records[start : start + max_records]

    def ack(self, upto_offset: int) -> None:
        """Consumer-group ack: records below may be reclaimed for space."""
        with self._lock:
            cut = min(upto_offset, self._base_offset + len(self._records)) - self._base_offset
            for rec in self._records[:max(cut, 0)]:
                self._bytes -= rec.size()
            if cut > 0:
                self._records = self._records[cut:]
                self._base_offset += cut
                self._space_ready.notify_all()

    # ---- replication (follower side) ----------------------------------------

    def replicate_from(self, leader: "PartitionLog") -> None:
        """Catch this log up to an exact copy of ``leader`` (bootstrap of a
        fresh follower, or re-replication after a node loss). Records are
        immutable, so sharing them with the leader is safe; subsequent
        appends to either log do not alias the other's tail."""
        with leader._lock:
            records = list(leader._records)
            base = leader._base_offset
            nbytes = leader._bytes
        with self._lock:
            self._records = records
            self._base_offset = base
            self._bytes = nbytes
            self._data_ready.notify_all()

    # ---- introspection ----------------------------------------------------------

    @property
    def earliest(self) -> int:
        with self._lock:
            return self._base_offset

    @property
    def high_watermark(self) -> int:
        with self._lock:
            return self._base_offset + len(self._records)

    @property
    def buffered_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._data_ready.notify_all()
            self._space_ready.notify_all()
