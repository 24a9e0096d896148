"""MetricsBus — the shared telemetry sink engines, consumers and the broker
publish named samples to, plus the micro-batch engine's stat records.

Conventions (all optional — the bus is schemaless):

* ``stream.lag``             gauge, per-stream label — broker records behind
* ``stream.records``         counter, per-stream — total records processed
* ``stream.records_per_sec`` gauge, per-stream — last-batch throughput
* ``stream.processing_delay``/``stream.scheduling_delay`` gauges (seconds)
* ``stream.busy_frac``       gauge — processing_delay / batch_interval
* ``stream.latency_p50``/``stream.latency_p99`` gauges (seconds) — rolling
  per-batch compute-latency quantiles
* ``app.latency_p50``/``app.latency_p99`` gauges, per-app — a MASA
  processor's own completion latency
* ``pool.devices_total``/``pool.devices_leased``/``pool.utilization`` gauges
* ``broker.retries``/``broker.failovers``/``broker.lost_records``/
  ``broker.shed_records`` — broker fault-tolerance counters

The elastic controller and its policies that read these samples back are
not ported yet.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class Sample:
    name: str
    value: float
    t: float
    labels: tuple = ()  # sorted ((key, value), ...) pairs

    def label(self, key: str, default: str | None = None) -> str | None:
        for k, v in self.labels:
            if k == key:
                return v
        return default


class MetricsBus:
    """Thread-safe pub/sub metrics sink with bounded history.

    ``publish`` is cheap (deque append + dict put under one lock) so hot
    paths — the micro-batch loop, consumer polls — can call it per batch.
    """

    def __init__(self, max_history: int = 16384):
        self._lock = threading.Lock()
        self._history: deque[Sample] = deque(maxlen=max_history)
        self._latest: dict[tuple[str, tuple], Sample] = {}
        self._subscribers: list[Callable[[Sample], None]] = []

    # -- write side ----------------------------------------------------------

    def publish(self, name: str, value: float, *, t: float | None = None, **labels: str) -> Sample:
        s = Sample(name, float(value), time.monotonic() if t is None else t,
                   tuple(sorted(labels.items())))
        with self._lock:
            self._history.append(s)
            self._latest[(s.name, s.labels)] = s
            subs = list(self._subscribers)
        for fn in subs:  # outside the lock: subscribers may publish back
            try:
                fn(s)
            except Exception:
                pass  # a broken observer must never take down the data plane
        return s

    def subscribe(self, fn: Callable[[Sample], None]) -> Callable[[], None]:
        with self._lock:
            self._subscribers.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)

        return unsubscribe

    # -- read side -----------------------------------------------------------

    def latest(self, name: str, **labels: str) -> Sample | None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if labels or key in self._latest:
                return self._latest.get(key)
            # no labels given: most recent sample across all label sets
            best = None
            for (n, _), s in self._latest.items():
                if n == name and (best is None or s.t >= best.t):
                    best = s
            return best

    def value(self, name: str, default: float = 0.0, **labels: str) -> float:
        s = self.latest(name, **labels)
        return default if s is None else s.value

    def sum_latest(self, name: str) -> float:
        """Sum the latest sample of every label set of ``name`` (e.g. total
        lag across streams)."""
        with self._lock:
            return sum(s.value for (n, _), s in self._latest.items() if n == name)

    def history(self, name: str | None = None, since: float = 0.0) -> list[Sample]:
        with self._lock:
            return [s for s in self._history
                    if (name is None or s.name == name) and s.t >= since]

    def series(self, name: str, since: float = 0.0) -> list[tuple[float, float]]:
        return [(s.t, s.value) for s in self.history(name, since)]

    def clear(self) -> None:
        with self._lock:
            self._history.clear()
            self._latest.clear()


# ---------------------------------------------------------------------------
# the micro-batch engine's stat records
# ---------------------------------------------------------------------------


@dataclass
class BatchMetrics:
    batch_id: int
    n_records: int
    bytes: int
    processing_delay: float
    scheduling_delay: float
    end_to_end_latency: float  # now - oldest record timestamp


@dataclass
class StreamStats:
    batches: int = 0
    records: int = 0
    bytes: int = 0
    processing_time: float = 0.0
    history: list = field(default_factory=list)

    @property
    def records_per_sec(self) -> float:
        return self.records / self.processing_time if self.processing_time else 0.0
