"""MetricsBus — the shared telemetry sink engines, consumers and the broker
publish named samples to, the engines' stat records, and the snapshot
the elastic control plane reads back.

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
* ``broker.stall_frac`` — fraction of wall-clock time producers sat in the
  broker nodes' token buckets (the broker controller's probe)
* ``elastic.devices``/``elastic.lag``/``elastic.decision``/``elastic.target``
  — the controller, per stream; ``elastic.event`` (+1 up, -1 down) and
  ``elastic.actuation_ms`` per scaling action
* ``scheduler.requests``/``scheduler.demand``/``scheduler.granted``/
  ``scheduler.capacity``/``scheduler.free``/``scheduler.preemptions`` — the
  resource arbiter
* ``state.migrated_partitions``/``state.migration_ms``/``state.bytes_moved``
  — the last keyed-state migration, per stream (published by the continuous
  engine's StateMigrator on every rescale; the snapshot reads the ms)
* ``stream.recoveries``/``stream.recovery_ms`` and
  ``pipeline.stage_recoveries``/``pipeline.stage_recovery_ms`` —
  crash-recovery counts and latency (ContinuousStream.recover /
  StageReconciler)

The elastic controller and its policies read these back through one
:class:`MetricsSnapshot` per reconcile pass.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable


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

    def latest_by_label(self, name: str, label: str) -> dict[str, float]:
        """Latest value per distinct value of ``label`` (e.g. per-stage
        demand for the bin-packing policy)."""
        return {k: s.value for k, s in self.samples_by_label(name, label).items()}

    def samples_by_label(self, name: str, label: str) -> dict[str, Sample]:
        """Like :meth:`latest_by_label` but whole samples — for readers
        that need the timestamp too (e.g. migration-cost amortization)."""
        out: dict[str, Sample] = {}
        with self._lock:
            for (n, _), s in self._latest.items():
                if n == name:
                    out[s.label(label, "")] = s
        return out

    def history(self, name: str | None = None, since: float = 0.0) -> list[Sample]:
        with self._lock:
            return [s for s in self._history
                    if (name is None or s.name == name) and s.t >= since]

    def series(self, name: str, since: float = 0.0) -> list[tuple[float, float]]:
        return [(s.t, s.value) for s in self.history(name, since)]

    def rate(self, name: str, window: float = 5.0, **labels: str) -> float:
        """Per-second rate of a counter over its last ``window`` seconds."""
        pts = [s for s in self.history(name) if not labels or
               s.labels == tuple(sorted(labels.items()))]
        if len(pts) < 2:
            return 0.0
        cutoff = pts[-1].t - window
        pts = [s for s in pts if s.t >= cutoff] or pts[-2:]
        dt = pts[-1].t - pts[0].t
        return (pts[-1].value - pts[0].value) / dt if dt > 0 else 0.0

    def clear(self) -> None:
        with self._lock:
            self._history.clear()
            self._latest.clear()


# ---------------------------------------------------------------------------
# per-engine stat records
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


@dataclass
class ContinuousStats:
    records: int = 0
    fired_windows: int = 0
    late_records: int = 0
    per_record_latency: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# the read-side view policies consume
# ---------------------------------------------------------------------------


@dataclass
class MetricsSnapshot:
    """One coherent reconcile-time view assembled from the bus."""

    t: float
    lag: float  # total records behind, summed over streams
    records_per_sec: float
    processing_delay: float
    scheduling_delay: float
    busy_frac: float  # processing_delay / batch_interval (max over streams)
    devices_total: int
    devices_leased: int  # pool-wide, across ALL pilots in the service
    utilization: float  # leased / total
    #: devices serving the controlled pipeline (base + extensions) — what
    #: sizing policies must compare against; devices_leased counts unrelated
    #: pilots' leases too
    pipeline_devices: int = 0
    stage_demands: dict[str, float] = field(default_factory=dict)  # stream -> rec/s
    #: rolling per-batch compute-latency quantiles (max over streams,
    #: ``stream.latency_p50/p99`` gauges) — lets policies react to compute
    #: latency creep before it surfaces as lag
    latency_p50: float = 0.0
    latency_p99: float = 0.0
    #: fraction of wall-clock time producers spent blocked in broker
    #: token buckets (``broker.stall_frac`` gauge) — the broker
    #: controller's saturation signal
    broker_stall_frac: float = 0.0
    #: duration of the last keyed-state migration (``state.migration_ms``
    #: gauge, max over streams) — lets policies weigh rescale benefit
    #: against the disruption it costs
    state_migration_ms: float = 0.0
    #: bus timestamp of the sample behind ``state_migration_ms`` — the
    #: controller's amortization gate keys off it (the gauge is latched:
    #: the engine republishes the *last* migration's cost forever), and
    #: carrying it here keeps the gate on the same stream-filtered view
    #: the policy decided on instead of re-reading the bus
    state_migration_t: float = 0.0

    @classmethod
    def capture(cls, bus: MetricsBus, pool: Any | None = None,
                pipeline_devices: int | None = None,
                stream: str | None = None) -> "MetricsSnapshot":
        """``pool`` is duck-typed (``DevicePool``): total/leased/utilization
        are read live when given, else from ``pool.*`` gauges on the bus.

        ``stream`` narrows the view to one stream label: without it, the
        latency/busy gauges take the max over ALL streams on the bus, which
        is wrong for a controller that manages just one stage of a
        multi-stage pipeline (another stage's saturation would trigger it).
        """

        def _per_stream(name: str) -> dict[str, float]:
            vals = bus.latest_by_label(name, "stream")
            if stream is not None:
                vals = {k: v for k, v in vals.items() if k == stream}
            return vals

        # a controller's lag probe is authoritative (fresh even when the
        # engine is too stalled to publish). Filtered captures look for the
        # probe sample labeled with their stream; unfiltered ones take any.
        if stream is None:
            probe_lag = bus.latest("elastic.lag")
        else:
            probe_lag = bus.latest("elastic.lag", stream=stream)
        if probe_lag is not None:
            lag = probe_lag.value
        else:
            lag = sum(_per_stream("stream.lag").values())
        if pool is not None:
            total = pool.total_devices
            leased = pool.leased_devices
            util = pool.utilization
        else:
            total = int(bus.value("pool.devices_total"))
            leased = int(bus.value("pool.devices_leased"))
            util = bus.value("pool.utilization")
        busy = max(_per_stream("stream.busy_frac").values(), default=0.0)
        stall = max(_per_stream("broker.stall_frac").values(), default=0.0)
        migr_samples = bus.samples_by_label("state.migration_ms", "stream")
        if stream is not None:
            migr_samples = {k: v for k, v in migr_samples.items() if k == stream}
        migr_sample = max(migr_samples.values(), key=lambda s: s.value, default=None)
        migr = 0.0 if migr_sample is None else migr_sample.value
        migr_t = 0.0 if migr_sample is None else migr_sample.t
        p50 = max(_per_stream("stream.latency_p50").values(), default=0.0)
        p99 = max(_per_stream("stream.latency_p99").values(), default=0.0)
        demands = _per_stream("stream.records_per_sec")
        if stream is None:
            proc_delay = bus.value("stream.processing_delay")
            sched_delay = bus.value("stream.scheduling_delay")
        else:
            proc_delay = _per_stream("stream.processing_delay").get(stream, 0.0)
            sched_delay = _per_stream("stream.scheduling_delay").get(stream, 0.0)
        return cls(
            t=time.monotonic(),
            lag=lag,
            records_per_sec=sum(demands.values()),
            processing_delay=proc_delay,
            scheduling_delay=sched_delay,
            busy_frac=busy,
            devices_total=total,
            devices_leased=leased,
            utilization=util,
            pipeline_devices=leased if pipeline_devices is None else pipeline_devices,
            stage_demands=demands,
            latency_p50=p50,
            latency_p99=p99,
            broker_stall_frac=stall,
            state_migration_ms=migr,
            state_migration_t=migr_t,
        )
