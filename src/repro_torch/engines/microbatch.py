"""Micro-batch streaming engine (Spark-Streaming analog) as a pilot plugin.

Discretized-stream semantics: the consumer drains a window of records from
the broker, assembles a batch, and applies a processing function carrying
state (model params, centroids, ...). Provides:

* PID backpressure (streaming/rate_control.py) bounding per-batch ingestion;
* exactly-once: state checkpoint then offset commit, atomically ordered —
  recovery restores the checkpoint and rewinds to committed offsets;
* elastic rescale: extension pilots add devices; the processor's
  ``on_rescale`` hook moves live state onto the new device set.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

from repro_torch.broker.cluster import SHM_NOT_PORTED, BrokerCluster
from repro_torch.broker.consumer import Consumer, ConsumerGroup, Message
from repro_torch.core.compute_unit import ComputeUnit
from repro_torch.core.plugin import Lease, ManagerPlugin, register_plugin
from repro_torch.elastic.metrics import BatchMetrics, MetricsBus, StreamStats
from repro_torch.streaming.dispatch import LatencyWindow
from repro_torch.streaming.rate_control import PIDRateController


class MicroBatchStream:
    """One (topic -> processing fn) pipeline."""

    def __init__(
        self,
        cluster: BrokerCluster,
        topic: str,
        *,
        group: str,
        process_fn: Callable[[Any, list[Message]], Any],
        state: Any = None,
        batch_interval: float = 0.5,
        max_batch_records: int = 4096,
        backpressure: bool = True,
        checkpoint_fn: Callable[[Any, dict[int, int]], None] | None = None,
        checkpoint_every: int = 1,
        deserialize: bool = True,
        metrics: MetricsBus | None = None,
        sync_fn: Callable[[], None] | None = None,
        on_rescale: Callable[[Any], Any] | None = None,
        metrics_label: str | None = None,
        transport: str | None = None,
    ):
        if transport == "shm":
            raise NotImplementedError(SHM_NOT_PORTED)
        self.cluster = cluster
        self.topic = topic
        self.group = ConsumerGroup(cluster, group, topic)
        self.consumer = Consumer(cluster, self.group, member_id=f"{group}-engine",
                                 deserialize=deserialize)
        self.process_fn = process_fn
        self.state = state
        self.batch_interval = batch_interval
        self.max_batch_records = max_batch_records
        self.controller = PIDRateController(batch_interval) if backpressure else None
        self.checkpoint_fn = checkpoint_fn
        self.checkpoint_every = checkpoint_every
        # double-buffered processors dispatch work asynchronously; sync_fn is
        # the barrier that lands in-flight batches before state escapes the
        # loop (checkpoint, rescale, stop). Auto-wired from a bound
        # processor's ``sync`` method when not given explicitly.
        owner = getattr(process_fn, "__self__", None)
        if sync_fn is None and owner is not None:
            sync_fn = getattr(owner, "sync", None)
        self.sync_fn = sync_fn
        self.stats = StreamStats()
        self.latency = LatencyWindow()
        self._processor = owner
        self.metrics = metrics
        #: bus label for this stream's gauges. Defaults to the topic; two
        #: stages consuming one topic need distinct labels or they
        #: overwrite each other's gauges
        self.metrics_label = metrics_label or topic
        # the resharding hook may be given at construction or assigned to
        # the attribute afterwards (both supported)
        self.on_rescale: Callable[[Any], Any] | None = on_rescale
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._batch_id = 0
        self._error: BaseException | None = None
        self._batch_done = threading.Condition()
        self._last_publish = 0.0
        # serializes state swaps between the batch loop and rescale(): an
        # autoscaler-triggered reshard must not clobber an in-flight batch
        self._state_lock = threading.Lock()

    # ---- loop -------------------------------------------------------------

    def _run_one_batch(self) -> int:
        limit = self.max_batch_records
        if self.controller is not None and self.stats.batches > 0:
            limit = min(limit, self.controller.max_records_per_batch)
        # discretized-stream semantics: the window accumulates for the full
        # batch interval before processing fires (records wait ~window/2 on
        # average — the latency/throughput trade-off of paper Fig. 7)
        window_end = time.monotonic() + self.batch_interval
        msgs: list[Message] = []
        while len(msgs) < limit:
            remaining = window_end - time.monotonic()
            if remaining <= 0:
                break
            got = self.consumer.poll(max_records=limit - len(msgs), timeout=remaining)
            msgs.extend(got)
        if not msgs:
            return 0
        scheduling_delay = max(time.monotonic() - window_end, 0.0)
        t0 = time.monotonic()
        with self._state_lock:
            self.state = self.process_fn(self.state, msgs)
        dt = time.monotonic() - t0

        self._batch_id += 1
        if self.checkpoint_fn and self._batch_id % self.checkpoint_every == 0:
            if self.sync_fn is not None:  # land in-flight work before snapshotting
                self.sync_fn()
            self.checkpoint_fn(self.state, self.consumer.positions())
        self.consumer.commit()  # after checkpoint -> exactly-once on replay

        if self.controller is not None:
            self.controller.update(len(msgs), dt, scheduling_delay)
        now = time.time()
        self.stats.batches += 1
        self.stats.records += len(msgs)
        self.stats.processing_time += dt
        self.latency.record(dt)
        self.stats.history.append(
            BatchMetrics(
                self._batch_id, len(msgs), 0, dt, scheduling_delay,
                now - min(m.timestamp for m in msgs),
            )
        )
        if self.metrics is not None:
            self._publish_batch(len(msgs), dt, scheduling_delay)
        with self._batch_done:
            self._batch_done.notify_all()
        return len(msgs)

    def _compute_latency(self) -> LatencyWindow:
        """The latency window behind the bus gauges. An async (double-
        buffered) processor's process_fn returns before the device finishes,
        making the engine-side dt mere dispatch time — prefer the
        processor's own completion-latency window when it keeps one."""
        lat = getattr(getattr(self._processor, "stats", None), "latency", None)
        if isinstance(lat, LatencyWindow) and len(lat):
            return lat
        return self.latency

    def _publish_idle(self) -> None:
        """Zero out throughput gauges while starved — otherwise the last
        busy batch's records/sec stays latched on the bus and demand-driven
        policies never see the traffic stop."""
        now = time.monotonic()
        if now - self._last_publish < self.batch_interval:
            return
        self._last_publish = now
        labels = {"stream": self.metrics_label}
        self.metrics.publish("stream.records_per_sec", 0.0, **labels)
        self.metrics.publish("stream.busy_frac", 0.0, **labels)
        self.metrics.publish("stream.lag", sum(self.lag().values()), **labels)

    def _publish_batch(self, n: int, dt: float, scheduling_delay: float) -> None:
        bus, labels = self.metrics, {"stream": self.metrics_label}
        self._last_publish = time.monotonic()
        bus.publish("stream.records", self.stats.records, **labels)
        bus.publish("stream.records_per_sec", n / dt if dt > 0 else 0.0, **labels)
        bus.publish("stream.processing_delay", dt, **labels)
        bus.publish("stream.scheduling_delay", scheduling_delay, **labels)
        bus.publish("stream.busy_frac", dt / self.batch_interval, **labels)
        # rolling compute-latency quantiles: scaling policies can react to
        # batch latency creep before it shows up as lag
        lat = self._compute_latency()
        bus.publish("stream.latency_p50", lat.p50, **labels)
        bus.publish("stream.latency_p99", lat.p99, **labels)
        # committed offsets just advanced, so this is post-batch backlog
        bus.publish("stream.lag", sum(self.lag().values()), **labels)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                n = self._run_one_batch()
            except BaseException as e:  # surfaced on await/stop
                self._error = e
                break
            if n == 0:
                if self.metrics is not None:
                    self._publish_idle()
                time.sleep(0.01)

    # ---- control ------------------------------------------------------------

    def start(self) -> "MicroBatchStream":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def await_batches(self, n: int, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        with self._batch_done:
            while self.stats.batches < n:
                if self._error:
                    raise self._error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"only {self.stats.batches}/{n} batches after {timeout}s")
                self._batch_done.wait(min(remaining, 0.25))

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self.sync_fn is not None:  # land in-flight batches: final state/stats
            self.sync_fn()
        if self._error:
            raise self._error

    def lag(self) -> dict[int, int]:
        return self.cluster.lag(self.group.group, self.topic)

    def rescale(self, devices: list) -> None:
        """Move live state onto a changed device set. Blocks until any
        in-flight batch commits its state, so the move never races it: the
        state lock serializes against the batch loop, and sync_fn drains
        the processor's async double-buffer before buffers move devices."""
        if self.on_rescale is None:
            return
        with self._state_lock:
            if self.sync_fn is not None:
                self.sync_fn()
            self.state = self.on_rescale(devices)

    # ---- failure recovery -----------------------------------------------------

    def recover(self, state: Any, offsets: dict[int, int] | None = None) -> None:
        """Restore from a checkpoint: state + rewind to committed offsets."""
        self.state = state
        if offsets:
            for p, off in offsets.items():
                self.consumer.seek(p, off)
        else:
            self.consumer.rewind_to_committed()


@register_plugin("microbatch")
@register_plugin("spark")  # paper naming convenience
class MicroBatchPlugin(ManagerPlugin):
    USES_DEVICES = True

    def __init__(self, pcd):
        super().__init__(pcd)
        self.devices: list = []
        self.streams: list[MicroBatchStream] = []
        self._ready = threading.Event()

    def submit_job(self, lease: Lease) -> None:
        self.devices = list(lease.devices)
        self._ready.set()

    def wait(self) -> None:
        self._ready.wait()

    def extend(self, lease: Lease) -> None:
        self.devices.extend(lease.devices)
        self._rescale()

    def shrink(self, lease: Lease) -> None:
        for d in lease.devices:
            if d in self.devices:
                self.devices.remove(d)
        self._rescale()

    def _rescale(self) -> None:
        for s in self.streams:
            s.rescale(self.devices)

    def get_context(self, configuration: dict | None = None) -> "MicroBatchPlugin":
        return self

    def run_cu(self, cu: ComputeUnit) -> ComputeUnit:
        threading.Thread(target=cu.run, daemon=True).start()
        return cu

    def cancel(self) -> None:
        for s in self.streams:
            try:
                s.stop()
            except Exception:
                pass

    # ---- user API (the StreamingContext analog) ------------------------------

    def stream(self, cluster: BrokerCluster, topic: str, **kw) -> MicroBatchStream:
        s = MicroBatchStream(cluster, topic, **kw)
        self.streams.append(s)
        return s
