"""FaultInjector — executes a FaultSchedule against a live pipeline.

The injector polls the stream's *logical* progress (record count and
watermark) and fires each scheduled fault exactly once when its trigger is
reached. What each fault does:

``kill_broker_node``
    ``cluster.fail_node`` on the chosen node — ``node=<id>``, ``node=
    "leader"`` (the node leading broker partition 0 of the bound topic, so
    a failover is guaranteed), or seeded-random among alive nodes.
    ``blackout=<s>`` holds the affected partitions unavailable, exercising
    producer/consumer retries.
``kill_pilot``
    ``stream.crash()`` (the loop dies where it is) and, when a
    service+pilot are bound,
    ``service.inject_failure(pilot)`` — the heartbeat monitor then notices
    and a :class:`repro_torch.pipeline.runner.StageReconciler` reprovisions +
    ``recover()``s. The stream is crashed *before* the service call so the
    plugin's shrink-path ``rescale`` no-ops on the dead stream.
``slow_consumer``
    sets ``consumer.injected_poll_delay`` (reverted at ``until_records``)
    — processing slows, lag grows, outputs stay identical; pair with
    ``Consumer(max_lag=...)`` to exercise shedding instead.
``drop_heartbeats``
    ``service.monitor.mark_dead(pilot)`` — heartbeats stop while the pilot
    is actually healthy: the false-positive case. The reconciler's
    crash-before-recover fencing makes recovery correct anyway.
``delay_io``
    ``cluster.set_io_delay`` (reverted at ``until_records``) — a degraded
    interconnect.

Determinism: target choices come from ``random.Random(seed)``; triggers
are logical. ``events`` is the audit trail (fault kind, trigger, detail,
the record count at injection) a chaos test asserts against.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.faults.schedule import FaultSchedule, FaultSpec


@dataclass(frozen=True)
class FaultEvent:
    """One injected (or reverted) fault, for the audit log."""

    kind: str
    trigger: str
    records: int
    detail: str


class FaultInjector:
    """Binds a schedule to the moving parts it attacks.

    All bindings are optional — a schedule that only kills broker nodes
    needs only ``cluster``. ``records_fn``/``watermark_fn`` default to
    reading the bound stream's stats.
    """

    def __init__(
        self,
        schedule: FaultSchedule,
        *,
        seed: int = 0,
        cluster: Any = None,
        topic: str | None = None,
        stream: Any = None,
        consumer: Any = None,
        service: Any = None,
        pilot: Any = None,
        records_fn: Callable[[], int] | None = None,
        watermark_fn: Callable[[], float] | None = None,
        actions: dict[str, Callable[["FaultInjector", FaultSpec], str]] | None = None,
        poll_interval: float = 0.002,
    ):
        self.schedule = schedule
        self.rng = random.Random(seed)
        self.cluster = cluster
        self.topic = topic
        self.stream = stream
        self.consumer = consumer if consumer is not None else (
            getattr(stream, "consumer", None))
        self.service = service
        self.pilot = pilot
        self._records_fn = records_fn or (
            (lambda: stream.stats.records) if stream is not None else (lambda: 0))
        self._watermark_fn = watermark_fn or (
            (lambda: stream.watermarks.watermark)
            if stream is not None else (lambda: float("-inf")))
        #: per-kind action overrides (chaos tests hook recovery in here)
        self.actions = dict(actions or {})
        self.poll_interval = poll_interval
        self.events: list[FaultEvent] = []
        self._pending: list[FaultSpec] = list(schedule)
        #: (expiry_record_count, revert_fn, spec) for until_records faults
        self._expiries: list[tuple[int, Callable[[], None], FaultSpec]] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._done = threading.Event()

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> "FaultInjector":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def wait(self, timeout: float = 30.0) -> bool:
        """Block until every scheduled fault fired (and every timed fault
        reverted). False on timeout."""
        return self._done.wait(timeout)

    @property
    def fired(self) -> int:
        return sum(1 for e in self.events if not e.detail.startswith("revert"))

    def _run(self) -> None:
        while not self._stop.is_set():
            records = self._records_fn()
            watermark = self._watermark_fn()
            still = []
            for spec in self._pending:
                if spec.due(records, watermark):
                    self._fire(spec, records)
                else:
                    still.append(spec)
            self._pending = still
            live = []
            for expiry, revert, spec in self._expiries:
                if records >= expiry:
                    revert()
                    self.events.append(FaultEvent(
                        spec.kind, f"records>={expiry}", records, "reverted"))
                else:
                    live.append((expiry, revert, spec))
            self._expiries = live
            if not self._pending and not self._expiries:
                self._done.set()
                return
            time.sleep(self.poll_interval)

    def _fire(self, spec: FaultSpec, records: int) -> None:
        action = self.actions.get(spec.kind) or getattr(self, f"_do_{spec.kind}")
        try:
            detail = action(self, spec) if spec.kind in self.actions \
                else action(spec)
        except Exception as e:  # a broken action must not kill the poller
            detail = f"action failed: {e!r}"
        self.events.append(FaultEvent(spec.kind, spec.trigger, records,
                                      detail or ""))

    # -- default actions ---------------------------------------------------------

    def _pick_node(self, spec: FaultSpec) -> int:
        node = spec.params.get("node")
        if node == "leader":
            topic = self.topic or next(iter(self.cluster._topics))
            return self.cluster.topic(topic).leaders[0]
        if node is not None:
            return int(node)
        return self.rng.choice(self.cluster._alive_nodes())

    def _do_kill_broker_node(self, spec: FaultSpec) -> str:
        node = self._pick_node(spec)
        blackout = float(spec.params.get("blackout", 0.0))
        self.cluster.fail_node(node, blackout=blackout)
        return f"failed node {node} (blackout={blackout})"

    def _do_kill_pilot(self, spec: FaultSpec) -> str:
        if self.stream is not None:
            self.stream.crash()
        if self.service is not None and self.pilot is not None:
            self.service.inject_failure(self.pilot)
            return "crashed stream + injected pilot failure"
        return "crashed stream"

    def _do_slow_consumer(self, spec: FaultSpec) -> str:
        delay = float(spec.params.get("delay", 0.01))
        consumer = self.consumer
        consumer.injected_poll_delay = delay
        until = spec.params.get("until_records")
        if until is not None:
            def revert():
                consumer.injected_poll_delay = 0.0
            self._expiries.append((int(until), revert, spec))
        return f"poll delay {delay}s" + (f" until records>={until}" if until else "")

    def _do_drop_heartbeats(self, spec: FaultSpec) -> str:
        self.service.monitor.mark_dead(self.pilot)
        return "heartbeats stopped (pilot still healthy)"

    def _do_delay_io(self, spec: FaultSpec) -> str:
        delay = float(spec.params.get("delay", 0.005))
        self.cluster.set_io_delay(delay)
        until = spec.params.get("until_records")
        if until is not None:
            cluster = self.cluster
            self._expiries.append(
                (int(until), lambda: cluster.set_io_delay(0.0), spec))
        return f"io delay {delay}s" + (f" until records>={until}" if until else "")
