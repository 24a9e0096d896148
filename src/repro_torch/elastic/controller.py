"""ElasticController — per-consumer reconciler, now also a demand estimator.

Watches the :class:`MetricsBus` and asks a :class:`ScalingPolicy` for a
resource delta. What happens next depends on the mode:

* **direct** (no arbiter — the pre-scheduler behavior, unchanged): the
  controller actuates itself. Growth is
  ``PilotComputeService.submit_pilot(parent=base)`` (paper Listing 4 — an
  extension pilot whose lease the plugin folds in, firing the stream's
  ``on_rescale`` re-sharding hook), shrink is ``Pilot.cancel()`` on the
  most recent extension.
* **arbitrated** (``arbiter=`` + ``request=`` given): the controller only
  *estimates demand* — it folds the policy's delta into a target resource
  count and files it via ``ResourceArbiter.update``. The arbiter decides
  what is actually granted (weighted fair share across every consumer of
  the pool) and actuates through :meth:`scale_to`.

Either way the controller owns only the extensions it created; the base
pilot is never cancelled. ``unit="nodes"`` makes the same reconciler manage
broker nodes (logical host slots) instead of devices — extension pilots on
the broker pilot add/remove ``BrokerCluster`` nodes through the plugin.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.description import PilotComputeDescription
from repro_torch.elastic.events import EventLog, ScalingEvent
from repro_torch.elastic.metrics import MetricsBus, MetricsSnapshot
from repro_torch.elastic.policy import HOLD, ScalingDecision, ScalingPolicy


@dataclass
class PreemptionHooks:
    """Checkpoint-then-kill wiring for whole-pilot preemption.

    When the arbiter drives a checkpointing continuous stage to zero
    devices, revoking the pilot out from under the stream would lose
    everything since its consumer's last commit — and a plain
    ``stream.stop()`` would delete the very spools a later resume needs
    (teardown cleans up). These three callbacks let the controller *park*
    the stage instead:

    * ``checkpoint()`` — force an ``sckpt_*`` spool of the live stream
      (a consistent cut: state partitions + consumer positions + counters);
    * ``kill()`` — fence the stream (detach it from its plugin so the
      pilot cancel below cannot ``stop()`` it, then ``crash()`` it) —
      after this the old incarnation cannot emit;
    * ``resume(pilot)`` — attach the stream to the replacement pilot's
      plugin and ``recover()`` it from the pre-kill spool (exactly-once:
      replayed firings re-fire with their emit suppressed).

    The streams they act on — continuous stages with ``checkpoint_every >
    0`` — wait for the continuous engine and the checkpoint spools (ROADMAP
    A2, A4), so the port's pipeline runner builds no hooks yet and
    ``Pipeline.validate`` refuses ``preemptible=True``; the controller's park and unpark
    take any three callables, as wired by hand.
    """

    checkpoint: Callable[[], None]
    kill: Callable[[], None]
    resume: Callable[[object], None]


@dataclass
class ElasticConfig:
    interval: float = 0.5  # seconds between reconcile passes
    min_devices: int = 1  # never shrink the pipeline below this
    max_devices: int | None = None  # None = whatever the pool can give
    devices_per_step: int = 1  # lease size of one extension pilot
    cooldown: float = 1.0  # seconds between scaling actions
    #: migration-cost gate (None = off): when the last keyed-state
    #: migration took more than this fraction of a reconcile interval, the
    #: controller holds further rescales until the cost has amortized —
    #: i.e. until ``cost / time_since_migration <= migration_cost_frac``.
    #: The deferral decays on its own (time passes), so an expensive
    #: migration delays scaling; it can never wedge it permanently.
    migration_cost_frac: float | None = None


class ElasticController:
    """Reconcile loop: probe -> snapshot -> decide -> grow/shrink.

    Use ``start()/stop()`` for the background thread, or call ``step()``
    directly for deterministic (test) driving.
    """

    def __init__(
        self,
        service,
        pilot,
        bus: MetricsBus,
        policy: ScalingPolicy,
        *,
        config: ElasticConfig | None = None,
        lag_probe: Callable[[], float] | None = None,
        probes: dict[str, Callable[[], float]] | None = None,
        stream: str | None = None,
        arbiter=None,
        request=None,
        unit: str = "devices",
        hooks: PreemptionHooks | None = None,
    ):
        self.service = service
        self.pilot = pilot  # base pilot; extensions hang off it
        self.bus = bus
        self.policy = policy
        self.config = config or ElasticConfig()
        #: "devices" (engine pilots) or "nodes" (broker pilots — the lease's
        #: logical host slots; BrokerPlugin.extend/shrink add/remove nodes)
        self.unit = unit
        #: repro_torch.scheduler.ResourceArbiter — when set, the controller files
        #: demand instead of actuating, and ``request`` is its live handle
        self.arbiter = arbiter
        self.request = request
        #: published to ``elastic.lag`` each pass — authoritative when the
        #: engine is too stalled to publish its own ``stream.lag``
        self.lag_probe = lag_probe
        #: stream label narrowing this controller's snapshot to one stage —
        #: without it a shared bus mixes every stream's latency/busy gauges
        self.stream = stream
        self.probes = dict(probes or {})
        #: checkpoint-then-kill preemption (None = the pre-existing
        #: behavior: scale_to(0) shrinks extensions and keeps the base)
        self.hooks = hooks
        #: True while the whole stage is preempted: no pilot, no devices,
        #: state parked in its last sckpt spool awaiting a regrant
        self.parked = False
        self.events = EventLog()
        self.extensions: list = []  # pilots we created, newest last
        self._last_action_t = -float("inf")
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_error: BaseException | None = None
        # reentrant: _shrink reads the devices property while holding it
        self._lock = threading.RLock()
        if arbiter is not None:
            if request is None:
                raise ValueError("arbiter mode needs a ResourceRequest")
            request.actuator = self.scale_to
            request.current_fn = lambda: self.devices
            request.set_target(max(self.devices, request.min_devices))
            arbiter.submit(request)

    # -- observed state -------------------------------------------------------

    def _lease_size(self, pilot) -> int:
        lease = pilot.lease
        return len(lease.nodes) if self.unit == "nodes" else len(lease.devices)

    @property
    def devices(self) -> int:
        """Resources currently serving the consumer (base + live
        extensions) — devices for engine pilots, nodes for the broker."""
        with self._lock:
            return self._lease_size(self.pilot) + sum(
                self._lease_size(p) for p in self.extensions
            )

    @property
    def ticks(self) -> int:
        return self._ticks

    # -- one reconcile pass ---------------------------------------------------

    def step(self) -> ScalingDecision:
        now = time.monotonic()
        self._ticks += 1
        labels = {} if self.stream is None else {"stream": self.stream}
        if self.lag_probe is not None:
            self.bus.publish("elastic.lag", self.lag_probe(), t=now, **labels)
        for name, fn in self.probes.items():
            self.bus.publish(name, fn(), t=now, **labels)
        snap = MetricsSnapshot.capture(self.bus, self.service.pool,
                                       pipeline_devices=self.devices,
                                       stream=self.stream)
        # gate on cooldown BEFORE consulting the policy: a decision dropped
        # here would consume its hysteresis counters / integral for nothing,
        # adding up_stable*interval of latency after every cooldown collision
        if now - self._last_action_t < self.config.cooldown:
            applied = HOLD
        elif self._migration_deferred(now, snap):
            # the last state migration was expensive relative to the
            # reconcile cadence: let it amortize before paying for another
            self.bus.publish("elastic.rescale_deferred", 1.0, t=now, **labels)
            applied = HOLD
        elif self.arbiter is not None:
            applied = self._submit_demand(self.policy.decide(snap), now)
        else:
            applied = self._apply(self.policy.decide(snap), snap, now)
        self.bus.publish("elastic.devices", self.devices, t=now, **labels)
        self.bus.publish("elastic.decision", applied.delta_devices, t=now, **labels)
        return applied

    def _labels(self) -> dict:
        return {} if self.stream is None else {"stream": self.stream}

    def _migration_deferred(self, now: float, snap: MetricsSnapshot) -> bool:
        """True while the last keyed-state migration is still amortizing
        (``MetricsSnapshot.state_migration_ms`` consumer). The gauge is
        latched — the engine republishes the *last* migration's cost
        forever — so the gate keys off the sample's timestamp
        (``state_migration_t``): defer only until ``cost / (now - t)``
        drops to ``migration_cost_frac``. Reads the snapshot, not the bus:
        the gate must see the same stream-filtered view the policy decided
        on, never a newer (or other stage's) sample published since the
        capture.
        """
        frac = self.config.migration_cost_frac
        if frac is None or frac <= 0:
            return False
        if snap.state_migration_ms <= 0.0:
            return False
        cost_s = snap.state_migration_ms / 1e3
        if cost_s <= frac * self.config.interval:
            return False  # cheap migration: never worth deferring for
        return now < snap.state_migration_t + cost_s / frac

    def _desired(self, decision: ScalingDecision) -> int | None:
        """Fold a policy delta into an absolute resource target (the same
        lease-rounding rules ``_apply`` uses), clamped to the controller's
        own band. ``None`` = hold."""
        if decision.delta_devices == 0:
            return None
        step = max(self.config.devices_per_step, 1)
        n = abs(decision.delta_devices)
        if decision.absolute:
            want = (-(-n // step) if decision.scale_up else n // step) * step
        else:
            want = n * step
        if want <= 0:
            return None
        cur = self.devices
        target = cur + want if decision.scale_up else cur - want
        target = max(target, self.config.min_devices)
        if self.config.max_devices is not None:
            target = min(target, self.config.max_devices)
        return target

    def _submit_demand(self, decision: ScalingDecision, now: float) -> ScalingDecision:
        """Arbiter mode: the policy's verdict becomes a demand revision, not
        an actuation — the arbiter owns the pool and will call
        :meth:`scale_to` with whatever is actually granted."""
        target = self._desired(decision)
        if target is None or target == self.request.target:
            return HOLD
        before = self.devices
        self.arbiter.update(self.request.name, target)
        self._last_action_t = now  # cooldown paces demand revisions too
        self.bus.publish("elastic.target", target, t=now, **self._labels())
        return ScalingDecision(target - before, decision.reason)

    def scale_to(self, n: int) -> int:
        """Idempotent absolute actuator (the arbiter's grant callback):
        grow/shrink extension pilots until ``n`` resources serve the
        consumer. Returns the count actually reached.

        With :class:`PreemptionHooks` wired and ``min_devices == 0``, a
        grant of 0 *parks* the whole stage — checkpoint, fence, cancel
        every pilot including the base — and the next non-zero grant
        resubmits the base pilot and resumes the stream from its pre-kill
        spool (exactly-once). Without hooks, 0 shrinks extensions only and
        the base pilot keeps its floor, as before."""
        t0 = time.perf_counter()
        with self._lock:
            before = self.devices
            if self.parked:
                if n > 0:
                    self._unpark()  # base pilot back; stream resumed
            elif (n <= 0 and self.hooks is not None
                    and self.config.min_devices == 0 and before > 0):
                self._park()
            cur = self.devices
            if not self.parked and n > cur:
                want = n - cur
                if self.unit == "devices":
                    want = min(want, self.service.pool.free_devices)
                if want > 0:
                    self._grow(want)
            elif not self.parked and n < cur:
                self._shrink(cur - n)
            after = self.devices
        if after != before:
            now = time.monotonic()
            action = "scale_up" if after > before else "scale_down"
            labels = self._labels()
            self.events.record(ScalingEvent(now, action, after - before,
                                            before, after, f"granted {n}"))
            self.bus.publish("elastic.event",
                             1.0 if after > before else -1.0, t=now, **labels)
            self.bus.publish("elastic.devices", after, t=now, **labels)
            # grow/shrink is synchronous through plugin.extend/shrink ->
            # stream.rescale, so this includes any keyed-state migration the
            # grant triggered (quiesce + snapshot + restore) — the end-to-end
            # disruption cost of the scaling action
            self.bus.publish("elastic.actuation_ms",
                             (time.perf_counter() - t0) * 1e3, t=now, **labels)
        return after

    def _park(self) -> None:
        """Checkpoint-then-kill: spool the stream's state, fence it, then
        cancel every pilot (extensions and base). Caller holds the lock.
        Order matters — the kill hook detaches the stream from the base
        pilot's plugin *before* the cancels, so ``plugin.cancel`` cannot
        ``stop()`` it (stop deletes the spools the resume needs)."""
        now = time.monotonic()
        before = self.devices
        self.hooks.checkpoint()
        self.hooks.kill()
        exts, self.extensions = list(self.extensions), []
        for p in reversed(exts):
            try:
                p.cancel()
            except Exception:
                self.bus.publish("elastic.errors", 1.0)
                self.service._release(p)
        try:
            self.pilot.cancel()
        except Exception:
            self.bus.publish("elastic.errors", 1.0)
            self.service._release(self.pilot)
        self.parked = True
        self.events.record(ScalingEvent(now, "park", -before, before, 0,
                                        "preempted to zero: checkpoint-then-kill"))
        self.bus.publish("elastic.parked", 1.0, t=now, **self._labels())

    def _unpark(self) -> None:
        """Reverse of :meth:`_park`: resubmit the base pilot (same PCD,
        possibly different devices) and resume the stream from its pre-kill
        spool. Caller holds the lock."""
        now = time.monotonic()
        self.pilot = self.service.submit_pilot(self.pilot.pcd)
        self.parked = False
        self.hooks.resume(self.pilot)
        after = self.devices
        self.events.record(ScalingEvent(now, "unpark", after, 0, after,
                                        "regranted: resumed from checkpoint"))
        self.bus.publish("elastic.parked", 0.0, t=now, **self._labels())

    def _apply(self, decision: ScalingDecision, snap: MetricsSnapshot, now: float) -> ScalingDecision:
        if decision.delta_devices == 0:
            return decision
        before = self.devices
        # relative deltas count lease-sized actions; absolute deltas are
        # exact device counts, rounded up on grow but DOWN on shrink so a
        # target between lease multiples holds rather than flapping
        step = max(self.config.devices_per_step, 1)
        n = abs(decision.delta_devices)
        if decision.absolute:
            want = (-(-n // step) if decision.scale_up else n // step) * step
        else:
            want = n * step
        if want <= 0:
            return HOLD
        t0 = time.perf_counter()
        if decision.scale_up:
            want = min(want, self.service.pool.free_devices)
            if self.config.max_devices is not None:
                want = min(want, self.config.max_devices - before)
            if want <= 0:
                self.events.record(ScalingEvent(now, "rejected", 0, before, before,
                                                f"no headroom ({decision.reason})"))
                return HOLD
            self._grow(want)
            action = "scale_up"
        else:
            removed = self._shrink(want)
            if removed == 0:
                return HOLD
            action = "scale_down"
        self._last_action_t = now
        after = self.devices
        event = ScalingEvent(now, action, after - before, before, after, decision.reason)
        self.events.record(event)
        self.bus.publish("elastic.event", 1.0 if action == "scale_up" else -1.0,
                         t=now, **self._labels())
        # includes any keyed-state migration the rescale triggered (see
        # scale_to) — direct mode pays the same disruption cost
        self.bus.publish("elastic.actuation_ms", (time.perf_counter() - t0) * 1e3,
                         t=now, **self._labels())
        return ScalingDecision(after - before, decision.reason)

    def _grow(self, n: int) -> None:
        if self.unit == "nodes":
            # broker growth: the extension's *host slots* become cluster
            # nodes (BrokerPlugin.extend); no devices are consumed
            pcd = PilotComputeDescription(
                number_of_nodes=n,
                cores_per_node=1,
                framework=self.pilot.pcd.framework,
                parent=self.pilot,
            )
        else:
            pcd = PilotComputeDescription(
                number_of_nodes=1,
                cores_per_node=n,
                framework=self.pilot.pcd.framework,
                parent=self.pilot,
            )
        ext = self.service.submit_pilot(pcd)
        with self._lock:
            self.extensions.append(ext)

    def _shrink(self, n_devices: int) -> int:
        """Cancel newest-first extensions until ~n_devices are returned,
        honoring ``min_devices``. The base pilot is never touched."""
        removed = 0
        while removed < n_devices:
            with self._lock:
                if not self.extensions:
                    break
                candidate = self.extensions[-1]
                size = self._lease_size(candidate)
                if size == 0:  # already drained elsewhere: just drop it
                    self.extensions.pop()
                    continue
                if self.devices - size < self.config.min_devices:
                    break
                self.extensions.pop()
            # once popped, the shrink must be accounted for even if the
            # cancel hits a churn race — lease release is idempotent
            try:
                candidate.cancel()
            except Exception:
                self.bus.publish("elastic.errors", 1.0)
                self.service._release(candidate)
            removed += size
        return removed

    # -- background loop ------------------------------------------------------

    def start(self) -> "ElasticController":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval):
            try:
                self.step()
            except Exception as e:  # pilot churn races are survivable
                self.bus.publish("elastic.errors", 1.0)
                self._last_error = e

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def shutdown(self, *, release_extensions: bool = True) -> None:
        self.stop()
        if self.arbiter is not None and self.request is not None:
            self.arbiter.withdraw(self.request.name)
        if release_extensions:
            with self._lock:
                exts, self.extensions = list(self.extensions), []
            for p in reversed(exts):
                try:
                    p.cancel()
                except Exception:
                    pass
