"""ResourceArbiter — one scheduler over the shared DevicePool.

The paper's application-level resource management, promoted from per-stage
autoscaling to cluster-level scheduling: every consumer (stage controller,
broker controller, training job) files a :class:`ResourceRequest`, and
each reconcile tick the arbiter

1. reads every request's ``demand`` (the estimator-set target clamped to
   its [min, max] band),
2. computes a **weighted fair-share** allocation of the arbitrable device
   capacity — strict priority tiers, stride-scheduled proportional shares
   within a tier (Stein et al., arXiv:2001.10865; de Assunção et al.,
   arXiv:1709.01363),
3. actuates the diff — shrinks (revocations/preemptions) before grows so
   freed devices are available to the grants that need them; co-located
   groups actuate as atomic **gang units** (all-or-nothing, rolled back on
   partial success),
4. publishes every decision to the MetricsBus as ``scheduler.*`` gauges
   and records grant/revoke/preempt events in an :class:`EventLog`.

``placement()`` additionally packs the granted sizes into host-sized bins,
honoring ``colocate_with`` hints — the spec-level placement story
(co-located stages share one bin, and, at the runner layer, one pilot).
The packing is *online*
(:class:`repro_torch.scheduler.packing.OnlinePacker`): bins are amended
incrementally across ticks instead of re-running FFD from scratch, so an
unchanged group never moves hosts.
"""
from __future__ import annotations

import threading
import time
from typing import Iterable

from repro_torch.elastic.events import EventLog, ScalingEvent
from repro_torch.elastic.metrics import MetricsBus
from repro_torch.scheduler.packing import OnlinePacker
from repro_torch.scheduler.request import DEVICES, HOSTS, ResourceRequest


def colocation_groups(
    requests: Iterable[ResourceRequest],
) -> dict[str, list[ResourceRequest]]:
    """Union ``colocate_with`` chains onto their (non-colocated) root:
    root name -> member requests (singletons included, cycles tolerated).
    The gang-scheduling and placement unit."""
    reqs = {r.name: r for r in requests}
    root: dict[str, str] = {}
    for name in reqs:
        t, seen = name, set()
        while (reqs.get(t) is not None and reqs[t].colocate_with in reqs
               and t not in seen):
            seen.add(t)
            t = reqs[t].colocate_with
        root[name] = t
    groups: dict[str, list[ResourceRequest]] = {}
    for name, r in reqs.items():
        groups.setdefault(root[name], []).append(r)
    return groups


def weighted_fair_share(
    requests: Iterable[ResourceRequest], capacity: int
) -> dict[str, int]:
    """Pure allocation: name -> granted devices.

    Floors first (every request keeps its ``min_devices`` — the base pilot
    already holds them), then the remaining capacity is handed out one
    device at a time, highest priority tier first; within a tier the next
    device goes to the request with the smallest ``allocated / weight``
    ratio (stride scheduling), so sustained contention converges to a
    weight-proportional split.
    """
    reqs = list(requests)
    # floors are unconditional: the base pilots physically hold them already
    alloc = {r.name: r.min_devices for r in reqs}
    remaining = capacity - sum(alloc.values())
    for tier in sorted({r.priority for r in reqs}, reverse=True):
        if remaining <= 0:
            break
        active = [r for r in reqs if r.priority == tier and alloc[r.name] < r.demand]
        while remaining > 0 and active:
            r = min(active, key=lambda q: (alloc[q.name] / q.weight, q.name))
            alloc[r.name] += 1
            remaining -= 1
            if alloc[r.name] >= r.demand:
                active.remove(r)
    return alloc


class PoolTenant:
    """Minimal actuator for consumers that hold raw pool leases rather than
    pilots — arriving tenants in tests, external frameworks,
    batch jobs. ``scale_to`` is the grant callback; leases are acquired
    and released against the service's real DevicePool so the arbiter's
    capacity accounting stays honest."""

    def __init__(self, service):
        self.service = service
        self.leases: list = []

    @property
    def devices(self) -> int:
        return sum(len(l.devices) for l in self.leases)

    def scale_to(self, n: int) -> int:
        from repro_torch.core.plugin import Lease

        cur = self.devices
        if n > cur:
            take = min(n - cur, self.service.pool.free_devices)
            if take > 0:
                self.leases.append(self.service.pool.acquire(take, 0))
        elif n < cur:
            excess = cur - n
            while excess > 0 and self.leases:
                lease = self.leases[-1]
                if len(lease.devices) <= excess:
                    excess -= len(lease.devices)
                    self.leases.pop()
                    self.service.pool.release(lease)
                else:
                    # carve the excess off the newest lease (release is
                    # per slot, so a sub-lease hands back exactly those)
                    give = lease.devices[-excess:]
                    slots = lease.slots[-excess:]
                    del lease.devices[-excess:]
                    del lease.slots[-excess:]
                    self.service.pool.release(Lease(lease.lease_id, give, [], slots))
                    excess = 0
        return self.devices

    def request(self, name: str, **kw) -> ResourceRequest:
        """A ResourceRequest wired to this tenant's actuator."""
        return ResourceRequest(name, actuator=self.scale_to,
                               current_fn=lambda: self.devices, **kw)

    def close(self) -> None:
        for lease in self.leases:
            self.service.pool.release(lease)
        self.leases = []


class ResourceArbiter:
    """The single decision point between demand estimators and the pool.

    One arbiter per :class:`PilotComputeService`; several ``PipelineRun``\\ s
    sharing a service share the arbiter, so their requests are fair-shared
    against each other instead of racing first-come-first-served.

    Drive it with ``start()/stop()`` (background loop, woken early by
    ``update``) or call ``reconcile()`` directly for deterministic tests.
    """

    def __init__(self, service, bus: MetricsBus | None = None, *,
                 interval: float = 0.25):
        self.service = service
        self.bus = bus if bus is not None else MetricsBus()
        self.interval = interval
        self.events = EventLog()
        self._requests: dict[str, ResourceRequest] = {}
        self._lock = threading.Lock()
        # one pass at a time: a direct reconcile() racing the background
        # loop's would otherwise actuate an allocation sized before the
        # other pass moved devices (a parked stage regranted a slot the
        # preemptor holds). The JAX package does not serialize them.
        self._pass_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._refs = 0
        self._ticks = 0
        self.preemptions = 0
        #: incremental placement state (OnlinePacker), created on first
        #: placement() call; sticky across ticks by design
        self._packer: OnlinePacker | None = None

    # -- request book ---------------------------------------------------------

    def submit(self, request: ResourceRequest) -> ResourceRequest:
        """File (or replace, by name) a request. Returns the live handle."""
        with self._lock:
            self._requests[request.name] = request
        self.bus.publish("scheduler.requests", len(self._requests))
        self._wake.set()
        return request

    def withdraw(self, name: str) -> None:
        with self._lock:
            self._requests.pop(name, None)
        self.bus.publish("scheduler.requests", len(self._requests))

    def update(self, name: str, target: int) -> None:
        """Estimator entry point: revise one request's demand and wake the
        reconcile loop so the grant lands within (at most) one interval."""
        with self._lock:
            req = self._requests.get(name)
        if req is None:
            raise KeyError(f"no request named {name!r}")
        req.set_target(target)
        self.bus.publish("scheduler.demand", req.demand, request=name)
        self._wake.set()

    def request(self, name: str) -> ResourceRequest:
        with self._lock:
            return self._requests[name]

    @property
    def requests(self) -> list[ResourceRequest]:
        with self._lock:
            return list(self._requests.values())

    @property
    def ticks(self) -> int:
        return self._ticks

    # -- allocation -----------------------------------------------------------

    def _device_capacity(self, device_reqs: list[ResourceRequest]) -> int:
        """Devices the arbiter may hand out: the pool's free devices plus
        whatever its own participants currently hold. Leases of
        non-participant pilots are off the table."""
        return self.service.pool.free_devices + sum(r.current for r in device_reqs)

    def allocate(self) -> dict[str, int]:
        """The sizing decision alone (no actuation) — name -> devices."""
        with self._lock:
            reqs = list(self._requests.values())
        return self._allocate(reqs)

    def _allocate(self, reqs: list[ResourceRequest]) -> dict[str, int]:
        """Fair share with **gang feasibility**: a ``colocate_with`` group
        is all-or-nothing. If contention leaves any member of a multi-member
        gang below a runnable grant (``max(1, min_devices)``) while a
        sibling would run, the whole gang is withheld to its floors and the
        freed capacity redistributed — no partial co-located group is ever
        granted. Iterates until every surviving gang is whole (bounded by
        the number of gangs)."""
        device_reqs = [r for r in reqs if r.unit == DEVICES]
        capacity = self._device_capacity(device_reqs)
        active = list(device_reqs)
        withheld: dict[str, int] = {}
        while True:
            alloc = weighted_fair_share(active, capacity - sum(withheld.values()))
            infeasible: list[list[ResourceRequest]] = []
            for members in colocation_groups(active).values():
                if len(members) < 2:
                    continue
                runnable = [m for m in members
                            if alloc.get(m.name, 0) >= max(1, m.min_devices)]
                # all runnable = whole gang placed; none runnable = gang
                # atomically at zero (nothing placed) — both are fine.
                if runnable and len(runnable) < len(members):
                    infeasible.append(members)
            if not infeasible:
                break
            for members in infeasible:
                for m in members:
                    withheld[m.name] = m.min_devices
                    active.remove(m)
        alloc.update(withheld)
        # host-unit requests (broker nodes) are logical slots: clamp, don't
        # contend — the DevicePool's host slots are unbounded
        for r in reqs:
            if r.unit == HOSTS:
                alloc[r.name] = r.demand
        return alloc

    # -- reconcile ------------------------------------------------------------

    def reconcile(self) -> dict[str, int]:
        """One scheduling pass: allocate, then actuate the diff.

        Actuation is by **gang unit**: a ``colocate_with`` group's members
        actuate together (shrinks first within the unit), and if any member
        fails — its actuator raises, or reaches less than the allocation —
        every member already actuated in that unit is rolled back to its
        pre-pass size. A co-located group is therefore never left partially
        granted, no matter where mid-flight contention bites. Singleton
        units keep the old per-request semantics (a clamped grant stands).

        Units with net shrinks run before net grows (freed devices fund the
        grants), and actuators are only invoked on a changed allocation, so
        repeated reconciles with unchanged demand are no-ops (grant
        idempotence).

        One snapshot of the request book feeds both sizing and actuation:
        a request submitted mid-pass is simply not scheduled until the
        next tick (never actuated against an allocation it was absent
        from), and one withdrawn mid-pass is skipped at actuation time.
        """
        with self._pass_lock:
            now = time.monotonic()
            self._ticks += 1
            with self._lock:
                reqs = list(self._requests.values())
            alloc = self._allocate(reqs)
            granted: dict[str, int] = {}

            def delta(r: ResourceRequest) -> int:
                return alloc.get(r.name, 0) - r.current

            units = sorted(colocation_groups(reqs).values(),
                           key=lambda unit: sum(delta(r) for r in unit))
            for unit in units:  # most negative net delta (biggest shrink) first
                gang = len(unit) > 1
                done: list[tuple[ResourceRequest, int]] = []  # (req, prior size)
                rollback = False
                for r in sorted(unit, key=delta):
                    with self._lock:
                        if self._requests.get(r.name) is not r:
                            continue  # withdrawn (or replaced) since the snapshot
                    want = alloc.get(r.name, 0)
                    cur = r.current
                    if r.actuator is None or want == cur:
                        r.granted = want if r.actuator is None else cur
                        granted[r.name] = r.granted
                        continue
                    try:
                        reached = r.actuator(want)
                    except Exception:
                        self.bus.publish("scheduler.errors", 1.0, request=r.name)
                        granted[r.name] = cur
                        if gang:
                            rollback = True
                            break
                        continue
                    done.append((r, cur))
                    if gang and reached != want:
                        rollback = True  # partial gang: undo the whole unit
                        break
                    r.granted = reached
                    granted[r.name] = reached
                    action = "grant" if want > cur else (
                        # a shrink below the consumer's own demand was forced by
                        # someone else's priority/weight — that is a preemption
                        "preempt" if r.demand > want else "revoke"
                    )
                    if action == "preempt":
                        self.preemptions += 1
                        self.bus.publish("scheduler.preemptions", self.preemptions)
                    self.events.record(ScalingEvent(
                        now, action, reached - cur, cur, reached,
                        f"alloc {want} (demand {r.demand}, weight {r.weight}, "
                        f"priority {r.priority})",
                    ))
                    self.bus.publish("scheduler.event", float(reached - cur),
                                     request=r.name, action=action)
                if rollback:
                    for r, prior in reversed(done):
                        try:
                            r.actuator(prior)
                        except Exception:
                            self.bus.publish("scheduler.errors", 1.0, request=r.name)
                        r.granted = r.current
                        granted[r.name] = r.granted
                        self.events.record(ScalingEvent(
                            now, "gang_rollback", 0, prior, r.current,
                            f"co-located group partially grantable only — "
                            f"alloc {alloc.get(r.name, 0)} undone",
                        ))
                        self.bus.publish("scheduler.event", 0.0, request=r.name,
                                         action="gang_rollback")
            for name, n in granted.items():
                self.bus.publish("scheduler.granted", n, request=name)
            self.bus.publish("scheduler.capacity", self.service.pool.total_devices)
            self.bus.publish("scheduler.free", self.service.pool.free_devices)
            return granted

    # -- placement ------------------------------------------------------------

    def placement(self, allocation: dict[str, int] | None = None, *,
                  bin_size: int | None = None) -> list[list[str]]:
        """Pack the granted sizes into ``bin_size``-device bins, with
        ``colocate_with`` groups merged so co-located requests always land
        in the same bin. Default bin size: the whole pool (one host).

        Packing is **online** (:class:`OnlinePacker`): the previous call's
        bins are amended — unchanged groups never move, resizes relocate a
        group only when its bin overflows — instead of re-running FFD from
        scratch each tick. Bin indices are therefore sticky across calls,
        and the churn is observable as the ``scheduler.relocations``
        counter (cumulative groups moved)."""
        alloc = self.allocate() if allocation is None else allocation
        with self._lock:
            reqs = [r for r in self._requests.values() if r.unit == DEVICES]
        demands: dict[str, float] = {}
        members: dict[str, list[str]] = {}
        for g, group in colocation_groups(reqs).items():
            demands[g] = float(sum(alloc.get(r.name, 0) for r in group))
            members[g] = sorted(r.name for r in group)
        cap = float(bin_size or max(self.service.pool.total_devices, 1))
        with self._lock:
            if self._packer is None:
                self._packer = OnlinePacker(cap)
            elif self._packer.capacity != cap:
                self._packer.reset(cap)  # repositioning wholesale, not churn
            bins = self._packer.repack(demands)
            relocations = self._packer.relocations
        self.bus.publish("scheduler.relocations", relocations)
        return [[m for g in b for m in members[g]] for b in bins]

    # -- lifecycle ------------------------------------------------------------

    def retain(self) -> "ResourceArbiter":
        """Refcounted start: each PipelineRun (or other consumer) retains the shared
        arbiter; the loop stops when the last one releases it."""
        with self._lock:
            self._refs += 1
            start = self._refs == 1
        if start:
            self.start()
        return self

    def release(self) -> None:
        with self._lock:
            self._refs = max(self._refs - 1, 0)
            stop = self._refs == 0
        if stop:
            self.stop()

    def start(self) -> "ResourceArbiter":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.reconcile()
            except Exception:
                self.bus.publish("scheduler.errors", 1.0)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
