"""PilotComputeService: device pool, leases, pilot lifecycle, failure injection.

A *pilot* is a lease over a slice of the device pool plus a framework plugin
provisioned on it. ``submit_pilot`` is the paper's Listing 2; ``parent=`` in
the description is the extension mechanism of Listing 4.

The pool's devices are ``torch.device`` objects: every CUDA card of the
host by default. Without CUDA the pool refuses to start unless the caller
names its devices (``devices=[torch.device("cpu")]``) — a run never lands
on the CPU by accident.
"""
from __future__ import annotations

import collections
import enum
import itertools
import threading
import time
from typing import Any

import torch

from repro_torch.core.compute_unit import ComputeUnit
from repro_torch.core.description import PilotComputeDescription
from repro_torch.core.failure import HeartbeatMonitor
from repro_torch.core.plugin import Lease, ManagerPlugin, plugin_class


class PilotState(str, enum.Enum):
    NEW = "New"
    PROVISIONING = "Provisioning"
    RUNNING = "Running"
    EXTENDED = "Extended"
    STOPPED = "Stopped"
    FAILED = "Failed"


def cuda_devices() -> list[torch.device]:
    """Every CUDA card of this host; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises when this
    host has no CUDA, so nothing carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: pass device='cpu' to run on the CPU")
    return dev


class DevicePool:
    """Tracks free/leased devices and logical host slots.

    Host slots (for the broker) are unbounded-logical; devices are the
    host's CUDA cards (or an explicit list for tests and dry runs).
    ``torch.device`` objects compare by value, so a pool may hold the same
    device more than once (``[cpu, cpu]``); leases are counted per entry.
    """

    def __init__(self, devices: list | None = None, n_host_slots: int = 1 << 16):
        self._devices = list(devices if devices is not None else cuda_devices())
        self._free = list(self._devices)
        #: device -> entries of it currently leased; guards double-release
        self._leased: collections.Counter = collections.Counter()
        self._host_slots = iter(itertools.count())
        self._lease_ids = iter(itertools.count(1))
        self._lock = threading.Lock()

    @property
    def total_devices(self) -> int:
        return len(self._devices)

    @property
    def free_devices(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def leased_devices(self) -> int:
        with self._lock:
            return sum(self._leased.values())

    @property
    def utilization(self) -> float:
        """Fraction of the pool currently leased (the autoscaler's headroom
        signal)."""
        with self._lock:
            return sum(self._leased.values()) / len(self._devices) if self._devices else 0.0

    def acquire(self, n_devices: int, n_nodes: int) -> Lease:
        with self._lock:
            if n_devices > len(self._free):
                raise RuntimeError(
                    f"requested {n_devices} devices, only {len(self._free)} free"
                )
            devs = self._free[:n_devices]
            del self._free[:n_devices]
            self._leased.update(devs)  # Counter.update counts each entry
            nodes = [next(self._host_slots) for _ in range(n_nodes)]
            return Lease(next(self._lease_ids), devs, nodes)

    def release(self, lease: Lease) -> None:
        """Idempotent: devices not currently leased (double release) are
        ignored rather than duplicated into the free list."""
        with self._lock:
            for d in lease.devices:
                if self._leased[d] > 0:
                    self._leased[d] -= 1
                    self._free.append(d)
            lease.devices = []
            lease.nodes = []


class Pilot:
    """A placeholder allocation running one framework (paper §4.1)."""

    def __init__(self, service: "PilotComputeService", pcd: PilotComputeDescription,
                 plugin: ManagerPlugin, lease: Lease, parent: "Pilot | None" = None):
        self.service = service
        self.pcd = pcd
        self.plugin = plugin
        self.lease = lease
        self.parent = parent
        self.state = PilotState.NEW
        self.submitted_at = time.monotonic()
        self.running_at: float | None = None
        self.children: list[Pilot] = []

    # -- lifecycle -----------------------------------------------------------

    def wait(self) -> "Pilot":
        self.plugin.wait()
        if self.state == PilotState.PROVISIONING:
            self.state = PilotState.RUNNING
            self.running_at = time.monotonic()
        return self

    def cancel(self) -> None:
        if self.parent is not None:
            # extension pilot: shrink the parent's cluster (paper §4.2)
            self.parent.plugin.shrink(self.lease)
            self.parent.children.remove(self)
        else:
            for child in list(self.children):
                child.cancel()
            self.plugin.cancel()
        self.service._release(self)
        self.state = PilotState.STOPPED

    @property
    def startup_time(self) -> float | None:
        if self.running_at is None:
            return None
        return self.running_at - self.submitted_at

    # -- work (Listings 5/6) ---------------------------------------------------

    def submit(self, fn, *args, **kwargs) -> ComputeUnit:
        root = self.parent if self.parent is not None else self
        return root.plugin.run_cu(ComputeUnit(fn, args, kwargs))

    def get_context(self, configuration: dict | None = None) -> Any:
        root = self.parent if self.parent is not None else self
        return root.plugin.get_context(configuration)

    def get_config_data(self) -> dict:
        return self.plugin.get_config_data()


class PilotComputeService:
    """Entry point (paper Listing 2): ``PilotComputeService().submit_pilot(pcd)``."""

    def __init__(self, devices: list | None = None, *, provision_delay_per_node: float = 0.0,
                 heartbeat_interval: float = 0.2, heartbeat_timeout: float = 2.0,
                 metrics: Any | None = None):
        self.pool = DevicePool(devices)
        self.pilots: list[Pilot] = []
        #: heartbeat kwargs are tunable so tests can run with sub-second
        #: failure detection instead of the 2s default
        self.monitor = HeartbeatMonitor(heartbeat_interval, heartbeat_timeout)
        #: emulates the scheduler/bootstrap latency of real clusters (Fig. 6)
        self.provision_delay_per_node = provision_delay_per_node
        #: duck-typed MetricsBus (repro_torch.elastic.metrics); pool gauges
        #: are published on every lease change when set
        self.metrics = metrics
        #: lazily-created ResourceArbiter (repro_torch.scheduler) — one per
        #: service, shared by every pipeline/consumer on this pool
        self.arbiter = None
        self._lock = threading.Lock()

    def get_arbiter(self, bus: Any | None = None, **kw):
        """The service's single :class:`repro_torch.scheduler.ResourceArbiter`,
        created on first use. All pipelines sharing this service (and thus
        its DevicePool) arbitrate through this one instance — that is what
        makes multi-tenant fairness possible at all.

        The first caller's ``bus`` wins: ``scheduler.*`` telemetry has one
        home (prefer one shared MetricsBus across runs on a shared
        service). Later callers passing a *different* bus get a warning so
        the absence of scheduler gauges on their bus is explicable.
        """
        with self._lock:
            if self.arbiter is None:
                from repro_torch.scheduler import ResourceArbiter

                self.arbiter = ResourceArbiter(self, bus=bus or self.metrics, **kw)
            elif bus is not None and bus is not self.arbiter.bus:
                import warnings

                warnings.warn(
                    "service already has an arbiter bound to a different "
                    "MetricsBus; scheduler.* telemetry stays on the first "
                    "bus — share one bus across runs on a shared service",
                    stacklevel=2,
                )
            return self.arbiter

    def pool_stats(self) -> dict:
        return {
            "devices_total": self.pool.total_devices,
            "devices_leased": self.pool.leased_devices,
            "devices_free": self.pool.free_devices,
            "utilization": self.pool.utilization,
        }

    def _publish_pool(self) -> None:
        if self.metrics is not None:
            for k, v in self.pool_stats().items():
                self.metrics.publish(f"pool.{k}", v)

    def submit_pilot(self, pcd: PilotComputeDescription | dict) -> Pilot:
        if isinstance(pcd, dict):
            pcd = PilotComputeDescription.from_dict(pcd)
        cls = plugin_class(pcd.framework)
        needs_devices = getattr(cls, "USES_DEVICES", False)
        n_devices = pcd.number_of_nodes * pcd.cores_per_node if needs_devices else 0
        n_devices = min(n_devices, self.pool.free_devices)
        lease = self.pool.acquire(n_devices, pcd.number_of_nodes)

        if pcd.parent is not None:
            parent: Pilot = pcd.parent
            pilot = Pilot(self, pcd, parent.plugin, lease, parent=parent)
            pilot.state = PilotState.PROVISIONING
            self._provision_delay(pcd)
            parent.plugin.extend(lease)
            parent.children.append(pilot)
            parent.state = PilotState.EXTENDED
        else:
            plugin = cls(pcd)
            pilot = Pilot(self, pcd, plugin, lease)
            pilot.state = PilotState.PROVISIONING
            self._provision_delay(pcd)
            plugin.submit_job(lease)
        with self._lock:
            self.pilots.append(pilot)
        self.monitor.watch(pilot)
        self._publish_pool()
        return pilot.wait()

    def _provision_delay(self, pcd: PilotComputeDescription) -> None:
        if self.provision_delay_per_node:
            time.sleep(self.provision_delay_per_node * pcd.number_of_nodes)

    def _release(self, pilot: Pilot, *, unwatch: bool = True) -> None:
        if unwatch:
            self.monitor.unwatch(pilot)
        self.pool.release(pilot.lease)
        with self._lock:
            if pilot in self.pilots:
                self.pilots.remove(pilot)
        self._publish_pool()

    # -- fault injection / recovery (tests) ------------------------------------

    def inject_failure(self, pilot: Pilot) -> None:
        """Simulate an agent crash: heartbeats stop, plugin is notified.

        The lease is released, but the pilot stays *watched*: the monitor
        detects the stale heartbeat after ``heartbeat_timeout``, fires its
        ``on_failure`` callbacks, then unwatches it."""
        self.monitor.mark_dead(pilot)
        pilot.state = PilotState.FAILED
        root = pilot.parent if pilot.parent is not None else pilot
        try:
            root.plugin.on_failure(pilot.lease)
        finally:
            self._release(pilot, unwatch=False)

    def cancel(self) -> None:
        for p in list(self.pilots):
            try:
                p.cancel()
            except Exception:
                pass
        if self.arbiter is not None:
            self.arbiter.stop()
        self.monitor.stop()
