"""ResourceRequest — the declarative demand unit the arbiter trades in.

Consumers (stage controllers, the broker controller, training jobs) no
longer acquire pilots themselves; they file one request each —
``min``/``target``/``max`` resource counts plus ``weight``, ``priority``
and an optional co-location hint — and receive *grants* back. The request
object is the live handle: estimators mutate ``target`` (via
``ResourceArbiter.update``), the arbiter mutates ``granted``, and the
``actuator`` callback is how a grant becomes actual pilots.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable

#: request units. DEVICES are arbitrated against the shared DevicePool
#: (scarce, fair-shared); HOSTS are logical broker slots (plentiful —
#: clamped to [min, max] but never contended).
DEVICES = "devices"
HOSTS = "hosts"


@dataclass
class ResourceRequest:
    """One consumer's standing demand against the shared pool.

    ``target`` is the estimator's current wish; the arbiter only ever
    grants within ``[min_devices, max_devices]``. ``weight`` sets the
    proportional share among equal-priority requests; ``priority`` is
    strict — a higher tier is filled to its demand before a lower tier
    sees anything beyond its floor (that is what preemption means here).
    """

    name: str
    min_devices: int = 0
    max_devices: int | None = None
    weight: float = 1.0
    priority: int = 0
    #: name of another request whose placement bin this one must share
    colocate_with: str | None = None
    unit: str = DEVICES
    #: ``actuator(n)`` must (idempotently) scale the consumer to exactly
    #: ``n`` resources and return the count actually reached. ``None`` =
    #: a static reservation: capacity accounting only, no actuation.
    actuator: Callable[[int], int] | None = None
    #: live resource count as the consumer sees it (base pilot included);
    #: falls back to ``granted`` when unset
    current_fn: Callable[[], int] | None = None
    target: int = 0
    granted: int = field(default=0)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"request {self.name!r}: weight must be > 0")
        if self.min_devices < 0:
            raise ValueError(f"request {self.name!r}: min_devices must be >= 0")
        if self.max_devices is not None and self.max_devices < self.min_devices:
            raise ValueError(
                f"request {self.name!r}: max_devices {self.max_devices} < "
                f"min_devices {self.min_devices}"
            )
        self._lock = threading.Lock()

    # -- demand --------------------------------------------------------------

    @property
    def demand(self) -> int:
        """``target`` clamped into the request's own [min, max] band."""
        with self._lock:
            t = max(self.target, self.min_devices)
            if self.max_devices is not None:
                t = min(t, self.max_devices)
            return t

    def set_target(self, n: int) -> None:
        with self._lock:
            self.target = int(n)

    @property
    def current(self) -> int:
        """Resources this request actually *holds*: the live view when a
        ``current_fn`` is wired, the last actuated grant when only an
        actuator is, and 0 for a pure reservation (neither) — a
        reservation holds nothing, so counting its grant as arbitrable
        capacity would double-count free devices and erode the floor it
        exists to protect."""
        if self.current_fn is not None:
            return self.current_fn()
        if self.actuator is not None:
            return self.granted
        return 0
