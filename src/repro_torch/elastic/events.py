"""Scaling events and timeline export (the paper's Fig. 8 data product).

``timeline`` folds the MetricsBus history plus the controller's event log
into one JSON-serializable dict — lag / devices / throughput vs. time —
the data a rate-step run plots (lag and devices against time).
"""
from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_SERIES = (
    "stream.lag",
    "stream.records_per_sec",
    "elastic.devices",
    "elastic.lag",
)


@dataclass(frozen=True)
class ScalingEvent:
    t: float
    action: str  # "scale_up" | "scale_down" | "rejected"
    delta: int
    devices_before: int
    devices_after: int
    reason: str = ""

    def to_dict(self) -> dict:
        return {
            "t": self.t,
            "action": self.action,
            "delta": self.delta,
            "devices_before": self.devices_before,
            "devices_after": self.devices_after,
            "reason": self.reason,
        }


@dataclass
class EventLog:
    events: list[ScalingEvent] = field(default_factory=list)

    def record(self, event: ScalingEvent) -> ScalingEvent:
        self.events.append(event)
        return event

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def of(self, action: str) -> list[ScalingEvent]:
        return [e for e in self.events if e.action == action]


def timeline(bus, events=(), *, names=DEFAULT_SERIES, t0: float | None = None) -> dict:
    """Bus history + events -> ``{"series": {name: [[t, v], ...]}, "events": [...]}``.

    Times are made relative to ``t0`` (default: earliest point) so the JSON
    is stable across runs and plottable as seconds-from-start.
    """
    series = {name: bus.series(name) for name in names}
    series = {n: pts for n, pts in series.items() if pts}
    ev = sorted(events, key=lambda e: e.t)
    if t0 is None:
        starts = [pts[0][0] for pts in series.values()] + [e.t for e in ev]
        t0 = min(starts) if starts else 0.0
    return {
        "t0": t0,
        "series": {
            n: [[round(t - t0, 4), v] for t, v in pts] for n, pts in series.items()
        },
        "events": [
            {**e.to_dict(), "t": round(e.t - t0, 4)} for e in ev
        ],
    }
