"""Window assigners + watermarks (paper §3.1: fixed/sliding/session windows,
processing-time or event-time)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable

#: a window is the half-open interval [start, end)
Window = tuple[float, float]


@dataclass(frozen=True)
class TumblingWindow:
    size: float

    def assign(self, ts: float) -> list[Window]:
        start = math.floor(ts / self.size) * self.size
        return [(start, start + self.size)]


@dataclass(frozen=True)
class SlidingWindow:
    size: float
    slide: float

    def assign(self, ts: float) -> list[Window]:
        out = []
        first = math.floor((ts - self.size) / self.slide) * self.slide + self.slide
        start = first
        while start <= ts:
            out.append((start, start + self.size))
            start += self.slide
        return [w for w in out if w[0] <= ts < w[1]]


@dataclass
class SessionWindow:
    """Gap-based session windows; assignment is stateful per key.

    Each element opens the proto-session ``[ts, ts + gap)``; any existing
    session of the key that *overlaps* it (half-open intervals — touching
    exactly at the boundary starts a new session) is folded in. A key may
    hold several concurrent sessions, so out-of-order arrivals can bridge
    two older sessions into one — and the final session set for a key is a
    pure interval union, independent of arrival order (property-tested in
    tests/test_windows.py; de-facto required for rescale determinism, since
    a migration replays buffers in canonical, not arrival, order).
    """

    gap: float
    _sessions: dict = field(default_factory=dict)  # key -> [(start, end), ...]

    def assign(self, ts: float, key=None) -> list[Window]:
        lo, hi = ts, ts + self.gap
        keep = []
        for s in self._sessions.get(key, ()):
            if s[1] <= lo or s[0] >= hi:  # disjoint: keep as-is
                keep.append(s)
            else:  # overlap: absorb into the merged session
                lo, hi = min(lo, s[0]), max(hi, s[1])
        merged = (lo, hi)
        keep.append(merged)
        keep.sort()
        self._sessions[key] = keep
        return [merged]

    def sessions(self, key=None) -> list[Window]:
        """Current (un-closed) sessions of ``key``, ordered by start."""
        return list(self._sessions.get(key, ()))

    def close_before(self, watermark: float, key=None) -> list[Window]:
        closed = []
        for k, sessions in list(self._sessions.items()):
            if key is not None and k != key:
                continue
            done = [s for s in sessions if s[1] <= watermark]
            if done:
                closed.extend(done)
                remaining = [s for s in sessions if s[1] > watermark]
                if remaining:
                    self._sessions[k] = remaining
                else:
                    del self._sessions[k]
        return sorted(closed)


class WatermarkTracker:
    """Event-time watermark: max observed timestamp minus allowed lateness."""

    def __init__(self, allowed_lateness: float = 0.0):
        self.allowed_lateness = allowed_lateness
        self._max_ts = -math.inf

    def observe(self, ts: float) -> None:
        self._max_ts = max(self._max_ts, ts)

    @property
    def watermark(self) -> float:
        return self._max_ts - self.allowed_lateness

    def is_late(self, ts: float) -> bool:
        return ts < self.watermark
