"""Monotonic timing helpers for benchmarks and engine metrics."""
from __future__ import annotations

import time
from dataclasses import dataclass, field


def now_monotonic() -> float:
    return time.monotonic()


@dataclass
class Timer:
    """Accumulating timer: ``with timer: ...`` adds to ``total``."""

    total: float = 0.0
    count: int = 0
    _start: float = field(default=0.0, repr=False)

    def __enter__(self) -> "Timer":
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.total += time.monotonic() - self._start
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
