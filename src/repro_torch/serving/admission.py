"""Admission control for the serving engine: queue-or-reject at the door.

Continuous batching makes the page pool the real capacity limit — a request
admitted without pages for its *whole* lifetime (prompt + generated tokens)
would deadlock the decode loop mid-stream. The controller therefore gates
arrivals twice, before they ever touch the batcher:

* **token bucket** — a refill-rate / burst-capacity limiter on total tokens
  admitted per second. Arrivals that exceed the sustained rate are rejected
  immediately (shed at the door, not after they have held queue slots).
* **page headroom** — arrivals the rate admits but the pool cannot place
  *right now* go to a bounded FIFO queue; the batcher drains it as decode
  steps free pages. A full queue rejects.

Time is always passed in (``now``) rather than read from a clock, so the
benchmark can drive the controller on a virtual clock and trace replays are
deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

ADMIT = "admit"
QUEUE = "queue"
REJECT = "reject"


@dataclass
class TokenBucket:
    """Refill-rate limiter over admitted tokens. ``rate <= 0`` disables it."""

    rate: float  # tokens/s sustained
    burst: float  # bucket capacity (tokens)
    level: float = field(init=False)
    _t: float = field(init=False, default=0.0)

    def __post_init__(self):
        self.level = float(self.burst)

    def try_take(self, tokens: float, now: float) -> bool:
        if self.rate <= 0:
            return True
        self.level = min(self.burst, self.level + (now - self._t) * self.rate)
        self._t = now
        if tokens > self.level:
            return False
        self.level -= tokens
        return True


@dataclass
class AdmissionStats:
    admitted: int = 0
    queued: int = 0
    rejected_rate: int = 0
    rejected_queue_full: int = 0

    @property
    def rejected(self) -> int:
        return self.rejected_rate + self.rejected_queue_full

    def as_dict(self) -> dict:
        return {
            "admitted": self.admitted,
            "queued": self.queued,
            "rejected": self.rejected,
            "rejected_rate": self.rejected_rate,
            "rejected_queue_full": self.rejected_queue_full,
        }


class AdmissionController:
    """Decide admit / queue / reject for an arrival.

    ``offer`` classifies one request given the pool's free pages *now*; the
    batcher owns the queue contents (it re-offers queued requests as pages
    free up via :meth:`can_place`). ``headroom_pages`` keeps a reserve the
    controller refuses to dip into — decode-time ``ensure`` growth of live
    sequences draws from that reserve instead of deadlocking.
    """

    def __init__(self, pool: Any, *, rate: float = 0.0, burst: float | None = None,
                 max_queue: int = 64, headroom_pages: int = 0):
        self.pool = pool
        self.bucket = TokenBucket(rate, burst if burst is not None else max(rate, 1.0))
        self.max_queue = int(max_queue)
        self.headroom_pages = int(headroom_pages)
        self.stats = AdmissionStats()

    def can_place(self, total_tokens: int) -> bool:
        """Pages available right now for a ``total_tokens``-lifetime request,
        leaving the headroom reserve untouched."""
        need = self.pool.pages_for(total_tokens)
        return need <= self.pool.free_pages - self.headroom_pages

    def offer(self, total_tokens: int, now: float, *, queue_depth: int) -> str:
        """Classify one arrival; updates counters. ``queue_depth`` is the
        batcher's current wait-queue length."""
        if not self.bucket.try_take(float(total_tokens), now):
            self.stats.rejected_rate += 1
            return REJECT
        if queue_depth == 0 and self.can_place(total_tokens):
            self.stats.admitted += 1
            return ADMIT
        if queue_depth >= self.max_queue:
            self.stats.rejected_queue_full += 1
            return REJECT
        self.stats.queued += 1
        return QUEUE
