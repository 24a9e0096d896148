"""Streaming hot-path dispatch: async double-buffering + latency quantiles.

An unconditional device synchronise after every micro-batch serializes host
dispatch against device compute. :class:`AsyncWindow` keeps a bounded
number of batches in flight (double-buffering at ``depth=2``): batch N+1 is
dispatched while batch N executes, and the host only blocks when the window
is full or at an explicit ``sync()`` boundary (stats read, checkpoint,
elastic rescale). Completion is a ``torch.cuda.Event`` recorded on the
current stream right after a batch's work was queued; CPU tensors are
complete when the call returns.

:class:`LatencyWindow` tracks rolling per-batch completion latency and
exposes p50/p99 for the ``MetricsBus``.

PyTorch runs eagerly and does not recompile per input shape, so the
Mini-App processors send batches to the device at their own size. The
serving engine still needs :class:`ShapeBuckets` and :func:`pad_rows`:
its admission reserves pages for a prompt's whole bucket, so the buckets
decide which requests are admitted when (``serving/batcher.py``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class ShapeBuckets:
    """Quantize variable sizes to a fixed power-of-two bucket set.

    Sizes above ``max_size`` round up to the next multiple of ``max_size``.
    """

    def __init__(self, min_size: int = 256, max_size: int = 65536):
        self.min_size = next_pow2(min_size)
        self.max_size = max(next_pow2(max_size), self.min_size)
        sizes, s = [], self.min_size
        while s <= self.max_size:
            sizes.append(s)
            s *= 2
        self.sizes: tuple[int, ...] = tuple(sizes)

    def fit(self, n: int) -> int:
        """Smallest bucket that holds ``n`` rows."""
        for s in self.sizes:
            if n <= s:
                return s
        return -(-n // self.max_size) * self.max_size

    def __len__(self) -> int:
        return len(self.sizes)

    def __iter__(self):
        return iter(self.sizes)

    def __repr__(self) -> str:
        return f"ShapeBuckets({list(self.sizes)})"


def pad_rows(arr: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad axis 0 of ``arr`` up to ``size`` rows (host-side, cheap)."""
    if arr.shape[0] >= size:
        return arr
    out = np.zeros((size,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class LatencyWindow:
    """Rolling window of per-batch latencies with cheap quantiles."""

    def __init__(self, maxlen: int = 256):
        self._lat: deque[float] = deque(maxlen=maxlen)
        self.count = 0

    def record(self, dt: float) -> None:
        self._lat.append(dt)
        self.count += 1

    def quantile(self, q: float) -> float:
        if not self._lat:
            return 0.0
        return float(np.quantile(np.asarray(self._lat), q))

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def __len__(self) -> int:
        return len(self._lat)


def _first_tensor(obj: Any) -> torch.Tensor | None:
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for item in obj:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def completion_event(result: Any) -> torch.cuda.Event | None:
    """An event recorded on the current stream of the device that holds
    ``result`` (its first tensor), or None when it lives on the CPU."""
    t = _first_tensor(result)
    if t is None or t.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


class AsyncWindow:
    """Bounded window of in-flight device work (double buffering).

    ``push(result, meta)`` enqueues a just-dispatched result. When more than
    ``depth`` results are pending the oldest is waited on, so the device
    queue stays bounded while newer batches dispatch. Each completed entry is
    returned as ``(result, meta, latency_s)`` — callers fold these into
    their stats. ``depth=0`` degenerates to fully synchronous execution.
    """

    def __init__(self, depth: int = 2, latency: LatencyWindow | None = None):
        self.depth = max(int(depth), 0)
        self.latency = latency
        self._pending: deque[tuple[Any, Any, float, torch.cuda.Event | None]] = deque()
        # the engine thread pushes; sync() may come from a rescale/stats
        # thread — serialize drains so both never pop the same entry
        self._lock = threading.Lock()

    def push(self, result: Any, meta: Any = None,
             t0: float | None = None) -> list[tuple[Any, Any, float]]:
        """Enqueue a dispatched result. ``t0`` is the batch's start-of-work
        timestamp (defaults to now): completion latency is measured from it,
        so host-side batch prep counts toward the recorded latency."""
        event = completion_event(result)
        done = []
        with self._lock:
            self._pending.append(
                (result, meta, time.monotonic() if t0 is None else t0, event))
            while len(self._pending) > self.depth:
                done.append(self._wait_oldest())
        return done

    def _wait_oldest(self) -> tuple[Any, Any, float]:
        result, meta, t0, event = self._pending.popleft()
        if event is not None:
            event.synchronize()
        dt = time.monotonic() - t0
        if self.latency is not None:
            self.latency.record(dt)
        return result, meta, dt

    def sync(self) -> list[tuple[Any, Any, float]]:
        """Drain every in-flight batch (the stats/checkpoint/rescale barrier)."""
        done = []
        with self._lock:
            while self._pending:
                done.append(self._wait_oldest())
        return done

    @property
    def in_flight(self) -> int:
        return len(self._pending)
