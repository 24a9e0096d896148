"""Compute-Units: framework-agnostic tasks with future semantics (Listing 5)."""
from __future__ import annotations

import enum
import threading
import time
import traceback
from typing import Any, Callable


class CUState(str, enum.Enum):
    NEW = "New"
    RUNNING = "Running"
    DONE = "Done"
    FAILED = "Failed"
    CANCELED = "Canceled"


class ComputeUnit:
    """A unit of work submitted to a pilot; ``wait()`` blocks for the result."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, fn: Callable, args: tuple = (), kwargs: dict | None = None):
        with ComputeUnit._ids_lock:
            self.cu_id = next(ComputeUnit._ids)
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}
        self.state = CUState.NEW
        self.submitted_at = time.monotonic()
        self.started_at: float | None = None
        self.finished_at: float | None = None
        self.attempts = 0
        self._result: Any = None
        self._error: BaseException | None = None
        self._done = threading.Event()

    # -- executor side -------------------------------------------------------

    def run(self) -> None:
        """Execute (idempotent completion: first finisher wins — speculative
        duplicates call this concurrently)."""
        self.attempts += 1
        if self._done.is_set():
            return
        self.state = CUState.RUNNING
        self.started_at = self.started_at or time.monotonic()
        try:
            result = self.fn(*self.args, **self.kwargs)
        except BaseException as e:  # noqa: BLE001 - reported via wait()
            if not self._done.is_set():
                self._error = e
                self.state = CUState.FAILED
                self.finished_at = time.monotonic()
                self._done.set()
            return
        if not self._done.is_set():
            self._result = result
            self.state = CUState.DONE
            self.finished_at = time.monotonic()
            self._done.set()

    def cancel(self) -> None:
        if not self._done.is_set():
            self.state = CUState.CANCELED
            self._done.set()

    # -- caller side ------------------------------------------------------------

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"CU {self.cu_id} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def runtime(self) -> float | None:
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at
