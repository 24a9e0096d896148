"""Task-parallel engine (Dask/RADICAL-Pilot analog) with straggler mitigation.

Executes Compute-Units on a worker pool sized by the lease. Speculative
execution: a task running longer than ``speculative_multiple`` x the median
completed runtime is re-launched on another worker; the first completion
wins (ComputeUnit.run is first-wins idempotent).
"""
from __future__ import annotations

import queue
import statistics
import threading
import time
from typing import Any

from repro_torch.core.compute_unit import ComputeUnit, CUState
from repro_torch.core.plugin import Lease, ManagerPlugin, register_plugin


@register_plugin("taskpool")
@register_plugin("dask")  # paper naming convenience
class TaskPoolPlugin(ManagerPlugin):
    USES_DEVICES = False

    def __init__(self, pcd):
        super().__init__(pcd)
        self._queue: "queue.Queue[ComputeUnit | None]" = queue.Queue()
        self._workers: dict[int, threading.Event] = {}
        self._inflight: dict[int, tuple[ComputeUnit, float]] = {}
        self._runtimes: list[float] = []
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._stop = threading.Event()
        self.speculative = bool(self.pcd.config.get("speculative", True))
        self.speculative_multiple = float(self.pcd.config.get("speculative_multiple", 3.0))
        self.speculated = 0
        self._spec_thread: threading.Thread | None = None

    # ---- SPI ----------------------------------------------------------------

    def submit_job(self, lease: Lease) -> None:
        workers = max(len(lease.nodes) * max(self.pcd.cores_per_node, 1), 1)
        for slot in range(workers):
            self._spawn_worker(slot)
        if self.speculative:
            self._spec_thread = threading.Thread(target=self._speculator, daemon=True)
            self._spec_thread.start()
        self._ready.set()

    def wait(self) -> None:
        self._ready.wait()

    def extend(self, lease: Lease) -> None:
        base = max(self._workers, default=-1) + 1
        for i in range(max(len(lease.nodes) * max(self.pcd.cores_per_node, 1), 1)):
            self._spawn_worker(base + i)

    def shrink(self, lease: Lease) -> None:
        n = max(len(lease.nodes) * max(self.pcd.cores_per_node, 1), 1)
        with self._lock:
            victims = sorted(self._workers)[-n:]
            for slot in victims:
                self._workers.pop(slot).set()

    def get_context(self, configuration: dict | None = None) -> "TaskPoolPlugin":
        return self

    def run_cu(self, cu: ComputeUnit) -> ComputeUnit:
        self._queue.put(cu)
        return cu

    def cancel(self) -> None:
        self._stop.set()
        with self._lock:
            for ev in self._workers.values():
                ev.set()
            self._workers.clear()
        self._queue.put(None)

    # ---- internals -------------------------------------------------------------

    @property
    def n_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    def _spawn_worker(self, slot: int) -> None:
        stop = threading.Event()
        with self._lock:
            self._workers[slot] = stop

        def work():
            while not stop.is_set() and not self._stop.is_set():
                try:
                    cu = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if cu is None:
                    self._queue.put(None)
                    return
                with self._lock:
                    self._inflight[cu.cu_id] = (cu, time.monotonic())
                cu.run()
                with self._lock:
                    self._inflight.pop(cu.cu_id, None)
                    if cu.runtime is not None and cu.state == CUState.DONE:
                        self._runtimes.append(cu.runtime)

        threading.Thread(target=work, daemon=True).start()

    def _speculator(self) -> None:
        while not self._stop.is_set():
            time.sleep(0.05)
            with self._lock:
                if len(self._runtimes) < 3:
                    continue
                median = statistics.median(self._runtimes[-100:])
                now = time.monotonic()
                slow = [
                    cu
                    for cu, started in self._inflight.values()
                    if not cu.done() and (now - started) > self.speculative_multiple * max(median, 1e-3)
                ]
            for cu in slow:
                self.speculated += 1
                self._queue.put(cu)  # duplicate attempt; first completion wins
                with self._lock:
                    self._inflight[cu.cu_id] = (cu, time.monotonic())
