"""Heartbeats + failure detection for pilot agents (paper §4: "continuously
monitors the framework adding a level of fault tolerance").

Two watch styles share one monitor:

* **self-beating** (``watch(pilot)``) — an agent thread stamps a fresh beat
  every ``interval`` on the watched object's behalf. Beats only go stale
  when :meth:`mark_dead` stops the agent (failure *injection*) — the mode
  the pilot service has always used.
* **pull-based** (``watch(obj, beat_fn=...)``) — the agent thread *samples*
  ``beat_fn()`` (a monotonic timestamp the watched thing maintains itself,
  e.g. a worker process stamping a shared ``mp.Value``). Beats go stale
  whenever the real heartbeat source stops advancing, so crashes and hangs
  of out-of-process workers are detected for real.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable


class HeartbeatMonitor:
    """Each watched pilot gets an agent thread emitting heartbeats; a monitor
    thread flags pilots whose heartbeat is older than ``timeout``."""

    def __init__(self, interval: float = 0.2, timeout: float = 2.0):
        self.interval = interval
        self.timeout = timeout
        self._beats: dict[int, float] = {}
        self._dead: set[int] = set()
        self._agents: dict[int, threading.Event] = {}
        self._agent_threads: dict[int, threading.Thread] = {}
        self._callbacks: list[Callable[[Any], None]] = []
        self._watched: dict[int, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False
        self._monitor = threading.Thread(target=self._run, daemon=True)
        self._monitor.start()

    def on_failure(self, cb: Callable[[Any], None]) -> None:
        self._callbacks.append(cb)

    def watch(self, pilot: Any, beat_fn: Callable[[], float] | None = None) -> None:
        """Start monitoring ``pilot``. Without ``beat_fn`` the agent thread
        self-beats (stale only via :meth:`mark_dead`); with it, the agent
        samples the external heartbeat source each interval and staleness
        means the source genuinely stopped."""
        stop = threading.Event()
        key = id(pilot)
        now = beat_fn() if beat_fn is not None else time.monotonic()
        with self._lock:
            self._beats[key] = now
            self._agents[key] = stop
            self._watched[key] = pilot

        def agent():
            while not stop.is_set() and not self._stop.is_set():
                with self._lock:
                    if key not in self._dead:
                        self._beats[key] = (
                            beat_fn() if beat_fn is not None else time.monotonic()
                        )
                stop.wait(self.interval)

        t = threading.Thread(target=agent, daemon=True)
        with self._lock:
            self._agent_threads[key] = t
        t.start()

    def unwatch(self, pilot: Any) -> None:
        key = id(pilot)
        with self._lock:
            ev = self._agents.pop(key, None)
            self._agent_threads.pop(key, None)
            self._beats.pop(key, None)
            self._watched.pop(key, None)
            self._dead.discard(key)
        if ev:
            ev.set()

    def mark_dead(self, pilot: Any) -> None:
        """Failure injection: the agent stops heartbeating."""
        with self._lock:
            self._dead.add(id(pilot))

    def is_alive(self, pilot: Any) -> bool:
        with self._lock:
            beat = self._beats.get(id(pilot))
        return beat is not None and (time.monotonic() - beat) < self.timeout

    def _run(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            stale = []
            with self._lock:
                for key, beat in list(self._beats.items()):
                    if now - beat > self.timeout:
                        stale.append(self._watched.get(key))
            for pilot in stale:
                for cb in self._callbacks:
                    try:
                        cb(pilot)
                    except Exception:
                        pass
                if pilot is not None:
                    self.unwatch(pilot)
            self._stop.wait(self.interval)

    def close(self) -> None:
        """Idempotently stop the monitor thread and every agent thread,
        joining them so nothing leaks past the owner's lifetime. Every
        constructor of a monitor must pair it with a ``close()`` (the pilot
        service does in ``cancel()``; the worker runtime in ``shutdown()``)
        — before this existed, each ``watch()`` leaked a daemon agent
        thread for the life of the process."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            agents = list(self._agents.values())
            threads = list(self._agent_threads.values())
            self._agents.clear()
            self._agent_threads.clear()
        self._stop.set()
        for ev in agents:
            ev.set()
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=2)
        if self._monitor is not threading.current_thread():
            self._monitor.join(timeout=2)

    def stop(self) -> None:
        """Backwards-compatible alias for :meth:`close`."""
        self.close()
