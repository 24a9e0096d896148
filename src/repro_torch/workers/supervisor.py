"""WorkerSupervisor — one per worker process: lifecycle + liveness.

The supervisor owns everything incarnation-scoped: the process handle, the
channel (queue pair), and the shared heartbeat cell. A respawn replaces
all three — late writes from a killed incarnation land in abandoned
queues, and the fresh heartbeat cell starts un-stale.

Liveness is two signals with different latencies:

* **crash** — ``Process.is_alive()`` goes false the moment the child dies
  (SIGKILL, OOM, unhandled exit); the channel's reply poll notices within
  ~50 ms.
* **hang** — the process is alive but stopped stamping its heartbeat (a
  wedged window_fn). The supervisor registers with the shared
  :class:`~repro_torch.core.failure.HeartbeatMonitor` using a pull-based
  ``beat_fn`` that samples the worker's ``mp.Value``; once the sampled
  beat is older than the monitor's timeout, :meth:`responsive` flips and
  in-flight ``recv`` calls raise :class:`WorkerUnresponsive`.

Both surface as a :class:`WorkerCrash` subclass to the runtime, which
answers with kill + respawn + restore-from-checkpoint + journal replay.

A forked worker is watched from the moment it starts, as in the JAX
package. A spawned one first imports torch, creates its CUDA context and
loads the kernels' libraries — seconds, longer than a heartbeat timeout —
so its cell starts at 0 and the supervisor waits for its first beat under
a start deadline of its own (``batch_timeout``), records the wait in
``start_seconds``, and only then watches it.
"""
from __future__ import annotations

import queue
import time
from typing import Any, Callable

from repro_torch.core.failure import HeartbeatMonitor
from repro_torch.workers.channel import WorkerChannel
from repro_torch.workers.proto import STOP, Reply, WorkerCrash, WorkerError, WorkerUnresponsive
from repro_torch.workers.worker import PartitionWorker

_START_POLL = 0.01  # how often a cold start's first beat is looked for


class WorkerSupervisor:
    def __init__(self, worker_id: int, owner: Any,
                 window_fn: Callable[[Any, tuple, list], Any] | bytes, *,
                 monitor: HeartbeatMonitor, ctx,
                 batch_timeout: float = 30.0,
                 restart_backoff: float = 0.05,
                 restart_backoff_cap: float = 2.0,
                 device: Any = None):
        self.worker_id = worker_id
        self.owner = owner  # the pilot slot whose partitions this worker runs
        #: the owner's device (a spawned worker creates its context there)
        self.device = device
        #: the callable (forked workers) or its pickle (spawned ones)
        self.window_fn = window_fn
        self.monitor = monitor
        self.ctx = ctx
        self.batch_timeout = batch_timeout
        #: base/cap of the exponential respawn backoff: a worker that keeps
        #: dying (a crash *storm* — e.g. OOM on the first batch every time)
        #: respawns at most every ``restart_backoff_cap`` seconds instead of
        #: in a tight fork loop; the first restart of a streak is immediate
        self.restart_backoff = restart_backoff
        self.restart_backoff_cap = restart_backoff_cap
        self.restarts = 0
        #: the delay the most recent respawn waited (the
        #: ``workers.restart_backoff_ms`` gauge source)
        self.last_backoff_s = 0.0
        #: per cold-started incarnation: seconds from ``Process.start()`` to
        #: its first beat (device context and libraries up)
        self.start_seconds: list[float] = []
        self._streak = 0
        self._last_respawn = 0.0
        self._started_at = 0.0
        self.channel: WorkerChannel | None = None
        self.process = None
        self._beat = None

    # -- lifecycle ------------------------------------------------------------

    @property
    def cold(self) -> bool:
        """Spawned (a fresh interpreter), not forked."""
        return self.ctx.get_start_method() != "fork"

    def spawn(self, wait: bool = True) -> "WorkerSupervisor":
        """Start an incarnation. A forked one is watched at once; a spawned
        one after its first beat — here when ``wait``, else at the
        caller's :meth:`await_start` (the runtime starts every worker
        before waiting for any)."""
        self.channel = WorkerChannel(self.ctx)
        self._beat = self.ctx.Value("d", 0.0 if self.cold else time.monotonic())
        worker = PartitionWorker(self.worker_id, self.channel.requests,
                                 self.channel.replies, self._beat,
                                 self.window_fn, device=self.device)
        self.process = self.ctx.Process(
            target=worker.run, daemon=True,
            name=f"repro-worker-{self.worker_id}")
        self._started_at = time.monotonic()
        self.process.start()
        if not self.cold:
            self._watch()
        elif wait:
            self.await_start()
        return self

    def await_start(self) -> float:
        """Wait for a spawned incarnation's first beat, then watch it.
        Raises :class:`WorkerCrash` (with the child's start-up error) if it
        dies first, :class:`WorkerUnresponsive` past ``batch_timeout``.
        Returns the start seconds."""
        deadline = self._started_at + self.batch_timeout
        while self._beat.value == 0.0:
            if not self.alive():
                raise WorkerCrash(f"worker {self.worker_id} died starting on "
                                  f"{self.device}: {self._start_error()}")
            if time.monotonic() > deadline:
                raise WorkerUnresponsive(f"worker {self.worker_id} not started on "
                                         f"{self.device} within {self.batch_timeout:.1f}s")
            time.sleep(_START_POLL)
        seconds = time.monotonic() - self._started_at
        self.start_seconds.append(seconds)
        self._watch()
        return seconds

    def _start_error(self) -> str:
        try:
            reply: Reply = self.channel.replies.get(timeout=1.0)
            return reply.error or "no error reported"
        except (queue.Empty, EOFError, OSError):
            return f"exit code {self.process.exitcode}"

    def _watch(self) -> None:
        beat = self._beat  # bind this incarnation's cell, not the attribute
        self.monitor.watch(self, beat_fn=lambda: beat.value)

    def kill(self) -> None:
        """Hard-stop this incarnation (no goodbye): unwatch, SIGKILL, reap,
        release the channel. Safe on an already-dead worker."""
        self.monitor.unwatch(self)
        if self.process is not None:
            try:
                self.process.kill()
            except Exception:
                pass
            self.process.join(timeout=5)
        if self.channel is not None:
            self.channel.close()

    def respawn(self) -> "WorkerSupervisor":
        """Replace the incarnation: fresh process, fresh queues, fresh
        heartbeat. The caller (runtime) re-CONFIGUREs, RESTOREs from the
        last checkpoint and replays the journal.

        Back-to-back respawns back off exponentially (capped): the streak
        resets once the previous incarnation survived a while, so an
        isolated crash still recovers immediately while a restart storm is
        throttled."""
        now = time.monotonic()
        if now - self._last_respawn > self.restart_backoff_cap * 2:
            self._streak = 0
        delay = 0.0 if self._streak == 0 else min(
            self.restart_backoff_cap,
            self.restart_backoff * (2 ** (self._streak - 1)))
        self._streak += 1
        self._last_respawn = now
        self.last_backoff_s = delay
        self.restarts += 1
        self.kill()
        if delay > 0:
            time.sleep(delay)
        return self.spawn()

    def stop(self, timeout: float = 2.0) -> None:
        """Graceful STOP (lets the worker ack and exit its loop), falling
        back to :meth:`kill` — which also runs after a clean exit to reap
        the process and close the channel."""
        try:
            if self.alive():
                self.channel.request(STOP, timeout=timeout,
                                     alive_fn=self.alive)
        except Exception:
            pass
        self.kill()

    # -- liveness -------------------------------------------------------------

    def alive(self) -> bool:
        return self.process is not None and self.process.is_alive()

    def responsive(self) -> bool:
        """False once the sampled heartbeat goes stale (wedged worker)."""
        return self.monitor.is_alive(self)

    # -- protocol -------------------------------------------------------------

    def send(self, cmd: str, payload: Any = None) -> int:
        """Fire a command without waiting (the runtime pipelines
        PROCESS_BATCH across all workers, then collects)."""
        return self.channel.send(cmd, payload)

    def recv(self, seq: int, timeout: float | None = None):
        reply: Reply = self.channel.recv(
            seq, self.batch_timeout if timeout is None else timeout,
            alive_fn=self.alive, responsive_fn=self.responsive)
        if not reply.ok:
            raise WorkerError(f"worker {self.worker_id}: {reply.error}")
        return reply.payload

    def request(self, cmd: str, payload: Any = None,
                timeout: float | None = None):
        return self.recv(self.send(cmd, payload), timeout)
