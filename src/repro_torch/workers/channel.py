"""WorkerChannel — the request/reply queue pair between the host runtime
and one worker process.

Correlation is by sequence number: the host allocates a fresh ``seq`` per
request, and :meth:`recv` silently drops any reply with an older ``seq`` —
replies abandoned by a batch timeout, or left over from before a restart,
can never be mistaken for the answer to the current command. That stale
drop (plus an explicit :meth:`drain` before quiesce) is what makes rescale
safe while worker batches are in flight.
"""
from __future__ import annotations

import queue
import time
from typing import Any, Callable

from repro_torch.workers.proto import Reply, Request, WorkerCrash, WorkerUnresponsive

_POLL = 0.05  # reply poll granularity: bounds crash-detection latency


class WorkerChannel:
    """One requests + one replies :class:`multiprocessing.Queue`, created
    fresh per worker incarnation (a respawn abandons the old pair, so a
    late write from a dying process lands nowhere the host still reads)."""

    def __init__(self, ctx):
        self.requests = ctx.Queue()
        self.replies = ctx.Queue()
        self._seq = 0
        self._closed = False

    def send(self, cmd: str, payload: Any = None) -> int:
        self._seq += 1
        self.requests.put(Request(self._seq, cmd, payload))
        return self._seq

    def recv(self, seq: int, timeout: float,
             alive_fn: Callable[[], bool] | None = None,
             responsive_fn: Callable[[], bool] | None = None) -> Reply:
        """Wait for the reply to ``seq``.

        Raises :class:`WorkerCrash` when ``alive_fn`` reports the process
        dead (or the queue tears mid-unpickle), :class:`WorkerUnresponsive`
        when ``responsive_fn`` reports stale heartbeats or ``timeout``
        elapses. Replies with ``reply.seq < seq`` are stale and dropped;
        a *newer* seq is a protocol bug and raises.
        """
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise WorkerUnresponsive(
                    f"no reply to seq={seq} within {timeout:.1f}s")
            try:
                reply = self.replies.get(timeout=min(remaining, _POLL))
            except queue.Empty:
                # no reply yet: distinguish dead / wedged / merely slow
                if alive_fn is not None and not alive_fn():
                    raise WorkerCrash(f"worker died awaiting seq={seq}")
                if responsive_fn is not None and not responsive_fn():
                    raise WorkerUnresponsive(
                        f"worker heartbeat went stale awaiting seq={seq}")
                continue
            except (EOFError, OSError) as e:  # torn queue (killed mid-write)
                raise WorkerCrash(f"reply channel torn awaiting seq={seq}: {e}")
            if reply.seq < seq:
                continue  # stale: abandoned batch or pre-drain leftover
            if reply.seq > seq:
                raise WorkerCrash(
                    f"protocol error: got seq={reply.seq}, expected {seq}")
            return reply

    def request(self, cmd: str, payload: Any = None, *, timeout: float = 30.0,
                alive_fn: Callable[[], bool] | None = None,
                responsive_fn: Callable[[], bool] | None = None) -> Reply:
        return self.recv(self.send(cmd, payload), timeout,
                         alive_fn=alive_fn, responsive_fn=responsive_fn)

    def drain(self) -> int:
        """Discard every reply currently buffered (returns how many). Run
        before QUIESCE/rescale so no in-flight batch result can alias a
        later command's reply."""
        n = 0
        while True:
            try:
                self.replies.get_nowait()
                n += 1
            except (queue.Empty, EOFError, OSError):
                return n

    def close(self) -> None:
        """Release both queues without joining their feeder threads (the
        worker side may already be dead; blocking here could hang
        teardown). Idempotent."""
        if self._closed:
            return
        self._closed = True
        for q in (self.requests, self.replies):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass
