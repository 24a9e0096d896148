"""Control protocol of the multiprocess partition execution runtime.

One :class:`Request`/:class:`Reply` pair per command, correlated by a
monotonically increasing sequence number per channel (stale replies from a
pre-restart incarnation or an abandoned batch are dropped by sequence, not
by guesswork). Everything that crosses the process boundary is plain
picklable data; partition *state* crosses only as the columnar serde bytes
of ``repro_torch.state.store.serialize_partition`` — the exact wire format a
cross-host hand-off would use.

Commands
--------
``CONFIGURE``      {"pids": [int]} — own these partitions (empty state
                   created for pids not later RESTOREd)
``PROCESS_BATCH``  {"ops": [op], "watermark": float} — apply ingest ops,
                   then fire every window closed at the watermark; replies
                   with a :class:`BatchResult`
``QUIESCE``        run the processor's sync barrier; ack when idle
``SNAPSHOT``       {"pids": [int], "release": bool} — serialize partitions
                   (dropping them when ``release``, the migration-out path)
``RESTORE``        {pid: bytes} — install deserialized partitions; replies
                   with per-pid buffered record counts
``STATS``          aggregate counters for gauges/debugging
``STOP``           ack, then exit the worker loop

Ingest ops (tuples, first element is the tag)
---------------------------------------------
``(OP_OBSERVE, pid, ts)``           per-record counters + max event time
``(OP_APPEND, pid, key, w, msg)``   buffer one message into one window
``(OP_LATE, pid)``                  count a late-dropped record
``(OP_MERGE, pid, key, w)``         session merge: fold overlapping buffers
                                    of ``key`` into the merged window ``w``
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

CONFIGURE = "CONFIGURE"
PROCESS_BATCH = "PROCESS_BATCH"
QUIESCE = "QUIESCE"
SNAPSHOT = "SNAPSHOT"
RESTORE = "RESTORE"
STATS = "STATS"
STOP = "STOP"

OP_OBSERVE = "o"
OP_APPEND = "a"
OP_LATE = "l"
OP_MERGE = "m"


@dataclass(frozen=True)
class Request:
    seq: int
    cmd: str
    payload: Any = None


@dataclass(frozen=True)
class Reply:
    seq: int
    ok: bool
    payload: Any = None
    error: str | None = None


@dataclass(frozen=True)
class BatchResult:
    """One PROCESS_BATCH's outcome: windows fired by this worker in its
    canonical order (the global order restricted to its partitions — what
    makes the host's merge, and crash-replay output counting, exact)."""

    fired: list  # [(pid, key, window, out), ...]
    buffered_windows: int
    elapsed_ms: float


class WorkerError(RuntimeError):
    """The worker executed the command and it raised (user-code error —
    deterministic, so restarts would not help; it propagates like an
    inline-executor exception would)."""


class WorkerCrash(RuntimeError):
    """The worker process died (or its channel was torn mid-message) — the
    supervisor's restart-with-recovery path, not the user's problem."""


class WorkerUnresponsive(WorkerCrash):
    """Heartbeats stale / batch deadline exceeded: the worker is wedged.
    Treated like a crash (kill + restart + replay)."""
