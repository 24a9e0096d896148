"""The control protocol of the multiprocess partition runtime.

Only :mod:`~repro_torch.workers.proto` is ported so far: the continuous
engine imports its op constants. The worker processes, their channel and
supervisor, and the ``executor="mp"`` runtime wait for ROADMAP A2
(workers); the engine and ``Pipeline.validate`` refuse ``executor="mp"``
until then.
"""
from repro_torch.workers.proto import (
    CONFIGURE,
    OP_APPEND,
    OP_LATE,
    OP_MERGE,
    OP_OBSERVE,
    PROCESS_BATCH,
    QUIESCE,
    RESTORE,
    SNAPSHOT,
    STATS,
    STOP,
    BatchResult,
    Reply,
    Request,
    WorkerCrash,
    WorkerError,
    WorkerUnresponsive,
)

__all__ = [
    "BatchResult",
    "CONFIGURE",
    "OP_APPEND",
    "OP_LATE",
    "OP_MERGE",
    "OP_OBSERVE",
    "PROCESS_BATCH",
    "QUIESCE",
    "RESTORE",
    "Reply",
    "Request",
    "SNAPSHOT",
    "STATS",
    "STOP",
    "WorkerCrash",
    "WorkerError",
    "WorkerUnresponsive",
]
