"""The multiprocess partition execution runtime.

Real process-level parallelism and failure isolation for the continuous
engine's keyed window state: each state partition's ingest/firing runs in
the worker process owning it (``ContinuousStream(executor="mp")``), with a
supervisor per worker detecting crash/hang and restarting with exact state
recovery from the StateMigrator spool. Workers of owners on a CUDA card
are spawned (window_fn pickled), the others forked (:func:`start_method`).
"""
from repro_torch.workers.channel import WorkerChannel
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
from repro_torch.workers.runtime import WorkerRuntime, start_method
from repro_torch.workers.supervisor import WorkerSupervisor
from repro_torch.workers.worker import PartitionWorker

__all__ = [
    "BatchResult",
    "CONFIGURE",
    "OP_APPEND",
    "OP_LATE",
    "OP_MERGE",
    "OP_OBSERVE",
    "PROCESS_BATCH",
    "PartitionWorker",
    "QUIESCE",
    "RESTORE",
    "Reply",
    "Request",
    "SNAPSHOT",
    "STATS",
    "STOP",
    "WorkerChannel",
    "WorkerCrash",
    "WorkerError",
    "WorkerRuntime",
    "WorkerSupervisor",
    "WorkerUnresponsive",
    "start_method",
]
