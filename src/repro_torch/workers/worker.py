"""PartitionWorker — the child-process side of the runtime.

One worker owns a subset of the stream's state partitions and runs their
entire mutate-and-fire path: ingest ops are applied to real
:class:`~repro_torch.state.store.StatePartition` objects living in *this*
process, and closed windows fire through the same module-level helpers
(:func:`ready_buffers`, :func:`merge_session_into`) the in-process store
uses — so a worker fires its partitions in exactly the order the inline
executor would, restricted to its own pids. The host merges workers'
outputs back into the global canonical order.

The worker stamps a shared heartbeat (``mp.Value('d')``) once per loop
iteration *and once per window_fn call*: a slow-but-alive worker keeps
beating mid-batch, while one genuinely wedged inside user code goes stale
and is flagged by the supervisor's HeartbeatMonitor.

How a worker starts depends on its owner's device (see
:func:`repro_torch.workers.runtime.start_method`):

* **forked** (no owner on a CUDA card): window_fn/key_fn closures arrive by
  inheritance, as in the JAX package. The child's first act is
  ``torch.set_num_threads(1)``: a forked child that enters the parent's
  OpenMP pool hangs on its first parallel torch operation.
* **spawned** (an owner on a CUDA card; a forked child cannot use CUDA
  once the parent has initialised it): window_fn arrives pickled. Before
  its first beat the child creates its CUDA context, loads every kernel
  library the parent built (it never builds one: a missing library is an
  error) and unpickles window_fn; the supervisor watches it only from that
  beat.

Queue *messages* are pickled either way — ops, serialized partitions, and
window outputs must be picklable, and outputs must be host values: a CUDA
tensor on a queue would travel as an IPC handle tied to this process, so
the worker refuses it.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Callable

import torch

from repro_torch.state.store import (
    StatePartition,
    deserialize_partition,
    merge_session_into,
    ready_buffers,
    serialize_partition,
)
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
)

#: the seq of the reply a worker sends when its start-up fails (every
#: command's seq is >= 1, so no request can mistake it for its answer)
START_FAILED_SEQ = 0


def is_cuda(device: Any) -> bool:
    """True for a CUDA ``torch.device`` (or its string form)."""
    return str(getattr(device, "type", device)).startswith("cuda")


def cuda_tensor_in(out: Any) -> bool:
    """Whether a window output holds a CUDA tensor (in a tuple, list or
    dict, at any depth)."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(cuda_tensor_in(x) for x in out)
    if isinstance(out, dict):
        return any(cuda_tensor_in(x) for x in out.values())
    return False


class PartitionWorker:
    """Run loop + command handlers; constructed in the parent, executed in
    the child (``run`` is the Process target). ``window_fn`` is the
    callable itself (forked workers) or its pickle (spawned ones)."""

    def __init__(self, worker_id: int, requests, replies, beat,
                 window_fn: Callable[[Any, tuple, list], Any] | bytes,
                 poll_interval: float = 0.05, device: Any = None):
        self.worker_id = worker_id
        self.requests = requests
        self.replies = replies
        self.beat = beat
        self.window_fn = window_fn
        self.poll_interval = poll_interval
        self.device = device
        self.parts: dict[int, StatePartition] = {}
        self.sync_fn: Callable[[], None] | None = None

    # -- child start-up -------------------------------------------------------

    def _start(self) -> None:
        from repro_torch.kernels import _build

        _build.forbid_builds()
        if isinstance(self.window_fn, bytes):  # spawned
            if is_cuda(self.device):
                device = torch.device(self.device)
                torch.cuda.set_device(device)
                torch.zeros(1, device=device)  # the context, before the first beat
                _build.load_all()
            self.window_fn = pickle.loads(self.window_fn)
        else:  # forked: stay out of the parent's OpenMP pool
            torch.set_num_threads(1)
        # same auto-wiring as ContinuousStream: a bound window_fn's owner
        # may expose a sync() barrier for in-flight device work
        owner = getattr(self.window_fn, "__self__", None)
        self.sync_fn = getattr(owner, "sync", None) if owner is not None else None

    # -- child main loop ------------------------------------------------------

    def run(self) -> None:
        import queue as _queue
        try:
            self._start()
        except BaseException as e:  # the supervisor reads it at its start deadline
            self.replies.put(Reply(START_FAILED_SEQ, False, None,
                                   f"start-up: {type(e).__name__}: {e}"))
            raise
        while True:
            self.beat.value = time.monotonic()
            try:
                req: Request = self.requests.get(timeout=self.poll_interval)
            except _queue.Empty:
                continue
            except (EOFError, OSError):  # parent went away: nothing to serve
                return
            self.beat.value = time.monotonic()
            try:
                result = self._dispatch(req)
                self.replies.put(Reply(req.seq, True, result))
            except BaseException as e:  # user-code error -> host raises WorkerError
                self.replies.put(Reply(req.seq, False, None,
                                       f"{type(e).__name__}: {e}"))
            if req.cmd == STOP:
                return

    def _dispatch(self, req: Request):
        cmd, p = req.cmd, req.payload
        if cmd == PROCESS_BATCH:
            return self._process_batch(p["ops"], p["watermark"])
        if cmd == CONFIGURE:
            self.parts = {pid: StatePartition(pid) for pid in p["pids"]}
            return sorted(self.parts)
        if cmd == QUIESCE:
            if self.sync_fn is not None:
                self.sync_fn()
            return "idle"
        if cmd == SNAPSHOT:
            return self._snapshot(p.get("pids"), p.get("release", False))
        if cmd == RESTORE:
            return self._restore(p)
        if cmd == STATS:
            return self._stats()
        if cmd == STOP:
            return "bye"
        raise ValueError(f"unknown command {cmd!r}")

    # -- handlers -------------------------------------------------------------

    def _process_batch(self, ops: list, watermark: float) -> BatchResult:
        t0 = time.perf_counter()
        for op in ops:
            tag, pid = op[0], op[1]
            part = self.parts[pid]
            if tag == OP_APPEND:
                _, _, key, w, msg = op
                part.buffers.setdefault((key, w), []).append(msg)
            elif tag == OP_OBSERVE:
                part.records += 1
                if op[2] > part.max_event_time:
                    part.max_event_time = op[2]
            elif tag == OP_MERGE:
                merge_session_into(part, op[2], op[3])
            elif tag == OP_LATE:
                part.late_records += 1
            else:
                raise ValueError(f"unknown op tag {tag!r}")
        # fire in the canonical order, restricted to this worker's pids —
        # the host's global merge then reproduces the inline firing order
        fired = []
        for key, w, pid in ready_buffers(self.parts.values(), watermark):
            msgs = self.parts[pid].buffers.pop((key, w))
            self.beat.value = time.monotonic()  # beat per window: slow != wedged
            out = self.window_fn(key, w, msgs)
            if cuda_tensor_in(out):
                raise TypeError(
                    f"window ({key!r}, {w}) returned a CUDA tensor: an mp worker's "
                    "outputs must be host values (numpy or Python)")
            fired.append((pid, key, w, out))
        buffered = sum(len(part.buffers) for part in self.parts.values())
        return BatchResult(fired, buffered, (time.perf_counter() - t0) * 1e3)

    def _snapshot(self, pids, release: bool) -> dict[int, bytes]:
        if pids is None:
            pids = sorted(self.parts)
        out = {pid: serialize_partition(self.parts[pid])
               for pid in pids if pid in self.parts}
        if release:  # migration-out: the partition now lives elsewhere
            for pid in out:
                del self.parts[pid]
        return out

    def _restore(self, payloads: dict[int, bytes]) -> dict[int, int]:
        counts = {}
        for pid, data in payloads.items():
            part = deserialize_partition(data)
            assert part.pid == pid
            self.parts[pid] = part
            counts[pid] = part.buffered_records
        return counts

    def _stats(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "pids": sorted(self.parts),
            "records": sum(p.records for p in self.parts.values()),
            "late_records": sum(p.late_records for p in self.parts.values()),
            "buffered_windows": sum(len(p.buffers) for p in self.parts.values()),
            "buffered_records": sum(p.buffered_records for p in self.parts.values()),
        }
