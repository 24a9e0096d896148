"""WorkerRuntime — host-side orchestration of the partition workers.

The continuous engine (``executor="mp"``) keeps all *stream-global*
bookkeeping — watermarks, window assignment, session tracking, consumer
offsets — and translates each poll into partition-tagged ingest ops. This
runtime routes those ops to the worker process owning each partition, runs
one PROCESS_BATCH round trip per worker per poll (pipelined: send to all,
then collect), and merges the workers' fired windows back into the global
canonical order ``(window_end, window_start, pid, key_bytes)`` — the same
total order the inline executor fires in, which is what makes the two
executors bit-identical.

Failure model (exact, not at-least-once):

* every batch is journaled (per-worker ops + the watermark) before it is
  sent;
* every ``snapshot_every`` batches, all partitions are snapshotted through
  the StateMigrator spool (``wckpt_*`` atomic dirs) and the journal resets;
* when a worker crashes (SIGKILL, OOM) or hangs (stale heartbeat, batch
  deadline), its supervisor respawns it and the runtime replays: RESTORE
  from the latest checkpoint, re-run every journaled batch, then drop the
  first ``emitted`` outputs — the prefix the host already delivered.
  Per-worker firing is deterministic, so the replayed tail is exactly the
  current batch's contribution: zero lost, zero duplicated firings.

Rescale reuses the same spool: drain reply queues (in-flight batch
leftovers), QUIESCE everyone, then ``StateMigrator.handoff`` with
fetch = SNAPSHOT(release=True) from old owners and install = RESTORE into
(possibly freshly spawned) new owners, followed by a fresh checkpoint —
ownership changed, so the previous checkpoint is no longer a valid
restore target.

Owners are pilot slots; ``devices`` maps each to its device. How the
workers start follows from those devices (:func:`start_method`): forked
where none is a CUDA card — closures reach the workers by inheritance, as
in the JAX package — and spawned where one is, because a forked child
cannot use CUDA once the parent has. A spawned worker gets window_fn
pickled once, at :meth:`WorkerRuntime.start`; one that does not pickle (a
closure, a class defined inside a function, a processor holding a lock or
a CUDA tensor) is refused there with a ``TypeError`` naming it.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import time
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.failure import HeartbeatMonitor
from repro_torch.elastic.metrics import MetricsBus
from repro_torch.state.migrator import MigrationReport, StateMigrator
from repro_torch.state.partition import key_bytes
from repro_torch.state.store import PartitionedStateStore, serialize_partition
from repro_torch.streaming.dispatch import LatencyWindow
from repro_torch.workers.proto import (
    CONFIGURE,
    PROCESS_BATCH,
    QUIESCE,
    RESTORE,
    SNAPSHOT,
    BatchResult,
    WorkerCrash,
)
from repro_torch.workers.supervisor import WorkerSupervisor
from repro_torch.workers.worker import is_cuda


def start_method(devices: Sequence[Any]) -> str:
    """How the workers of owners on ``devices`` start: ``"spawn"`` where
    any is a CUDA card, else ``"fork"``."""
    return "spawn" if any(is_cuda(d) for d in devices) else "fork"


def _callable_name(fn: Any) -> str:
    return getattr(fn, "__qualname__", None) or repr(fn)


class WorkerRuntime:
    def __init__(
        self,
        store: PartitionedStateStore,
        window_fn: Callable[[Any, tuple, list], Any],
        *,
        migrator: StateMigrator,
        bus: MetricsBus | None = None,
        label: str | None = None,
        snapshot_every: int = 32,
        batch_timeout: float = 30.0,
        heartbeat_interval: float = 0.1,
        heartbeat_timeout: float = 2.0,
        max_restarts: int = 3,
        restart_backoff: float = 0.05,
        restart_backoff_cap: float = 2.0,
        devices: Mapping[Any, Any] | None = None,
    ):
        self.store = store
        self.window_fn = window_fn
        #: owner -> its device (an owner missing here is its own device)
        self.devices = dict(devices or {})
        self.migrator = migrator
        self.bus = bus
        self.label = label
        self.snapshot_every = max(int(snapshot_every), 1)
        self.batch_timeout = batch_timeout
        self.heartbeat_interval = heartbeat_interval
        #: a single window_fn call longer than this reads as a hang — size
        #: it above the worst-case per-window compute time
        self.heartbeat_timeout = heartbeat_timeout
        self.max_restarts = max(int(max_restarts), 1)
        #: supervisor respawn backoff (see WorkerSupervisor.respawn)
        self.restart_backoff = restart_backoff
        self.restart_backoff_cap = restart_backoff_cap
        self.monitor: HeartbeatMonitor | None = None
        self.buffered_windows = 0
        self._ctx = None
        self._sups: list[WorkerSupervisor] = []
        self._next_wid = 0
        #: batches since the last checkpoint: [(watermark, {wid: [op]})]
        self._journal: list[tuple[float, dict[int, list]]] = []
        #: outputs already delivered to the host since the last checkpoint,
        #: per worker — the replay-skip prefix
        self._emitted: dict[int, int] = {}
        self._ckpt: str | None = None
        self._ckpt_seq = 0
        self._since_ckpt = 0
        self._lat: dict[int, LatencyWindow] = {}
        self._lat_all = LatencyWindow()
        self._retired_restarts = 0  # from workers stopped at rescale/shutdown
        #: seconds from a crashed worker's respawn to its replay's end, per
        #: recovery
        self.recovery_seconds: list[float] = []
        self._retired_starts: list[float] = []
        #: what a worker gets as window_fn: the callable, or its pickle
        self._window_arg: Callable | bytes = window_fn
        self._started = False

    # -- lifecycle ------------------------------------------------------------

    def device_of(self, owner: Any) -> Any:
        return self.devices.get(owner, owner)

    def _use_start_method(self, owners: Sequence[Any]) -> None:
        """Pick the context for workers of ``owners``; a runtime that once
        spawns keeps spawning (window_fn pickled here, once)."""
        method = start_method([self.device_of(o) for o in owners])
        if self._ctx is not None and (method == "fork" or self._ctx.get_start_method() == method):
            return
        if method == "fork" and "fork" not in mp.get_all_start_methods():
            raise RuntimeError(
                'executor="mp" on owners without a CUDA card forks its workers '
                "(window_fn/key_fn closures reach them by inheritance): this "
                "platform cannot fork")
        if method == "spawn":
            try:
                self._window_arg = pickle.dumps(self.window_fn)
            except Exception as e:
                raise TypeError(
                    f"executor='mp' spawns the workers of owners on a CUDA card, and "
                    f"window_fn {_callable_name(self.window_fn)} does not pickle "
                    f"({type(e).__name__}: {e}); define it, and its class, at module "
                    "level, holding host values (no lock, no CUDA tensor)") from e
        self._ctx = mp.get_context(method)

    def start(self) -> "WorkerRuntime":
        self._use_start_method(self.store.owners)
        self.monitor = HeartbeatMonitor(self.heartbeat_interval,
                                        self.heartbeat_timeout)
        for owner in self.store.owners:
            self._spawn_for(owner, wait=False)
        for sup in self._sups:  # spawned workers start side by side
            if sup.cold:
                sup.await_start()
        for sup in self._sups:
            sup.request(CONFIGURE, {"pids": self._pids_of(sup)})
            # seed: hand any pre-existing host-side state to its worker (a
            # fresh stream's store is empty, so this is usually a no-op)
            seed = {
                pid: serialize_partition(self.store.partitions[pid])
                for pid in self._pids_of(sup)
                if self.store.partitions[pid].buffers
                or self.store.partitions[pid].records
            }
            if seed:
                sup.request(RESTORE, seed)
        self.checkpoint()  # wckpt_000001: RESTORE always has a target
        self._started = True
        self._publish_health()
        return self

    def shutdown(self) -> None:
        """Stop every worker (graceful STOP, then kill) and release the
        monitor's threads. Idempotent."""
        for sup in self._sups:
            self._retire(sup)
        self._sups = []
        if self.monitor is not None:
            self.monitor.close()
        self._started = False
        if self.bus is not None:
            self.bus.publish("workers.alive", 0, **self._labels())

    def _retire(self, sup: WorkerSupervisor) -> None:
        sup.stop()
        self._retired_restarts += sup.restarts
        self._retired_starts.extend(sup.start_seconds)

    def _spawn_for(self, owner: Any, wait: bool = True) -> WorkerSupervisor:
        sup = WorkerSupervisor(self._next_wid, owner, self._window_arg,
                               monitor=self.monitor, ctx=self._ctx,
                               batch_timeout=self.batch_timeout,
                               restart_backoff=self.restart_backoff,
                               restart_backoff_cap=self.restart_backoff_cap,
                               device=self.device_of(owner))
        self._next_wid += 1
        sup.spawn(wait=wait)
        self._sups.append(sup)
        self._emitted[sup.worker_id] = 0
        self._lat[sup.worker_id] = LatencyWindow()
        return sup

    def _sup_for(self, owner: Any) -> WorkerSupervisor | None:
        for sup in self._sups:
            if sup.owner == owner:
                return sup
        return None

    def _pids_of(self, sup: WorkerSupervisor) -> list[int]:
        return [pid for pid, o in self.store.assignment.items()
                if o == sup.owner]

    @property
    def n_workers(self) -> int:
        return len(self._sups)

    @property
    def restarts(self) -> int:
        return self._retired_restarts + sum(sup.restarts for sup in self._sups)

    @property
    def start_seconds(self) -> list[float]:
        """Every spawned incarnation's start seconds (Process.start() to
        its first beat), retired workers' included; empty when forked."""
        return self._retired_starts + [t for sup in self._sups for t in sup.start_seconds]

    # -- the per-poll data path ------------------------------------------------

    def submit(self, ops: Sequence[tuple], watermark: float) -> list[tuple]:
        """Apply one poll's ingest ops and fire everything the watermark
        closed. Returns ``[(key, window, output), ...]`` in the global
        canonical order. Crashed/hung workers are recovered transparently;
        a deterministic user-code error (WorkerError) propagates like an
        inline window_fn raise would.
        """
        by_wid: dict[int, list] = {sup.worker_id: [] for sup in self._sups}
        sup_of_pid: dict[int, WorkerSupervisor] = {}
        for op in ops:
            pid = op[1]
            sup = sup_of_pid.get(pid)
            if sup is None:
                sup = sup_of_pid[pid] = self._sup_for(self.store.assignment[pid])
            by_wid[sup.worker_id].append(op)
        # journal BEFORE sending: a crash mid-batch replays this entry too
        self._journal.append((watermark, by_wid))

        # pipelined round: every worker gets every batch (a watermark-only
        # batch still fires its buffered windows), then collect in order
        seqs = [
            (sup, sup.send(PROCESS_BATCH,
                           {"ops": by_wid[sup.worker_id],
                            "watermark": watermark}))
            for sup in self._sups
        ]
        fired: list[tuple] = []  # (pid, key, w, out) across workers
        buffered = 0
        for sup, seq in seqs:
            try:
                result: BatchResult = sup.recv(seq)
                outs = result.fired
                buffered += result.buffered_windows
                self._record_latency(sup.worker_id, result.elapsed_ms)
                self._emitted[sup.worker_id] += len(outs)
            except WorkerCrash:
                outs, bw = self._recover(sup)
                buffered += bw
            fired.extend(outs)
        self.buffered_windows = buffered
        self._since_ckpt += 1
        if self._since_ckpt >= self.snapshot_every:
            self.checkpoint()
        # merge back into the inline executor's firing order: each worker
        # fired its pids in canonical order, the global sort unifies them
        fired.sort(key=lambda f: (f[2][1], f[2][0], f[0], key_bytes(f[1])))
        return [(key, w, out) for _pid, key, w, out in fired]

    def _record_latency(self, wid: int, elapsed_ms: float) -> None:
        dt = elapsed_ms / 1e3  # seconds, same unit as stream.latency_*
        self._lat[wid].record(dt)
        self._lat_all.record(dt)

    # -- crash / hang recovery -------------------------------------------------

    def _recover(self, sup: WorkerSupervisor) -> tuple[list, int]:
        """Respawn ``sup`` and rebuild its partitions exactly: checkpoint
        RESTORE + full journal replay, then skip the output prefix the host
        already delivered. Returns (undelivered tail, buffered windows) —
        the tail is precisely the in-flight batch's contribution, because
        every earlier journaled batch was fully delivered before the next
        was submitted. ``max_restarts`` bounds attempts *per recovery* (a
        worker that also dies during replay)."""
        last: WorkerCrash | None = None
        t0 = time.monotonic()
        for _attempt in range(self.max_restarts):
            sup.respawn()
            self._publish_health()
            try:
                sup.request(CONFIGURE, {"pids": self._pids_of(sup)})
                payloads = self._checkpoint_for(sup)
                if payloads:
                    sup.request(RESTORE, payloads)
                replay: list = []
                buffered = 0
                for wm, by_wid in self._journal:
                    r: BatchResult = sup.request(
                        PROCESS_BATCH,
                        {"ops": by_wid.get(sup.worker_id, []),
                         "watermark": wm})
                    replay.extend(r.fired)
                    buffered = r.buffered_windows
                tail = replay[self._emitted[sup.worker_id]:]
                self._emitted[sup.worker_id] = len(replay)
                self.recovery_seconds.append(time.monotonic() - t0)
                return tail, buffered
            except WorkerCrash as e:  # died again mid-recovery: retry
                last = e
        raise WorkerCrash(
            f"worker {sup.worker_id} failed to recover after "
            f"{self.max_restarts} restarts") from last

    def _checkpoint_for(self, sup: WorkerSupervisor) -> dict[int, bytes]:
        if self._ckpt is None:
            return {}
        return self.migrator.read_spool(self._ckpt, self._pids_of(sup))

    # -- checkpoints -----------------------------------------------------------

    def checkpoint(self) -> str:
        """Spool a consistent cut of *all* partitions (runs between
        batches, so per-worker snapshots compose into one global state),
        then reset the journal and the emitted counters."""
        payloads: dict[int, bytes] = {}
        for sup in self._sups:
            req = {"pids": self._pids_of(sup), "release": False}
            try:
                snap = sup.request(SNAPSHOT, req)
            except WorkerCrash:
                # rebuild from the previous checkpoint + journal, then the
                # snapshot reflects the same post-batch state
                self._recover(sup)
                snap = sup.request(SNAPSHOT, req)
            payloads.update(snap)
        self._ckpt_seq += 1
        self._ckpt = self.migrator.write_spool(
            payloads, f"wckpt_{self._ckpt_seq:06d}")
        self.migrator.gc_checkpoints()
        self._journal.clear()
        self._emitted = {sup.worker_id: 0 for sup in self._sups}
        self._since_ckpt = 0
        return self._ckpt

    # -- rescale ---------------------------------------------------------------

    def rescale(self, new_owners: Sequence[Any],
                devices: Mapping[Any, Any] | None = None) -> MigrationReport:
        """Re-home partitions onto a changed owner set, moving state
        *between worker processes* through the migrator's spool
        (``devices``: the new owners' devices). The caller
        (ContinuousStream.rescale) holds the stream's state lock, so no
        batch is concurrently in flight — but reply queues may still hold
        leftovers of an abandoned batch, hence the drain before QUIESCE."""
        self.devices.update(devices or {})
        for sup in self._sups:
            sup.channel.drain()
        for sup in self._sups:
            try:
                sup.request(QUIESCE)
            except WorkerCrash:
                self._recover(sup)
                sup.request(QUIESCE)

        def fetch(pids: Sequence[int]) -> dict[int, bytes]:
            out: dict[int, bytes] = {}
            by_sup: dict[int, list[int]] = {}
            for pid in pids:  # group by *current* owner
                sup = self._sup_for(self.store.assignment[pid])
                by_sup.setdefault(sup.worker_id, []).append(pid)
            for sup in self._sups:
                pids_here = by_sup.get(sup.worker_id)
                if pids_here:
                    out.update(sup.request(
                        SNAPSHOT, {"pids": pids_here, "release": True}))
            return out

        def install(assignment: Mapping[int, Any],
                    payloads: Mapping[int, bytes]) -> int:
            self.store.assignment = dict(assignment)
            live_owners = self.store.owners
            keep: list[WorkerSupervisor] = []
            for sup in self._sups:  # owners that dropped out take nothing with them
                if any(o == sup.owner for o in live_owners):
                    keep.append(sup)
                else:
                    self._retire(sup)
                    self._emitted.pop(sup.worker_id, None)
            self._sups = keep
            new = [o for o in live_owners if self._sup_for(o) is None]
            self._use_start_method(new)
            fresh = [self._spawn_for(owner, wait=False) for owner in new]
            for sup in fresh:  # new owners get fresh processes
                if sup.cold:
                    sup.await_start()
                sup.request(CONFIGURE, {"pids": []})
            moved_records = 0
            by_sup: dict[int, tuple[WorkerSupervisor, dict]] = {}
            for pid, data in payloads.items():
                sup = self._sup_for(self.store.assignment[pid])
                by_sup.setdefault(sup.worker_id, (sup, {}))[1][pid] = data
            for sup, chunk in by_sup.values():
                counts = sup.request(RESTORE, chunk)
                moved_records += sum(counts.values())
            return moved_records

        report = self.migrator.handoff(self.store, new_owners, fetch, install)
        # ownership changed: the previous checkpoint no longer matches the
        # assignment, so cut a fresh one before any batch runs
        self.checkpoint()
        self._publish_health()
        return report

    # -- gauges ----------------------------------------------------------------

    def _labels(self) -> dict:
        return {} if self.label is None else {"stream": self.label}

    def _publish_health(self) -> None:
        if self.bus is None:
            return
        labels = self._labels()
        self.bus.publish("workers.alive",
                         sum(1 for sup in self._sups if sup.alive()), **labels)
        self.bus.publish("workers.restarts", self.restarts, **labels)
        if self._sups:
            self.bus.publish(
                "workers.restart_backoff_ms",
                max(sup.last_backoff_s for sup in self._sups) * 1e3, **labels)

    def publish(self) -> None:
        """Per-worker + aggregate latency quantiles and worker health —
        called from the engine's publish path. Per-worker samples go first
        so ``latest_by_label(..., "stream")`` resolves to the aggregate."""
        if self.bus is None:
            return
        labels = self._labels()
        for sup in self._sups:
            lw = self._lat.get(sup.worker_id)
            if lw is None or len(lw) == 0:
                continue
            wl = {**labels, "worker": str(sup.worker_id)}
            self.bus.publish("stream.latency_p50", lw.p50, **wl)
            self.bus.publish("stream.latency_p99", lw.p99, **wl)
        if len(self._lat_all):
            self.bus.publish("stream.latency_p50", self._lat_all.p50, **labels)
            self.bus.publish("stream.latency_p99", self._lat_all.p99, **labels)
        self._publish_health()
