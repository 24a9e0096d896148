"""Continuous (per-record) streaming engine — the Flink analog.

Processes records as they arrive with *event-time* windowing: records are
assigned to tumbling/sliding/session windows by their timestamps, buffered
per (key, window), and fired when the watermark (max event time − allowed
lateness) passes the window end. Late records are counted and dropped
(paper §2.1: "native stream engines ... more advanced windowing").

Keyed window state lives in a :class:`repro_torch.state.PartitionedStateStore`
(fixed ring of state partitions, consistent key hashing), so a rescale —
extension pilots folding in or dropping out — migrates only the partitions
whose owner changed: ``rescale()`` quiesces the record loop (state lock +
``sync_fn`` barrier), runs the :class:`repro_torch.state.StateMigrator`
(snapshot -> reassign -> restore, atomic spool on disk), then fires the
``on_rescale`` hook and resumes.

The owners are pilot *slots*, the device pool's entry indices
(``Lease.slots``), not ``torch.device`` values: on one H100, N slots are N
equal ``cuda:0`` devices, and owners compared by value would collapse into
one, so a grow would move no partition. With slots, N slots of one card
move exactly the partitions the JAX package moves between N distinct
devices.

Window functions run on the record-loop thread. One that launches device
work must return host values (or go through ``async_emit``, whose CUDA
events land the work before delivery); exactly-once replay needs its
outputs to be a pure function of the window's records.

``executor="mp"`` runs each owner's partitions in a worker process
(:mod:`repro_torch.workers`); the owners' devices decide whether the
workers are forked or spawned. On ``transport="shm"`` the engine always
copies frames out of the ring: it buffers records in window state far past
the reclaim floor, where views would be unsound.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Callable

from repro_torch.broker.cluster import BrokerCluster
from repro_torch.broker.consumer import Consumer, ConsumerGroup, Message
from repro_torch.core.compute_unit import ComputeUnit
from repro_torch.core.plugin import Lease, ManagerPlugin, register_plugin
from repro_torch.elastic.metrics import ContinuousStats, MetricsBus
from repro_torch.state import (
    DEFAULT_PARTITIONS,
    MigrationReport,
    PartitionedStateStore,
    StateMigrator,
)
from repro_torch.state.store import StatePartition, deserialize_partition, serialize_partition
from repro_torch.streaming.dispatch import AsyncWindow
from repro_torch.streaming.windows import SessionWindow, WatermarkTracker
from repro_torch.workers.proto import OP_APPEND, OP_LATE, OP_MERGE, OP_OBSERVE, SNAPSHOT

EXECUTORS = ("inline", "mp")


class ContinuousStream:
    """One (topic -> keyed event-time windows -> window_fn) pipeline.

    ``executor`` selects where partition state mutates and windows fire:

    * ``"inline"`` (default) — in this process, in the record-loop thread.
    * ``"mp"`` — each partition's ingest/firing runs in the worker process
      owning it (:class:`repro_torch.workers.WorkerRuntime`): real
      parallelism across owners, failure isolation, and supervised restart
      with exact state recovery. Window outputs and message values must be
      picklable, and outputs host values; where an owner's device is a
      CUDA card the workers are spawned, and window_fn must pickle too.
      Firing order and results are bit-identical to inline.

    ``worker_options`` forwards kwargs to :class:`WorkerRuntime`
    (``snapshot_every``, ``batch_timeout``, ``heartbeat_timeout``,
    ``max_restarts``, ...). ``devices`` are the owners' devices, in the
    order of ``owners`` (default: each owner is its own device).
    """

    def __init__(
        self,
        cluster: BrokerCluster,
        topic: str,
        *,
        group: str,
        assigner,
        window_fn: Callable[[Any, tuple, list], Any],
        key_fn: Callable[[Message], Any] = lambda m: None,
        allowed_lateness: float = 0.0,
        emit: Callable[[Any], None] | None = None,
        metrics: MetricsBus | None = None,
        sync_fn: Callable[[], None] | None = None,
        on_rescale: Callable[[Any], Any] | None = None,
        metrics_label: str | None = None,
        n_partitions: int = DEFAULT_PARTITIONS,
        owners: list | None = None,
        state_dir: str | None = None,
        executor: str = "inline",
        checkpoint_every: int = 0,
        transport: str | None = None,
        async_emit: int = 0,
        worker_options: dict | None = None,
        devices: list | None = None,
    ):
        if executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r} (expected one of {EXECUTORS})")
        self.cluster = cluster
        self.topic = topic
        #: accepted for spec symmetry with MicroBatchStream; the continuous
        #: engine always copies shm frames out (it buffers records in window
        #: state far past the reclaim floor — views would be unsound), so
        #: "shm" changes the producer side only
        self.transport = transport
        self.group = ConsumerGroup(cluster, group, topic)
        self.consumer = Consumer(cluster, self.group, member_id=f"{group}-cont")
        self.assigner = assigner
        self.window_fn = window_fn
        self.key_fn = key_fn
        self.emit = emit or (lambda out: None)
        self.watermarks = WatermarkTracker(allowed_lateness)
        self.stats = ContinuousStats()
        self.metrics = metrics
        #: bus label (defaults to topic; see MicroBatchStream.metrics_label)
        self.metrics_label = metrics_label or topic
        # the barrier that lands a processor's in-flight device work before
        # state escapes the loop (rescale, stop) — auto-wired from a bound
        # window_fn's ``sync`` method, same contract as MicroBatchStream
        owner = getattr(window_fn, "__self__", None)
        if sync_fn is None and owner is not None:
            sync_fn = getattr(owner, "sync", None)
        self.sync_fn = sync_fn
        # resharding hook, constructor kwarg or post-hoc attribute (both work)
        self.on_rescale: Callable[[Any], Any] | None = on_rescale
        #: partitioned keyed window state: (key, window) buffers + counters
        self.store = PartitionedStateStore(n_partitions, owners=owners)
        self.migrator = StateMigrator(state_dir, bus=metrics, label=self.metrics_label)
        self.executor = executor
        #: owner -> device, what the mp runtime places its workers by
        self.owner_devices = dict(zip(owners, devices)) if owners and devices else {}
        #: the multiprocess partition runtime (mp executor only; spawned by
        #: ``start()`` so a never-started stream costs no processes)
        self.runtime = None
        self._worker_options = dict(worker_options or {})
        #: report of the most recent rescale migration (None before any)
        self.last_migration: MigrationReport | None = None
        #: records between crash checkpoints (``sckpt_*`` spools holding all
        #: partitions + stream-global meta); 0 disables them. Required for
        #: :meth:`recover` to resume from mid-stream instead of offset 0.
        self.checkpoint_every = int(checkpoint_every)
        #: successful :meth:`recover` calls / latency of the last one
        self.recoveries = 0
        self.last_recovery_ms: float | None = None
        self._since_ckpt = 0
        self._ckpt_seq = 0
        #: consumer positions just past the last record the state holds:
        #: the checkpoint cut. The loop polls outside the state lock, so the
        #: consumer's own positions may already count a batch that is not
        #: ingested yet; a cut taken from them would skip it on replay.
        self._cut: dict[int, int] = {}
        # windows the pre-crash incarnation already emitted past the restored
        # checkpoint: the replay re-fires them, the emit is suppressed, and
        # fired_windows is not re-counted — zero lost, zero duplicated
        self._skip_emits = 0
        #: emit double-buffer depth: > 0 holds up to that many fired-window
        #: outputs in flight (device work pending) and delivers them once
        #: the device catches up, so downstream routing overlaps compute.
        #: ``fired_windows`` counts *deliveries*, which keeps the
        #: exactly-once replay arithmetic intact — a crash discards the
        #: buffer and the replay re-fires its windows. 0 = synchronous.
        self.async_emit = max(int(async_emit), 0)
        self._emit_window = AsyncWindow(self.async_emit) if self.async_emit else None
        # quiesce lock: the record loop holds it around ingest+fire, and
        # rescale() takes it to snapshot/migrate — an in-flight process()
        # call can never race a partition hand-off
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fired = threading.Condition()
        self._error: BaseException | None = None
        self._last_publish = 0.0

    def _ingest(self, msg: Message) -> None:
        ts = msg.timestamp
        key = self.key_fn(msg)
        if self.watermarks.is_late(ts):
            self.stats.late_records += 1
            self.store.record_late(key)
            return
        self.watermarks.observe(ts)
        self.store.observe(key, ts)
        if isinstance(self.assigner, SessionWindow):
            windows = self.assigner.assign(ts, key)
            # session merge: fold any overlapping buffered window of this
            # key into the merged one (store-side, stays within the key's
            # partition)
            self.store.merge_session(key, windows[0])
        else:
            windows = self.assigner.assign(ts)
        for w in windows:
            self.store.append(key, w, msg)
        self.stats.records += 1
        self.stats.per_record_latency.append(time.time() - ts)

    def _deliver(self, out: Any) -> None:
        """Deliver one fired window's output — unless it is part of the
        replay prefix a recovery re-fires (already emitted pre-crash)."""
        if self._skip_emits > 0:
            self._skip_emits -= 1
            return
        self.emit(out)
        self.stats.fired_windows += 1

    def _emit_fired(self, out: Any) -> None:
        """Route one fired output: straight downstream (synchronous mode)
        or through the emit double-buffer, delivering whatever the buffer
        retires to stay within its depth."""
        if self._emit_window is None:
            self._deliver(out)
            return
        for done, _meta, _dt in self._emit_window.push(out):
            self._deliver(done)

    def _drain_emits(self) -> None:
        """Land and deliver every buffered emit (checkpoint/rescale/stop
        barrier — and the idle-poll flush, so latent outputs never sit in
        the buffer while the stream is starved). Caller holds the state
        lock or owns a quiesced stream."""
        if self._emit_window is None:
            return
        done = self._emit_window.sync()
        for out, _meta, _dt in done:
            self._deliver(out)
        if done:
            with self._fired:
                self._fired.notify_all()

    def _fire_ready(self) -> None:
        wm = self.watermarks.watermark
        fired = self.store.pop_ready(wm)
        for key, w, msgs in fired:
            out = self.window_fn(key, w, msgs)
            self._emit_fired(out)
        if fired:
            if isinstance(self.assigner, SessionWindow):
                # prune closed sessions from the assigner alongside their
                # buffers — per-key session lists would otherwise grow for
                # the lifetime of the stream
                self.assigner.close_before(wm)
            with self._fired:
                self._fired.notify_all()

    # -- mp executor: translate ingest into partition-tagged ops ---------------

    def _ingest_ops(self, msgs: list[Message]) -> list[tuple]:
        """The host half of mp ingest: watermark tracking, key routing,
        window assignment and session bookkeeping stay here (stream-global
        state); the per-partition mutations ship to the owner workers as
        ops. Mirrors :meth:`_ingest` exactly — late handling, observe-once
        semantics, merge-before-append ordering."""
        ops: list[tuple] = []
        for msg in msgs:
            ts = msg.timestamp
            key = self.key_fn(msg)
            pid = self.store.partition_of(key)
            if self.watermarks.is_late(ts):
                self.stats.late_records += 1
                ops.append((OP_LATE, pid))
                continue
            self.watermarks.observe(ts)
            ops.append((OP_OBSERVE, pid, ts))
            if isinstance(self.assigner, SessionWindow):
                windows = self.assigner.assign(ts, key)
                ops.append((OP_MERGE, pid, key, windows[0]))
            else:
                windows = self.assigner.assign(ts)
            for w in windows:
                ops.append((OP_APPEND, pid, key, w, msg))
            self.stats.records += 1
            self.stats.per_record_latency.append(time.time() - ts)
        return ops

    def _process_mp(self, msgs: list[Message]) -> None:
        ops = self._ingest_ops(msgs)
        wm = self.watermarks.watermark
        fired = self.runtime.submit(ops, wm)
        for _key, _w, out in fired:
            self._emit_fired(out)
        if fired:
            if isinstance(self.assigner, SessionWindow):
                self.assigner.close_before(wm)
            with self._fired:
                self._fired.notify_all()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                msgs = self.consumer.poll(max_records=256, timeout=0.05)
                t0 = time.monotonic()
                with self._state_lock:
                    if self.runtime is not None:
                        # empty poll: watermark can't have advanced, so
                        # there is nothing to fire — skip the round trip
                        if msgs:
                            self._process_mp(msgs)
                    else:
                        for m in msgs:
                            self._ingest(m)
                        self._fire_ready()
                    self._cut = self.consumer.positions()
                    if not msgs:
                        # quiet round: no new firings are coming, so land
                        # anything the emit double-buffer still holds
                        self._drain_emits()
                    if msgs and self.checkpoint_every:
                        self._since_ckpt += len(msgs)
                        if self._since_ckpt >= self.checkpoint_every:
                            self._checkpoint_locked()
                if msgs:
                    self.consumer.commit()
                    if self.metrics is not None:
                        self._publish(len(msgs), time.monotonic() - t0)
                elif self.metrics is not None:
                    self._publish_idle()
            except BaseException as e:
                self._error = e
                break

    def _publish_idle(self) -> None:
        # zero the throughput gauge and refresh lag while starved so
        # burst-time values don't stay latched on the bus
        now = time.monotonic()
        if now - self._last_publish < 0.5:
            return
        self._last_publish = now
        self.metrics.publish("stream.records_per_sec", 0.0, stream=self.metrics_label)
        self.metrics.publish("stream.lag", sum(
            self.cluster.lag(self.group.group, self.topic).values()),
            stream=self.metrics_label)

    def _publish(self, n: int, dt: float) -> None:
        bus, labels = self.metrics, {"stream": self.metrics_label}
        self._last_publish = time.monotonic()
        bus.publish("stream.records", self.stats.records, **labels)
        bus.publish("stream.records_per_sec", n / dt if dt > 0 else 0.0, **labels)
        bus.publish("stream.fired_windows", self.stats.fired_windows, **labels)
        bus.publish("stream.late_records", self.stats.late_records, **labels)
        buffered = (self.runtime.buffered_windows if self.runtime is not None
                    else self.store.buffered_windows)
        bus.publish("stream.buffered_windows", buffered, **labels)
        if self._emit_window is not None:
            bus.publish("stream.emit_inflight", self._emit_window.in_flight,
                        **labels)
        bus.publish("stream.lag", sum(
            self.cluster.lag(self.group.group, self.topic).values()), **labels)
        if self.runtime is not None:
            # workers.alive / workers.restarts / per-worker latency_p50/p99
            self.runtime.publish()

    def start(self) -> "ContinuousStream":
        if self.executor == "mp" and self.runtime is None:
            # imported here: the runtime's imports reach repro_torch.core,
            # whose package imports this module
            from repro_torch.workers.runtime import WorkerRuntime

            self.runtime = WorkerRuntime(
                self.store, self.window_fn, migrator=self.migrator,
                bus=self.metrics, label=self.metrics_label,
                devices=self.owner_devices, **self._worker_options).start()
        if self.checkpoint_every:
            # pin the shm reclaim floor to the replay horizon from the very
            # first record: commits advance past records a crash would
            # replay, and replaying into reclaimed ring slots is an error.
            # Prefer the consumer's live positions — after recover() they
            # hold the checkpoint cut, which sits *behind* committed — and
            # fall back to committed for a fresh start.
            n = self.cluster.topic(self.topic).n_partitions
            pos = self.consumer.positions()
            self._cut = {
                p: pos.get(p, self.cluster.committed(
                    self.group.group, self.topic, p))
                for p in range(n)}
            self._pin_replay_floor(self._cut)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _pin_replay_floor(self, positions: dict[int, int]) -> None:
        set_floor = getattr(self.cluster, "set_replay_floor", None)
        if set_floor is not None and positions:
            set_floor(self.group.group, self.topic, positions)

    def await_windows(self, n: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        with self._fired:
            while self.stats.fired_windows < n:
                if self._error:
                    raise self._error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"{self.stats.fired_windows}/{n} windows fired")
                self._fired.wait(min(remaining, 0.2))

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self.sync_fn is not None:  # land in-flight device work
            self.sync_fn()
        self.consumer.release_frames()  # drop views pinning ring slots
        # cleanup under the state lock so the spool is never yanked from
        # under an in-flight rescale — but timed, so a wedged window_fn
        # (loop thread outliving the join above) cannot hang teardown;
        # worst case the tempdir outlives us, not a correctness loss
        if self._state_lock.acquire(timeout=5):
            try:
                self._drain_emits()  # deliver buffered outputs before teardown
                if self.runtime is not None:
                    self.runtime.shutdown()
                self.migrator.cleanup()
            finally:
                self._state_lock.release()
        elif self.runtime is not None:
            # wedged loop thread: still reap the worker processes (they are
            # daemons, but an explicit kill frees their queues now)
            self.runtime.shutdown()
        if self._error:
            raise self._error

    # -- crash / recovery (repro_torch.faults) ------------------------------------

    def _checkpoint_locked(self) -> None:
        """Spool a consistent cut of the whole stream — every state
        partition plus the stream-global meta a restart cannot rederive
        (consumer positions, watermark, counters, session assigner state).
        Caller holds ``_state_lock``; positions are the cut (``_cut``: just
        past the last ingested batch, not a batch the loop has polled but
        not ingested), so restoring the spool and seeking to its positions
        replays nothing twice and skips nothing."""
        # fired-but-undelivered outputs must go downstream before the cut:
        # their windows were already popped from the store and their records
        # sit behind the checkpoint positions, so a crash after this spool
        # would otherwise lose them (they would never re-fire)
        self._drain_emits()
        if self.runtime is not None:
            payloads: dict[int, bytes] = {}
            for sup in self.runtime._sups:
                payloads.update(sup.request(
                    SNAPSHOT,
                    {"pids": self.runtime._pids_of(sup), "release": False}))
        else:
            payloads = {pid: serialize_partition(part)
                        for pid, part in self.store.partitions.items()}
        meta = pickle.dumps({
            "positions": dict(self._cut),
            "max_ts": self.watermarks._max_ts,
            "records": self.stats.records,
            "late": self.stats.late_records,
            "fired": self.stats.fired_windows,
            "sessions": (dict(self.assigner._sessions)
                         if isinstance(self.assigner, SessionWindow) else None),
            "assignment": dict(self.store.assignment),
        })
        self._ckpt_seq += 1
        self.migrator.write_spool(payloads, f"sckpt_{self._ckpt_seq:06d}",
                                  meta=meta)
        self.migrator._gc_spools("sckpt_")
        self._since_ckpt = 0
        # the checkpoint is the new replay horizon
        self._pin_replay_floor(dict(self._cut))

    def checkpoint(self) -> bool:
        """Force an ``sckpt_*`` spool of the live stream right now — the
        checkpoint-then-kill preemption entry point. Grabs the state lock,
        so the cut is consistent with respect to the record loop exactly
        like a periodic checkpoint. Returns False when the stream doesn't
        checkpoint (``checkpoint_every == 0`` — the caller's kill will fall
        back to full replay from the earliest retained offsets) or is
        already stopped."""
        if not self.checkpoint_every:
            return False
        with self._state_lock:
            if self._stop.is_set():
                return False
            self._checkpoint_locked()
        return True

    def crash(self) -> None:
        """Abrupt pilot death (fault injection): the record loop stops
        wherever it is — no final commit, no checkpoint, and, unlike
        :meth:`stop`, no spool cleanup (``recover()`` needs it). An mp
        executor's worker processes die with their pilot (SIGKILL)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._emit_window is not None:
            # buffered outputs die with the pilot (their device work is
            # waited on, never delivered); fired_windows never counted
            # them, so the replay re-fires and delivers them once
            self._emit_window.discard()
        if self.runtime is not None:
            for sup in list(self.runtime._sups):
                sup.kill()
            self.runtime.shutdown()
            self.runtime = None

    def recover(self) -> float:
        """Bring a crashed stream back: restore every partition and the
        stream-global meta from the latest ``sckpt_*`` spool, seek the
        consumer to the checkpoint's positions, and restart the loop (an mp
        executor respawns its workers, seeded from the restored store).
        Windows fired between the checkpoint and the crash re-fire during
        replay with their emit suppressed (``_skip_emits``), so downstream
        sees each firing exactly once. Without any checkpoint the stream
        restarts from the earliest retained offsets — same exactly-once
        argument, longer replay. Returns the recovery latency in ms."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("recover() on a live stream — crash() first")
        t0 = time.perf_counter()
        spool = self.migrator.latest_spool("sckpt_")
        if spool is not None:
            payloads = self.migrator.read_spool(spool)
            meta = pickle.loads(self.migrator.read_meta(spool))
            self.store.assignment = dict(meta["assignment"])
            for pid, data in payloads.items():
                part = deserialize_partition(data)
                self.store.partitions[pid] = part
            for p, off in meta["positions"].items():
                self.consumer.seek(p, off)
            self.watermarks._max_ts = meta["max_ts"]
            self._skip_emits = max(self.stats.fired_windows - meta["fired"], 0)
            self.stats.records = meta["records"]
            self.stats.late_records = meta["late"]
            if isinstance(self.assigner, SessionWindow):
                self.assigner._sessions = dict(meta["sessions"] or {})
        else:
            # nothing spooled yet: full replay from the log's earliest
            topic = self.cluster.topic(self.topic)
            for p in list(self.consumer.positions()):
                self.consumer.seek(p, topic.partitions[p].earliest)
            self.store.partitions = {
                p: StatePartition(p) for p in range(self.store.n_partitions)
            }
            self.watermarks._max_ts = float("-inf")
            self._skip_emits = self.stats.fired_windows
            self.stats.records = 0
            self.stats.late_records = 0
            if isinstance(self.assigner, SessionWindow):
                self.assigner._sessions = {}
        self._stop.clear()
        self._error = None
        self.start()  # re-creates the mp runtime (seeded from the store)
        self.recoveries += 1
        self.last_recovery_ms = (time.perf_counter() - t0) * 1e3
        if self.metrics is not None:
            self.metrics.publish("stream.recoveries", self.recoveries,
                                 stream=self.metrics_label)
            self.metrics.publish("stream.recovery_ms", self.last_recovery_ms,
                                 stream=self.metrics_label)
        return self.last_recovery_ms

    def lag(self) -> dict[int, int]:
        """Records behind per partition (same shape as the micro-batch
        stream's) — what autoscaler lag probes consume."""
        return self.cluster.lag(self.group.group, self.topic)

    def rescale(self, owners: list, devices: list | None = None) -> MigrationReport | None:
        """Move keyed window state onto a changed owner set (extension
        pilots added/removed): quiesce -> snapshot -> reassign -> restore
        -> resume. No-op (returns None) once the stream is stopped.

        ``owners`` are the pilot's slots (``ContinuousPlugin.slots``);
        ``devices`` (default: ``owners``) is what the ``on_rescale`` hook
        receives, the slots' devices when the plugin calls.

        Blocks until any in-flight ``_ingest``/``window_fn`` call finishes
        (the state lock serializes against the record loop) and the
        processor's async double-buffer drains (``sync_fn``), so a
        partition is never serialized while a window is being appended to
        or fired from it. The ``on_rescale`` hook runs inside the quiesced
        section, after the migration, and its return value is ignored (the
        engine's state is the store; processor-held state is the hook's own
        business).
        """
        with self._state_lock:
            if self._stop.is_set():
                # dead stream (plugin.cancel + extension teardown still
                # calls in): nothing will fire again, so migrating would
                # only waste serde work and re-create the spool stop()
                # cleaned up — checked under the lock stop() cleans under
                return None
            if self.sync_fn is not None:
                self.sync_fn()
            self._drain_emits()  # no output may straddle the migration
            if devices is not None:
                self.owner_devices.update(zip(owners, devices))
            if self.runtime is not None:
                # mp: drain in-flight replies, quiesce workers, then move
                # partitions between processes through the migrator spool
                report = self.runtime.rescale(list(owners), self.owner_devices)
            else:
                report = self.migrator.migrate(self.store, list(owners))
            self.last_migration = report
            if self.on_rescale is not None:
                self.on_rescale(list(owners) if devices is None else list(devices))
        return report


@register_plugin("continuous")
@register_plugin("flink")  # paper naming convenience
class ContinuousPlugin(ManagerPlugin):
    """Holds the pilot's slots and devices, base lease first; every stream
    of the pilot partitions its keyed state over :attr:`slots`."""

    USES_DEVICES = True

    def __init__(self, pcd):
        super().__init__(pcd)
        #: (slot, device) per pool entry this pilot and its extensions hold
        self._held: list[tuple[int, Any]] = []
        self.streams: list[ContinuousStream] = []
        self._ready = threading.Event()

    @property
    def slots(self) -> list[int]:
        return [s for s, _ in self._held]

    @property
    def devices(self) -> list:
        return [d for _, d in self._held]

    def submit_job(self, lease: Lease) -> None:
        self._held = list(zip(lease.slots, lease.devices))
        self._ready.set()

    def wait(self) -> None:
        self._ready.wait()

    def extend(self, lease: Lease) -> None:
        self._held.extend(zip(lease.slots, lease.devices))
        self._rescale()

    def shrink(self, lease: Lease) -> None:
        # by slot: the lease that left, not the first equal device
        gone = set(lease.slots)
        self._held = [(s, d) for s, d in self._held if s not in gone]
        self._rescale()

    def _rescale(self) -> None:
        for s in self.streams:
            s.rescale(self.slots, self.devices)

    def get_context(self, configuration: dict | None = None) -> "ContinuousPlugin":
        return self

    def run_cu(self, cu: ComputeUnit) -> ComputeUnit:
        threading.Thread(target=cu.run, daemon=True).start()
        return cu

    def cancel(self) -> None:
        for s in self.streams:
            try:
                s.stop()
            except Exception:
                pass

    def stream(self, cluster: BrokerCluster, topic: str, **kw) -> ContinuousStream:
        # seed the store's owner set with the pilot's current slots so the
        # first extension only moves the partitions that actually re-home
        kw.setdefault("owners", self.slots or None)
        kw.setdefault("devices", self.devices or None)
        s = ContinuousStream(cluster, topic, **kw)
        self.streams.append(s)
        return s
