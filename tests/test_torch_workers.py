"""The port's multiprocess partition runtime (``executor="mp"``) against
the JAX package's: the protocol pieces in isolation (channel correlation,
the worker's command round trips, heartbeat lifecycle, respawn), then
keyed streams whose windows run in worker processes — fault-free, with a
worker SIGKILLed mid-stream, with a worker wedged in its window function,
and across a rescale to an all-new owner set — each firing, in order, what
the JAX package's stream fires on the same records, bitwise. Then what the
port adds: the start method chosen by the owners' devices (spawned workers
through the seam a test can patch, a closure refused with a ``TypeError``),
forked workers that run torch after the parent used its threads, outputs
that must be host values, and workers that never build a kernel."""
import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro.broker import Producer as JaxProducer
from repro.core import PilotComputeService as JaxService
from repro.streaming import TumblingWindow as JaxTumbling
from repro_torch.broker import Producer
from repro_torch.broker.consumer import Message
from repro_torch.core import PilotComputeService
from repro_torch.core.failure import HeartbeatMonitor
from repro_torch.elastic import MetricsBus
from repro_torch.kernels import _build
from repro_torch.kernels import kmeans
from repro_torch.streaming import TumblingWindow
from repro_torch.workers import (
    CONFIGURE,
    PROCESS_BATCH,
    SNAPSHOT,
    STATS,
    BatchResult,
    Reply,
    WorkerChannel,
    WorkerCrash,
    WorkerError,
    WorkerSupervisor,
    WorkerUnresponsive,
    runtime as worker_runtime,
    start_method,
)
from repro_torch.workers.proto import OP_APPEND, OP_OBSERVE

pytestmark = pytest.mark.skipif(
    "fork" not in mp.get_all_start_methods(),
    reason='executor="mp" on CPU owners forks its workers',
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
_CTX = mp.get_context("fork")


# -- channel ------------------------------------------------------------------


def test_channel_drops_stale_replies_and_correlates_by_seq():
    ch = WorkerChannel(_CTX)
    s1 = ch.send("A")
    s2 = ch.send("B")
    # replies arrive out of an abandoned earlier exchange first
    ch.replies.put(Reply(s1, True, "old"))
    ch.replies.put(Reply(s2, True, "new"))
    assert ch.recv(s2, timeout=5).payload == "new"  # stale s1 silently dropped
    ch.close()


def test_channel_drain_discards_inflight_leftovers():
    ch = WorkerChannel(_CTX)
    for i in range(3):
        ch.replies.put(Reply(i, True, BatchResult([], 0, 0.0)))
    time.sleep(0.2)  # let the feeder thread flush
    assert ch.drain() == 3
    seq = ch.send("Q")
    ch.replies.put(Reply(seq, True, "idle"))
    assert ch.recv(seq, timeout=5).payload == "idle"
    ch.close()


def test_channel_recv_raises_on_dead_and_hung_worker():
    ch = WorkerChannel(_CTX)
    seq = ch.send("X")
    with pytest.raises(WorkerCrash):
        ch.recv(seq, timeout=5, alive_fn=lambda: False)
    with pytest.raises(WorkerUnresponsive):
        ch.recv(seq, timeout=5, alive_fn=lambda: True, responsive_fn=lambda: False)
    with pytest.raises(WorkerUnresponsive):
        ch.recv(seq, timeout=0.2)  # hard deadline
    ch.close()


# -- heartbeat monitor lifecycle -------------------------------------------------


def test_monitor_close_joins_all_threads_and_is_idempotent():
    m = HeartbeatMonitor(interval=0.05, timeout=2.0)
    for t in [object() for _ in range(3)]:
        m.watch(t)
    threads = list(m._agent_threads.values()) + [m._monitor]
    assert all(t.is_alive() for t in threads)
    m.close()
    assert all(not t.is_alive() for t in threads)  # joined, not leaked
    m.close()  # idempotent
    m.stop()  # alias


def test_monitor_pull_based_staleness_detects_stopped_source():
    m = HeartbeatMonitor(interval=0.05, timeout=0.3)
    failed = []
    m.on_failure(failed.append)
    beat = {"t": time.monotonic()}
    target = object()
    m.watch(target, beat_fn=lambda: beat["t"])
    time.sleep(0.5)  # the source keeps a stale value: no fresh stamps
    assert not m.is_alive(target) and failed == [target]
    m.close()


def test_monitor_pull_based_live_source_stays_alive():
    m = HeartbeatMonitor(interval=0.05, timeout=0.3)
    target = object()
    m.watch(target, beat_fn=time.monotonic)
    time.sleep(0.5)
    assert m.is_alive(target)
    m.close()


def test_service_cancel_closes_monitor():
    svc = PilotComputeService(devices=[CPU] * 2)
    monitor = svc.monitor
    svc.cancel()
    assert monitor._closed and not monitor._monitor.is_alive()


# -- worker protocol round trip ----------------------------------------------


def _spawned(window_fn, monitor=None):
    monitor = monitor or HeartbeatMonitor(interval=0.05, timeout=1.0)
    sup = WorkerSupervisor(0, 0, window_fn, monitor=monitor, ctx=_CTX, batch_timeout=10.0,
                           device=CPU)
    return sup.spawn(), monitor


def test_worker_process_batch_snapshot_restore_stats():
    sup, monitor = _spawned(lambda k, w, msgs: (k, w, sum(float(m.value) for m in msgs)))
    try:
        assert sup.request(CONFIGURE, {"pids": [0, 1]}) == [0, 1]
        ops = [
            (OP_OBSERVE, 0, 0.5),
            (OP_APPEND, 0, "a", (0.0, 1.0), Message(0, 0, 0.5, 2.0)),
            (OP_OBSERVE, 1, 0.7),
            (OP_APPEND, 1, "b", (0.0, 1.0), Message(0, 1, 0.7, 3.0)),
        ]
        r = sup.request(PROCESS_BATCH, {"ops": ops, "watermark": 0.5})
        assert r.fired == [] and r.buffered_windows == 2  # windows still open
        r = sup.request(PROCESS_BATCH, {"ops": [], "watermark": 1.0})
        # canonical order: same window -> pid breaks the tie
        assert [(pid, key, out[2]) for pid, key, _w, out in r.fired] == [
            (0, "a", 2.0), (1, "b", 3.0)]
        stats = sup.request(STATS)
        assert stats["records"] == 2 and stats["buffered_windows"] == 0
        assert set(sup.request(SNAPSHOT, {"pids": [0, 1], "release": False})) == {0, 1}
    finally:
        sup.stop()
        monitor.close()


def test_worker_error_propagates_without_restart():
    def bad(k, w, msgs):
        raise ValueError("deterministic user bug")

    sup, monitor = _spawned(bad)
    try:
        sup.request(CONFIGURE, {"pids": [0]})
        ops = [(OP_APPEND, 0, "k", (0.0, 1.0), Message(0, 0, 0.5, 1.0))]
        with pytest.raises(WorkerError, match="deterministic user bug"):
            sup.request(PROCESS_BATCH, {"ops": ops, "watermark": 2.0})
        assert sup.alive() and sup.restarts == 0  # the worker survives its reply
    finally:
        sup.stop()
        monitor.close()


def test_worker_refuses_a_cuda_tensor_as_output():
    """A window output crosses a queue; a CUDA tensor would cross as an IPC
    handle tied to the worker. The check runs on what the output holds (a
    stand-in reports ``is_cuda``: there is no card here)."""
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    sup, monitor = _spawned(lambda k, w, msgs: (k, [torch.zeros(2).as_subclass(FakeCuda)]))
    try:
        sup.request(CONFIGURE, {"pids": [0]})
        ops = [(OP_APPEND, 0, "k", (0.0, 1.0), Message(0, 0, 0.5, 1.0))]
        with pytest.raises(WorkerError, match="CUDA tensor.*host values"):
            sup.request(PROCESS_BATCH, {"ops": ops, "watermark": 2.0})
    finally:
        sup.stop()
        monitor.close()


def test_supervisor_respawn_replaces_incarnation():
    sup, monitor = _spawned(lambda k, w, msgs: len(msgs))
    try:
        sup.request(CONFIGURE, {"pids": [0]})
        pid1 = sup.process.pid
        os.kill(pid1, signal.SIGKILL)
        sup.process.join(timeout=5)
        assert not sup.alive()
        sup.respawn()
        assert sup.alive() and sup.process.pid != pid1 and sup.restarts == 1
        assert sup.request(CONFIGURE, {"pids": [0]}) == [0]  # fresh + serving
        assert sup.start_seconds == []  # forked: watched from the start
    finally:
        sup.stop()
        monitor.close()


# -- keyed streams in worker processes, against the JAX package ----------------------


def _window_fn(k, w, msgs):
    return (k, w, sum(float(m.value[0]) for m in msgs), len(msgs))


def _count_fn(k, w, msgs):
    return (k, w, len(msgs))


def _stream(pkg, *, executor="inline", bus=None, cores=2, window_fn=_window_fn,
            worker_options=None):
    """A keyed stream on a one-partition topic (keys value[1] mod 5, 1 s
    tumbling windows) and its service; outputs collect in order."""
    svc = JaxService(devices=list(range(16))) if pkg == "jax" else \
        PilotComputeService(devices=[CPU] * 16)
    cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
    cluster.create_topic("t", 1)
    flink = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": cores, "type": "flink"})
    outs: list = []
    stream = flink.get_context().stream(
        cluster, "t", group="g", assigner=(JaxTumbling if pkg == "jax" else TumblingWindow)(1.0),
        window_fn=window_fn, key_fn=lambda m: int(m.value[1]) % 5, emit=outs.append,
        metrics=bus, executor=executor, worker_options=worker_options)
    return svc, cluster, stream, outs


def _send(pkg, cluster, lo, hi):
    prod = (JaxProducer if pkg == "jax" else Producer)(cluster, "t", serializer="npy")
    for i in range(lo, hi):
        prod.send(np.array([float(i), i]), timestamp=100.0 + i * 0.2)


def _windows(n):
    """Firings once records 0..n-1 are in (n - 1 not a multiple of 5): the
    watermark is the last event time, every 1 s window ending at or before
    it closes, and each holds one record per key."""
    return int(0.2 * (n - 1)) * 5


@pytest.fixture(scope="module")
def jax_outs():
    """The JAX package's inline stream over 60 records, per window_fn."""
    out = {}
    for name, fn in (("sum", _window_fn), ("count", _count_fn)):
        svc, cluster, stream, outs = _stream("jax", window_fn=fn)
        try:
            stream.start()
            _send("jax", cluster, 0, 60)
            stream.await_windows(_windows(60), timeout=30)
            stream.stop()
        finally:
            svc.cancel()
        out[name] = outs
    return out


def test_mp_executor_matches_inline_and_publishes_worker_gauges(jax_outs):
    bus = MetricsBus()
    svc, cluster, stream, outs = _stream("torch", executor="mp", bus=bus,
                                         worker_options={"snapshot_every": 4})
    try:
        stream.start()
        assert stream.runtime is not None and stream.runtime.n_workers == 2
        assert stream.runtime._ctx.get_start_method() == "fork"
        _send("torch", cluster, 0, 60)
        stream.await_windows(_windows(60), timeout=30)
        assert bus.value("workers.alive", stream="t") == 2
        assert bus.value("workers.restarts", stream="t") == 0
        deadline = time.monotonic() + 5
        while (bus.value("stream.latency_p50", stream="t") <= 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert bus.value("stream.latency_p50", stream="t") > 0
        assert bus.value("stream.latency_p99", stream="t", worker="0") > 0
        stream.stop()
        assert bus.value("workers.alive", stream="t") == 0
    finally:
        svc.cancel()
    assert outs == jax_outs["sum"]  # bitwise, in the same order


def test_unknown_executor_rejected():
    with pytest.raises(ValueError, match="unknown executor"):
        _stream("torch", executor="threads")


def test_mp_rescale_drains_stale_replies_before_quiesce(jax_outs):
    """A leftover BatchResult in a worker's reply queue (an abandoned
    in-flight batch) must not alias the QUIESCE reply."""
    svc, cluster, stream, outs = _stream("torch", executor="mp",
                                         worker_options={"snapshot_every": 64})
    try:
        stream.start()
        _send("torch", cluster, 0, 20)
        stream.await_windows(_windows(20), timeout=30)
        for sup in stream.runtime._sups:  # forge an in-flight leftover
            sup.channel.replies.put(Reply(sup.channel._seq, True, BatchResult([], 99, 1.0)))
        time.sleep(0.2)
        report = stream.rescale([0, 1, 2, 3], [CPU] * 4)
        assert report is not None and report.moved and stream.runtime.n_workers == 4
        _send("torch", cluster, 20, 60)
        stream.await_windows(_windows(60), timeout=30)
        stream.stop()
    finally:
        svc.cancel()
    assert stream.stats.records == 60 and outs == jax_outs["sum"]


def test_sigkill_mid_stream_recovers_exactly(jax_outs):
    bus = MetricsBus()
    svc, cluster, stream, outs = _stream("torch", executor="mp", cores=4, bus=bus,
                                         worker_options={"snapshot_every": 8})
    try:
        stream.start()
        _send("torch", cluster, 0, 30)
        stream.await_windows(10, timeout=30)
        os.kill(stream.runtime._sups[1].process.pid, signal.SIGKILL)
        _send("torch", cluster, 30, 60)
        stream.await_windows(_windows(60), timeout=60)
        stream.stop()
        assert stream.runtime.restarts >= 1
        assert bus.value("workers.restarts", stream="t") >= 1
        assert len(stream.runtime.recovery_seconds) >= 1
    finally:
        svc.cancel()
    assert outs == jax_outs["sum"]  # zero lost, zero duplicated, same order


def test_hung_worker_detected_and_restarted(jax_outs, tmp_path):
    """A window_fn wedged in user code stops stamping heartbeats; the
    supervisor flags it stale, kills the process and replays. The wedge is
    one-shot (flag file), so the replayed call completes."""
    flag = str(tmp_path / "wedged-once")

    def wedge_once(k, w, msgs):
        if not os.path.exists(flag):
            open(flag, "w").close()
            time.sleep(300)  # never stamps another beat: reads as a hang
        return _count_fn(k, w, msgs)

    svc, cluster, stream, outs = _stream(
        "torch", executor="mp", cores=1, window_fn=wedge_once,
        worker_options={"snapshot_every": 8, "heartbeat_timeout": 0.6,
                        "heartbeat_interval": 0.05})
    try:
        stream.start()
        _send("torch", cluster, 0, 60)
        stream.await_windows(_windows(60), timeout=60)
        stream.stop()
        assert stream.runtime.restarts == 1
    finally:
        svc.cancel()
    # exactly one firing per closed (key, window), the JAX package's
    assert outs == jax_outs["count"]


def test_restart_exhaustion_surfaces_as_stream_error():
    def suicide(k, w, msgs):
        os.kill(os.getpid(), signal.SIGKILL)

    svc, cluster, stream, _ = _stream("torch", executor="mp", cores=1, window_fn=suicide,
                                      worker_options={"max_restarts": 2, "snapshot_every": 8})
    try:
        stream.start()
        _send("torch", cluster, 0, 10)
        with pytest.raises(WorkerCrash, match="failed to recover"):
            stream.await_windows(1, timeout=60)
        with pytest.raises(WorkerCrash):
            stream.stop()
    finally:
        svc.cancel()


def test_mp_rescale_moves_partitions_between_processes(jax_outs):
    svc, cluster, stream, outs = _stream("torch", executor="mp",
                                         worker_options={"snapshot_every": 64})
    try:
        stream.start()
        _send("torch", cluster, 0, 30)
        stream.await_windows(10, timeout=30)
        pids_before = {s.process.pid for s in stream.runtime._sups}
        report = stream.rescale([10, 11, 12, 13], [CPU] * 4)  # all-new owner set
        assert report.moved and len(report.moved) == stream.store.n_partitions
        pids_after = {s.process.pid for s in stream.runtime._sups}
        assert len(pids_after) == 4 and pids_before.isdisjoint(pids_after)
        _send("torch", cluster, 30, 60)
        stream.await_windows(_windows(60), timeout=30)
        stream.stop()
    finally:
        svc.cancel()
    assert outs == jax_outs["sum"]  # buffered state crossed processes losslessly


# -- the start method, and torch in the workers ------------------------------------


def test_start_method_follows_the_owners_devices():
    assert start_method([CPU, CPU]) == "fork"
    assert start_method([0, 1]) == "fork"
    assert start_method([CPU, torch.device("cuda", 0)]) == "spawn"
    assert start_method(["cuda:1"]) == "spawn"


def test_spawned_workers_through_the_seam(jax_outs, monkeypatch):
    """With the seam patched to spawn (as a CUDA owner would), a
    module-level window function reaches fresh interpreters pickled: the
    workers are watched from their first beat, each start is timed, and
    the firings are the JAX package's. A closure is refused at start with
    a TypeError naming it."""
    monkeypatch.setattr(worker_runtime, "start_method", lambda devices: "spawn")
    svc, cluster, stream, outs = _stream("torch", executor="mp")
    try:
        stream.start()
        assert stream.runtime._ctx.get_start_method() == "spawn"
        assert len(stream.runtime.start_seconds) == 2
        assert all(0 < t < 30 for t in stream.runtime.start_seconds)
        _send("torch", cluster, 0, 60)
        stream.await_windows(_windows(60), timeout=60)
        stream.stop()
    finally:
        svc.cancel()
    assert outs == jax_outs["sum"]

    def local_window(k, w, msgs):
        return len(msgs)

    svc, cluster, stream, _ = _stream("torch", executor="mp", window_fn=local_window)
    try:
        with pytest.raises(TypeError, match="local_window.*does not pickle"):
            stream.start()
    finally:
        svc.cancel()


def _kmeans_window(k, w, msgs):
    pts = torch.from_numpy(np.stack([m.value for m in msgs]).astype(np.float32))
    labels, dist = kmeans.assign(pts.repeat(4096, 1), pts[:3].contiguous())
    return (k, w, len(msgs), float(dist.sum()), int(labels.sum()))


def test_forked_worker_runs_torch_after_the_parent_used_its_threads():
    """The parent has entered torch's intra-op pool; a forked worker that
    ran torch without leaving it would hang on its first parallel operation
    (its first act is ``torch.set_num_threads(1)``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        a = torch.randn(512, 512)
        assert torch.isfinite(a @ a).all()  # the pool is up in the parent
        svc, cluster, stream, outs = _stream(
            "torch", executor="mp", window_fn=_kmeans_window,
            worker_options={"batch_timeout": 10.0, "max_restarts": 1})
        try:
            stream.start()
            _send("torch", cluster, 0, 20)
            stream.await_windows(_windows(20), timeout=30)
            stream.stop()
        finally:
            svc.cancel()
    finally:
        torch.set_num_threads(threads)
    assert len(outs) == _windows(20) and stream.runtime.restarts == 0
    for k, w, n, inertia, _ in outs:
        assert n == 1 and np.isfinite(inertia)


def test_a_worker_never_builds_a_kernel(tmp_path, monkeypatch):
    """After ``forbid_builds`` (a worker's first act) a missing library is an
    error naming the parent's build, not an ``nvcc`` run."""
    lib = _build.CudaLibrary("kmeans_assign.cu", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_BUILDS_ALLOWED", True)
    _build.forbid_builds()
    with pytest.raises(RuntimeError, match="may not build.*build_all"):
        lib.load()
