"""The port's continuous engine against the JAX package's, inline and on
the log plane: the same records (a deterministic keyed source fed live)
through both engines fire the same ``(key, window)`` set with bitwise
equal aggregates and the same late counts, for tumbling, sliding and
session windows; a crash recovered with and without checkpoints, with and
without the emit double-buffer, and a run under random grow/shrink of
extension pilots each equal the JAX package's undisturbed run. A K-Means
window function (the continuous phase of ``chip_smoke.py`` at a small
size) holds the port's plain assignment and update against the JAX
package's. Then the engine's own contracts: quiescing, the sync barrier,
automatic migration on extension, and what it refuses."""
import os
import random
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streaming as jax_streaming
from repro.broker import Producer as JaxProducer
from repro.core import PilotComputeService as JaxService
from repro.kernels.kmeans import ref as jax_kmeans
from repro_torch import streaming
from repro_torch.broker import Producer
from repro_torch.core import PilotComputeService
from repro_torch.engines import ContinuousStream
from repro_torch.kernels import kmeans

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_MSGS = 1200
DT = 0.01  # logical seconds between events
N_KEYS = 5
BASE_TS = 1000.0
WINDOWS = {"tumbling": {"window": "tumbling", "size": 0.1},
           "sliding": {"window": "sliding", "size": 0.2, "slide": 0.05},
           "session": {"window": "session", "gap": 0.2}}


def _payload(i: int) -> np.ndarray:
    return np.array([i % N_KEYS, float(i) * 1.25], dtype=np.float64)


def _timestamp(i: int, kind: str) -> float:
    # session runs get a quiet 0.5 s every 100 events, so sessions close
    return BASE_TS + i * DT + (0.5 * (i // 100) if kind == "session" else 0.0)


def _assigner(pkg: str, window: dict):
    mod = jax_streaming if pkg == "jax" else streaming
    if window["window"] == "tumbling":
        return mod.TumblingWindow(window["size"])
    if window["window"] == "sliding":
        return mod.SlidingWindow(window["size"], window["slide"])
    return mod.SessionWindow(window["gap"])


def _sum_window(key, w, msgs):
    vals = np.array([m.value[1] for m in msgs], dtype=np.float64)
    # order-sensitive on purpose: loss, duplication or reorder shows in the low bits
    return key, w, float(np.sum(vals)), len(msgs)


def _run(pkg: str, kind: str = "tumbling", *, n_msgs: int = N_MSGS, payload=_payload,
         window_fn=_sum_window, crash_at: int | None = None, checkpoint_every: int = 0,
         chaos_seed: int | None = None, async_emit: int = 0, executor: str = "inline",
         kill_worker_at: int | None = None) -> tuple[dict, dict]:
    """One run of the keyed stream in ``pkg`` with records fed live (ten
    every 5 ms); optionally crashed and recovered at ``crash_at`` records,
    or grown and shrunk at random by extension pilots. ``executor="mp"``
    runs the partitions in worker processes, and ``kill_worker_at``
    SIGKILLs one of them at that many records. Returns
    ``{(key, window): outputs}`` and the run's counters."""
    svc = JaxService(devices=list(range(8))) if pkg == "jax" else \
        PilotComputeService(devices=[CPU] * 8)
    producer_cls = JaxProducer if pkg == "jax" else Producer
    results: dict = {}
    try:
        cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
        cluster.create_topic("c", 1)  # one partition, one producer: one ingest order
        flink = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 2, "type": "flink"})
        stream = flink.get_context().stream(
            cluster, "c", group="g", assigner=_assigner(pkg, WINDOWS[kind]),
            window_fn=window_fn, key_fn=lambda m: int(np.ravel(m.value)[0]),
            emit=lambda out: results.__setitem__((out[0], out[1]), out[2:]),
            checkpoint_every=checkpoint_every, async_emit=async_emit, executor=executor,
            **({"worker_options": {"snapshot_every": 8}} if executor == "mp" else {}))
        stream.start()
        producer = producer_cls(cluster, "c", serializer="npy")

        def feed():
            for i in range(n_msgs):
                producer.send(payload(i), timestamp=_timestamp(i, kind))
                if i % 10 == 9:
                    time.sleep(0.005)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        rng = random.Random(chaos_seed) if chaos_seed is not None else None
        extensions: list = []
        crashed_at = None
        deadline = time.monotonic() + 60
        while feeder.is_alive() or stream.stats.records < n_msgs:
            assert stream._error is None, stream._error
            assert time.monotonic() < deadline, f"{stream.stats.records}/{n_msgs} records"
            if kill_worker_at is not None and stream.stats.records >= kill_worker_at:
                os.kill(stream.runtime._sups[0].process.pid, signal.SIGKILL)
                kill_worker_at = None
            if crash_at is not None and crashed_at is None and stream.stats.records >= crash_at:
                crashed_at = stream.stats.records
                stream.crash()
                assert stream._thread is None
                assert stream.recover() >= 0.0 and stream.recoveries == 1
            if rng is not None and feeder.is_alive():
                if extensions and (len(extensions) >= 3 or rng.random() < 0.5):
                    extensions.pop(rng.randrange(len(extensions))).cancel()
                else:
                    extensions.append(svc.submit_pilot({
                        "number_of_nodes": 1, "cores_per_node": rng.randint(1, 2),
                        "type": "flink", "parent": flink}))
                time.sleep(rng.uniform(0.01, 0.04))
            else:
                time.sleep(0.002)
        stream.stop()
        info = {"fired": stream.stats.fired_windows, "late": stream.stats.late_records,
                "records": stream.stats.records, "migrations": len(stream.migrator.reports),
                "crashed_at": crashed_at,
                "restarts": stream.runtime.restarts if stream.runtime is not None else 0}
    finally:
        svc.cancel()
    return results, info


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's undisturbed run of each window kind."""
    out = {}
    for kind in WINDOWS:
        results, info = _run("jax", kind)
        assert info["late"] == 0 and info["fired"] == len(results) > 0
        out[kind] = results
    return out


def _assert_bitwise(base: dict, other: dict, label: str) -> None:
    assert other.keys() == base.keys(), label
    for kw, (total, count) in base.items():
        assert other[kw] == (total, count), f"{label}: window {kw}"


@pytest.mark.parametrize("kind", sorted(WINDOWS))
def test_windows_equal_the_jax_package(jax_runs, kind):
    results, info = _run("torch", kind)
    assert info["late"] == 0 and info["fired"] == len(results)
    _assert_bitwise(jax_runs[kind], results, kind)


@pytest.mark.parametrize("checkpoint_every,async_emit", [(100, 0), (0, 0), (100, 2)])
def test_crash_and_recover_equal_the_jax_package(jax_runs, checkpoint_every, async_emit):
    """Crashed mid-stream and recovered: from the latest checkpoint spool,
    or by full replay without one; with the emit double-buffer, its held
    outputs are dropped and re-fired. Zero lost, zero duplicated."""
    results, info = _run("torch", crash_at=550, checkpoint_every=checkpoint_every,
                         async_emit=async_emit)
    assert info["crashed_at"] is not None and info["crashed_at"] < N_MSGS
    assert info["late"] == 0 and info["fired"] == len(results)
    _assert_bitwise(jax_runs["tumbling"], results, f"crash ckpt={checkpoint_every}")


def test_random_rescale_equals_the_jax_package(jax_runs):
    results, info = _run("torch", chaos_seed=20260729)
    assert info["migrations"] >= 3, "the chaos run never migrated state"
    assert info["late"] == 0 and info["fired"] == len(results)
    _assert_bitwise(jax_runs["tumbling"], results, "random rescale")


@pytest.mark.parametrize("kind", sorted(WINDOWS))
def test_mp_windows_equal_the_jax_package(jax_runs, kind):
    """Partitions in (forked) worker processes fire the JAX package's
    windows bitwise, sessions' merges included."""
    results, info = _run("torch", kind, executor="mp")
    assert info["late"] == 0 and info["fired"] == len(results) and info["restarts"] == 0
    _assert_bitwise(jax_runs[kind], results, f"mp {kind}")


@pytest.mark.parametrize("case", ["random_rescale", "worker_kill", "pilot_crash"])
def test_mp_faults_equal_the_jax_package(jax_runs, case):
    """The mp executor under the JAX package's chaos: random grow/shrink
    (partitions move between worker processes), a worker SIGKILLed
    mid-stream (respawned, restored from its checkpoint, journal replayed),
    and a pilot crash recovered from the stream's checkpoint (a fresh
    worker fleet seeded from the spool). Zero lost, zero duplicated."""
    kw = {"random_rescale": {"chaos_seed": 20260730},
          "worker_kill": {"kill_worker_at": 500},
          "pilot_crash": {"crash_at": 550, "checkpoint_every": 100}}[case]
    results, info = _run("torch", executor="mp", **kw)
    if case == "random_rescale":
        assert info["migrations"] >= 3, "the chaos run never migrated state"
    if case == "worker_kill":
        assert info["restarts"] >= 1, "the SIGKILL never triggered a restart"
    assert info["late"] == 0 and info["fired"] == len(results)
    _assert_bitwise(jax_runs["tumbling"], results, f"mp {case}")


# -- a K-Means window function, plain versions against the JAX package's ------------

KM_K, KM_POINTS, KM_KEYS = 6, 40, 4


def _km_payload(i: int) -> np.ndarray:
    pts = np.random.default_rng((7, i)).normal(size=(KM_POINTS, 3)) + (i % KM_KEYS)
    pts[:, 0] = i % KM_KEYS  # the key rides in column 0 of every row
    return pts


def _km_centroids(key: int) -> np.ndarray:
    return np.random.default_rng((11, key)).normal(size=(KM_K, 3)).astype(np.float32) + key


def _km_window_torch(key, w, msgs):
    pts = torch.from_numpy(np.concatenate([m.value for m in msgs]).astype(np.float32))
    cents = torch.from_numpy(_km_centroids(key))
    labels, dist = kmeans.assign(pts, cents)
    sums, counts = kmeans.update_scatter(pts, labels, KM_K)
    new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], cents)
    return key, w, new.numpy(), float(dist.sum()), labels.numpy(), len(msgs)


def _km_window_jax(key, w, msgs):
    pts = jnp.asarray(np.concatenate([m.value for m in msgs]).astype(np.float32))
    cents = jnp.asarray(_km_centroids(key))
    labels, dist = jax_kmeans.assign_ref(pts, cents)
    sums, counts = jax_kmeans.update_scatter(pts, labels, KM_K)
    new = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], cents)
    return key, w, np.asarray(new), float(dist.sum()), np.asarray(labels), len(msgs)


def test_kmeans_windows_match_the_jax_package():
    """Same windows and counts; labels equal, centroids and inertia within
    the K-Means app test's 1e-5 (f32 sums in another order)."""
    runs = {pkg: _run(pkg, n_msgs=300, payload=_km_payload, window_fn=fn)[0]
            for pkg, fn in (("jax", _km_window_jax), ("torch", _km_window_torch))}
    assert runs["torch"].keys() == runs["jax"].keys() and len(runs["jax"]) == 29 * KM_KEYS
    for kw, (c_j, i_j, l_j, n_j) in runs["jax"].items():
        c_t, i_t, l_t, n_t = runs["torch"][kw]
        assert n_t == n_j and np.array_equal(l_t, l_j)
        np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-5)
        assert i_t == pytest.approx(i_j, rel=1e-5)


# -- the engine's own contracts --------------------------------------------------------


@pytest.fixture
def svc():
    s = PilotComputeService(devices=[CPU] * 8)
    yield s
    s.cancel()


def _continuous(svc, *, cores=2, **kw):
    cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
    cluster.create_topic("st", 1)
    flink = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": cores, "type": "flink"})
    outs: list = []
    stream = flink.get_context().stream(
        cluster, "st", group="g", assigner=kw.pop("assigner", streaming.TumblingWindow(1.0)),
        window_fn=kw.pop("window_fn", lambda k, w, msgs: (k, w, len(msgs))),
        key_fn=lambda m: int(m.value[1]) % 3, emit=outs.append, **kw)
    return cluster, flink, stream, outs


def _send(cluster, lo, hi):
    prod = Producer(cluster, "st", serializer="npy")
    for i in range(lo, hi):
        prod.send(np.array([float(i), i]), timestamp=100.0 + i * 0.2)


def test_extension_pilot_migrates_over_slots_and_spools_die_with_the_stream(svc):
    import os

    cluster, flink, stream, _ = _continuous(svc)
    assert stream.store.owners == [0, 1]  # the base pilot's slots
    stream.start()
    _send(cluster, 0, 10)
    stream.await_windows(3, timeout=20)
    assert stream.last_migration is None
    ext = svc.submit_pilot(
        {"number_of_nodes": 1, "cores_per_node": 2, "type": "flink", "parent": flink})
    assert stream.last_migration.moved and stream.store.owners == [0, 1, 2, 3]
    ext.cancel()
    assert len(stream.migrator.reports) == 2 and stream.store.owners == [0, 1]
    spool_root = stream.migrator.directory
    assert spool_root is not None and os.path.isdir(spool_root)
    stream.stop()
    assert not os.path.exists(spool_root)
    assert stream.rescale([0]) is None and stream.migrator.directory is None


def test_rescale_quiesces_inflight_window_fn_and_hands_devices_to_the_hook(svc):
    entered, release = threading.Event(), threading.Event()
    finished_at, rescaled_at, hooked = [], [], []

    def slow_window(k, w, msgs):
        entered.set()
        release.wait(10)
        finished_at.append(time.monotonic())
        return len(msgs)

    cluster, flink, stream, _ = _continuous(svc, window_fn=slow_window, on_rescale=hooked.append)
    stream.start()
    _send(cluster, 0, 10)
    assert entered.wait(10)
    t = threading.Thread(target=lambda: (stream.rescale([0, 1, 2], [CPU] * 3),
                                         rescaled_at.append(time.monotonic())), daemon=True)
    t.start()
    time.sleep(0.3)
    assert not rescaled_at, "rescale() returned while a window_fn call was in flight"
    release.set()
    t.join(10)
    assert rescaled_at and finished_at and rescaled_at[0] >= finished_at[0]
    assert hooked == [[CPU] * 3]
    stream.stop()


def test_rescale_runs_sync_barrier_before_migrating(svc):
    calls = []

    class Proc:
        def process(self, k, w, msgs):
            return len(msgs)

        def sync(self):
            calls.append("sync")

    proc = Proc()
    _, _, stream, _ = _continuous(svc, window_fn=proc.process)
    assert stream.sync_fn is not None  # auto-wired from the bound window_fn
    stream.start()
    stream.rescale([0, 1])
    assert calls == ["sync"]
    stream.stop()


def test_recover_refuses_a_running_stream(svc):
    _, _, stream, _ = _continuous(svc, checkpoint_every=10)
    stream.start()
    try:
        with pytest.raises(RuntimeError):
            stream.recover()
    finally:
        stream.stop()


def test_checkpoint_cut_excludes_a_polled_batch_not_yet_ingested(svc):
    """A checkpoint taken from another thread (preemption's checkpoint hook)
    while the loop has polled a batch but waits for the state lock: the cut
    must sit behind that batch, or recovery seeks past records the restored
    state never saw and their windows go missing."""
    _, _, ref, ref_outs = _continuous(svc, cores=1)
    cluster = ref.cluster
    ref.start()
    _send(cluster, 0, 60)
    ref.await_windows(33, timeout=20)  # [100, 101) .. [110, 111) x 3 keys
    ref.stop()

    cluster, _, stream, outs = _continuous(svc, cores=1, checkpoint_every=1000)
    stream.start()
    _send(cluster, 0, 20)
    stream.await_windows(9, timeout=20)
    deadline = time.monotonic() + 10
    while stream.stats.records < 20:  # the batch that fired them is ingested
        assert time.monotonic() < deadline
        time.sleep(0.002)
    with stream._state_lock:  # what checkpoint() holds; the loop now waits on it
        _send(cluster, 20, 40)
        while stream.consumer.positions()[0] <= 20:
            assert time.monotonic() < deadline, "the loop never polled the batch"
            time.sleep(0.002)
        assert stream.stats.records == 20
        stream._checkpoint_locked()
    stream.crash()
    stream.recover()
    _send(cluster, 40, 60)
    stream.await_windows(33, timeout=10)
    stream.stop()
    assert outs == ref_outs


def test_mp_executor_and_shm_transport_name_what_they_wait_for(svc):
    """Neither waits any longer: the engine takes ``executor="mp"`` (its
    workers start with the stream, not before) and ``transport="shm"``
    (whose frames it copies out); an unknown executor is still refused."""
    cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
    cluster.create_topic("t", 1)
    common = dict(group="g", assigner=streaming.TumblingWindow(1.0),
                  window_fn=lambda k, w, m: None)
    mp_stream = ContinuousStream(cluster, "t", executor="mp", **common)
    assert mp_stream.executor == "mp" and mp_stream.runtime is None
    shm_stream = ContinuousStream(cluster, "t", transport="shm", **common)
    assert shm_stream.transport == "shm" and not shm_stream.consumer.zero_copy
    with pytest.raises(ValueError, match="unknown executor"):
        ContinuousStream(cluster, "t", executor="remote", **common)


def test_taskpool_plugin_runs_units_and_speculates(svc):
    """The Dask analog: units run on the pool's workers; a straggler is
    re-launched and the first completion wins."""
    pilot = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 2, "type": "dask",
                              "speculative_multiple": 2.0})
    units = [pilot.submit(lambda x: x * x, i) for i in range(6)]
    assert [u.wait(timeout=10) for u in units] == [i * i for i in range(6)]
    gate = threading.Event()
    first = [True]

    def straggler():
        if first[0]:
            first[0] = False
            gate.wait(10)  # the first attempt hangs; a speculative one finishes
        return "done"

    assert pilot.submit(straggler).wait(timeout=10) == "done"
    assert pilot.plugin.speculated >= 1
    gate.set()


def test_late_records_count_like_the_jax_package():
    """One late record (event time behind the watermark) is dropped and
    counted in both packages; the same windows fire with the same sums."""
    out = {}
    for pkg in ("jax", "torch"):
        svc = JaxService(devices=[0]) if pkg == "jax" else PilotComputeService(devices=[CPU])
        fired: list = []
        try:
            cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
            cluster.create_topic("ev", 1)
            stream = svc.submit_pilot({"number_of_nodes": 1, "type": "flink"}).get_context().stream(
                cluster, "ev", group="w", assigner=_assigner(pkg, {"window": "tumbling",
                                                                   "size": 10.0}),
                window_fn=lambda key, w, msgs: (w, sum(float(m.value[0]) for m in msgs)),
                emit=fired.append)
            stream.start()
            prod = (JaxProducer if pkg == "jax" else Producer)(cluster, "ev", serializer="npy")
            for ts, v in [(1, 1.0), (2, 2.0), (11, 10.0), (3, 99.0), (25, 5.0)]:
                prod.send(np.array([v]), timestamp=1000.0 + ts)
            stream.await_windows(2, timeout=20)
            stream.stop()
            out[pkg] = (sorted(fired), stream.stats.late_records)
        finally:
            svc.cancel()
    assert out["torch"] == out["jax"] == ([((1000.0, 1010.0), 3.0), ((1010.0, 1020.0), 10.0)], 1)


def test_async_emit_batches_and_crash_equal_the_jax_package():
    """The JAX package's emit double-buffer case: records sent in batches
    of ten, synchronous and double-buffered emits, and a crash between
    batches; every delivery list equals the JAX package's synchronous one."""
    from repro.broker import BrokerCluster as JaxCluster
    from repro.engines.continuous import ContinuousStream as JaxStream
    from repro_torch.broker import BrokerCluster

    def run(pkg, async_emit, crash_at=None):
        cluster = (JaxCluster if pkg == "jax" else BrokerCluster)(1)
        cluster.create_topic("t", 1)
        results: list = []
        stream = (JaxStream if pkg == "jax" else ContinuousStream)(
            cluster, "t", group="g", assigner=_assigner(pkg, WINDOWS["tumbling"]),
            window_fn=lambda key, w, msgs: (key, w, float(np.sum(
                [m.value[1] for m in msgs])), len(msgs)),
            key_fn=lambda m: int(m.value[0]) % 3, emit=results.append,
            checkpoint_every=40, async_emit=async_emit)
        assert (stream._emit_window is not None) == (async_emit > 0)
        stream.start()
        prod = (JaxProducer if pkg == "jax" else Producer)(cluster, "t")
        for b in range(30):
            prod.send_batch([np.array([(b * 10 + j) % 3, float(b * 10 + j) * 1.25])
                             for j in range(10)],
                            timestamps=[1000.0 + (b * 10 + j) * 0.01 for j in range(10)])
            if crash_at is not None and b == crash_at:
                time.sleep(0.15)
                stream.crash()
                stream.recover()
        stream.await_windows(80, timeout=20)
        time.sleep(0.2)
        stream.stop()
        assert stream.stats.fired_windows == len(results)
        cluster.close()
        return sorted(results)

    base = run("jax", 0)
    assert run("torch", 0) == base
    assert run("torch", 3) == base
    crashed = run("torch", 3, crash_at=18)
    assert len(crashed) == len(set(crashed)), "duplicated window delivery"
    assert crashed == base


def test_taskpool_extend_and_shrink(svc):
    from repro_torch.core import PilotComputeDescription

    pilot = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 2, "type": "dask"})
    plugin = pilot.get_context()
    assert plugin.n_workers == 2
    ext = svc.submit_pilot(PilotComputeDescription(number_of_nodes=1, cores_per_node=2,
                                                   framework="dask", parent=pilot))
    assert plugin.n_workers == 4
    ext.cancel()
    assert plugin.n_workers == 2


def test_on_rescale_hook_gets_the_slots_devices_through_the_plugin(svc):
    cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
    cluster.create_topic("t", 1)
    pilot = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink"})
    seen: list = []
    stream = pilot.get_context().stream(
        cluster, "t", group="g", assigner=streaming.TumblingWindow(1.0),
        window_fn=lambda k, w, m: None, on_rescale=seen.append)
    stream.start()
    ext = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink",
                            "parent": pilot})
    assert seen == [[CPU, CPU]] and stream.store.owners == [0, 1]
    ext.cancel()
    assert seen == [[CPU, CPU], [CPU]] and stream.store.owners == [0]
    stream.stop()


def test_pipeline_continuous_stage_lag_probe_and_async_emit():
    """A continuous stage through the port's runner: the elastic
    controller's lag probe works, and ``async_emit`` reaches the stream."""
    import repro_torch.pipeline as torch_pipeline
    from repro_torch.miniapps import StreamSource

    @torch_pipeline.register_processor("cont_win_len")
    def win_len(key, window, msgs):
        return len(msgs)

    class Vec8(StreamSource):
        def make_message(self, rng, i):
            return rng.normal(size=(8,))

    torch_pipeline.register_source("cont_vec8", Vec8)
    spec = (torch_pipeline.Pipeline.named("contel")
            .topic("in", partitions=1)
            .source("in", kind="cont_vec8", rate_msgs_per_s=200, total_messages=12)
            .stage("s", topic="in", processor="cont_win_len", engine="continuous",
                   window={"window": "tumbling", "size": 0.05}, async_emit=3)
            .elastic("s", policy="threshold", high_lag=1e9, low_lag=0, interval=0.1)
            .build())
    with spec.run(devices=[CPU] * 2) as run:
        ctl, stream = run.controller("s"), run.stream("s")
        ctl.step()
        assert ctl._last_error is None and run.lag("s") >= 0.0
        assert stream.async_emit == 3 and stream._emit_window is not None
        run.await_windows("s", 1, timeout=20)
    assert run.errors == []
