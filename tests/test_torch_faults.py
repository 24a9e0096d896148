"""The port's fault injection and recovery against the JAX package's: the
schedule DSL parses to the same specs and the injector records the same
events; seeded faults against a live keyed stream (a pilot kill recovered
by the runner's StageReconciler, a false-positive heartbeat loss, a broker
leader kill with a blackout, a slow consumer) fire the JAX package's
undisturbed windows bitwise; and the JAX package's preemption scenarios —
the controller's park and unpark, and a checkpointing continuous stage of
a ``PipelineSpec`` parked by a higher-priority tenant and resumed with
zero lost or duplicated firings — through the port's runner."""
import threading
import time

import numpy as np
import pytest
import torch

import repro.faults as jax_faults
import repro_torch.pipeline as torch_pipeline
from repro.broker import BrokerCluster as JaxCluster, Producer as JaxProducer
from repro.broker.records import Record as JaxRecord
from repro.core import PilotComputeService as JaxService
from repro.pipeline.runner import StageReconciler as JaxReconciler
from repro.streaming import TumblingWindow as JaxTumbling
from repro_torch.broker import BrokerCluster, Consumer, ConsumerGroup, Producer, Record
from repro_torch.core import PilotComputeService
from repro_torch.elastic import (
    ElasticConfig,
    ElasticController,
    MetricsBus,
    PreemptionHooks,
    ThresholdHysteresisPolicy,
)
from repro_torch.faults import KINDS, FaultInjector, FaultSchedule, FaultSpec
from repro_torch.pipeline.runner import StageReconciler
from repro_torch.scheduler import PoolTenant
from repro_torch.streaming import TumblingWindow
from repro_torch.transport import ShmTransport
from repro_torch.workers import WorkerSupervisor

torch.set_num_threads(1)

CPU = torch.device("cpu")


# -- schedule DSL and injector, against the JAX package ------------------------------

TEXT = """
    # leader election mid-stream
    kill_broker_node @records=500 node=leader blackout=0.2
    kill_pilot       @records=900 ; slow_consumer @watermark=1003.5 delay=0.01 until_records=1200
    drop_heartbeats @records=5; delay_io @records=10 delay=0.005 until_records=20
    """


def _spec_tuple(s) -> tuple:
    return (s.kind, s.at_records, s.at_watermark, s.params, s.trigger)


def test_schedule_parse_equals_the_jax_package():
    ours, theirs = FaultSchedule.parse(TEXT), jax_faults.FaultSchedule.parse(TEXT)
    assert [_spec_tuple(s) for s in ours] == [_spec_tuple(s) for s in theirs]
    assert len(ours) == 5 and repr(ours) == repr(theirs)
    kb = list(ours)[0]
    assert kb.params == {"node": "leader", "blackout": 0.2}
    assert KINDS == jax_faults.KINDS


def test_schedule_fluent_matches_parsed():
    parsed = FaultSchedule.parse("delay_io @records=10 delay=0.005 until_records=20")
    built = FaultSchedule().delay_io(at_records=10, delay=0.005, until_records=20)
    assert list(parsed) == list(built)
    built = (FaultSchedule().kill_broker_node(at_records=1, node=2).kill_pilot(at_watermark=3.0)
             .slow_consumer(at_records=4, delay=0.1).drop_heartbeats(at_records=5))
    assert [s.kind for s in built] == ["kill_broker_node", "kill_pilot", "slow_consumer",
                                       "drop_heartbeats"]


def test_spec_validation_and_triggers():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("explode", at_records=1)
    with pytest.raises(ValueError, match="exactly one"):
        FaultSpec("kill_pilot")
    with pytest.raises(ValueError, match="exactly one"):
        FaultSpec("kill_pilot", at_records=1, at_watermark=2.0)
    with pytest.raises(ValueError, match="cannot parse token"):
        FaultSchedule.parse("kill_pilot @records=1 garbage")
    by_rec = FaultSpec("kill_pilot", at_records=100)
    assert not by_rec.due(99, float("inf")) and by_rec.due(100, float("-inf"))
    by_wm = FaultSpec("kill_pilot", at_watermark=5.0)
    assert not by_wm.due(10**9, 4.9) and by_wm.due(0, 5.0)
    assert by_wm.trigger == "watermark>=5.0"


def _injector_events(pkg: str) -> list:
    """delay_io (timed) and slow_consumer (timed) fired and reverted at
    fixed record counts, kill_broker_node on the partition leader, and a
    drop_heartbeats with no service bound (its failure is recorded)."""
    faults = jax_faults if pkg == "jax" else None
    cluster_cls = JaxCluster if pkg == "jax" else BrokerCluster
    cluster = cluster_cls(3)
    cluster.create_topic("t", 1, replication_factor=2)
    if pkg == "jax":
        from repro.broker import Consumer as C, ConsumerGroup as G
        schedule_cls, injector_cls = faults.FaultSchedule, faults.FaultInjector
    else:
        C, G = Consumer, ConsumerGroup
        schedule_cls, injector_cls = FaultSchedule, FaultInjector
    consumer = C(cluster, G(cluster, "g", "t"), "m")
    records = [0]
    sched = schedule_cls.parse(
        "delay_io @records=10 delay=0.003 until_records=20; "
        "slow_consumer @records=12 delay=0.004 until_records=30; "
        "kill_broker_node @records=15 node=leader; drop_heartbeats @records=16")
    inj = injector_cls(sched, cluster=cluster, topic="t", consumer=consumer,
                       records_fn=lambda: records[0], watermark_fn=lambda: float("-inf"))
    inj.start()
    for n, wait_for in ((10, lambda: cluster.io_delay > 0), (16, lambda: inj.fired == 4),
                        (25, lambda: cluster.io_delay == 0.0), (40, inj._done.is_set)):
        records[0] = n
        deadline = time.monotonic() + 5
        while not wait_for():
            assert time.monotonic() < deadline, (pkg, n, inj.events)
            time.sleep(0.002)
    inj.stop()
    assert consumer.injected_poll_delay == 0.0 and cluster.io_delay == 0.0
    return [(e.kind, e.trigger, e.records, e.detail) for e in inj.events]


def test_injector_events_equal_the_jax_package():
    ours, theirs = _injector_events("torch"), _injector_events("jax")
    assert [e[:3] for e in ours] == [e[:3] for e in theirs]
    # details equal but for the exception text of the unbound service
    for a, b in zip(ours, theirs):
        if a[0] == "drop_heartbeats":
            assert a[3].startswith("action failed:") and b[3].startswith("action failed:")
        else:
            assert a[3] == b[3]
    assert [e[0] for e in ours].count("delay_io") == 2  # fired and reverted


def test_injector_action_override():
    seen = []
    inj = FaultInjector(
        FaultSchedule().kill_pilot(at_records=1), records_fn=lambda: 5,
        watermark_fn=lambda: 0.0,
        actions={"kill_pilot": lambda injector, spec: seen.append(spec.kind) or "custom"},
    ).start()
    assert inj.wait(2.0)
    inj.stop()
    assert seen == ["kill_pilot"] and inj.events[0].detail == "custom"


def test_inject_failure_fires_monitor_callbacks():
    svc = PilotComputeService(devices=[CPU] * 2, heartbeat_interval=0.05,
                              heartbeat_timeout=0.1)
    try:
        pilot = svc.submit_pilot({"number_of_nodes": 1, "type": "flink"})
        failed = []
        svc.monitor.on_failure(failed.append)
        svc.inject_failure(pilot)
        deadline = time.monotonic() + 3
        while not failed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert failed and failed[0] is pilot
    finally:
        svc.cancel()


# -- seeded faults on a live stream: the JAX package's undisturbed windows ---------

N_MSGS = 1200
DT, WINDOW, N_KEYS, BASE_TS = 0.01, 0.1, 5, 1000.0
EXPECTED_WINDOWS = (int(N_MSGS * DT / WINDOW) - 1) * N_KEYS


def _window_fn(key, w, msgs):
    vals = np.array([m.value[1] for m in msgs], dtype=np.float64)
    return key, w, float(np.sum(vals)), len(msgs)


def _chaos(pkg: str, schedule: str | None = None, *, broker_nodes=1, replication_factor=1,
           checkpoint_every=0, reconcile=False, executor="inline",
           transport=None) -> tuple[dict, dict]:
    """One keyed stream fed live (ten records every 5 ms) under an
    optional fault schedule, bound by a FaultInjector (and recovered by a
    StageReconciler when ``reconcile``). ``executor="mp"`` runs its
    partitions in worker processes; ``transport="shm"`` mounts a ring on
    the topic and sends each ten records as one frame."""
    jax = pkg == "jax"
    svc = (JaxService(devices=list(range(10)), heartbeat_interval=0.05, heartbeat_timeout=0.25)
           if jax else PilotComputeService(devices=[CPU] * 10, heartbeat_interval=0.05,
                                           heartbeat_timeout=0.25))
    bus = MetricsBus() if not jax else None
    results: dict = {}
    injector = reconciler = None
    recovered: list = []  # the replacement pilots
    pcd = {"number_of_nodes": 1, "cores_per_node": 2, "type": "flink"}
    try:
        cluster = svc.submit_pilot({"number_of_nodes": broker_nodes,
                                    "type": "kafka"}).get_context()
        cluster.create_topic("chaos", 1, replication_factor=replication_factor)
        ring_name = None
        if transport == "shm":
            shm = ShmTransport(slot_bytes=1 << 16, n_slots=64)
            cluster.attach_transport(shm)
            ring_name = shm.mount("chaos").name
        flink = svc.submit_pilot(pcd)
        first_slots = list(flink.plugin.slots) if not jax else None
        stream = flink.get_context().stream(
            cluster, "chaos", group="g", assigner=(JaxTumbling if jax else TumblingWindow)(WINDOW),
            window_fn=_window_fn, key_fn=lambda m: int(m.value[0]),
            emit=lambda out: results.__setitem__((out[0], out[1]), (out[2], out[3])),
            metrics=bus, checkpoint_every=checkpoint_every,
            **({"executor": executor, "worker_options": {"snapshot_every": 8}}
               if executor == "mp" else {}))
        stream.start()
        if reconcile:
            reconciler = (JaxReconciler if jax else StageReconciler)(
                svc, bus=bus, on_recovered=lambda name, p: recovered.append(p))
            reconciler.manage("chaos", flink, stream, pcd)
        producer = (JaxProducer if jax else Producer)(cluster, "chaos", serializer="npy")

        def feed():
            for lo in range(0, N_MSGS, 10):
                idx = range(lo, lo + 10)
                vals = [np.array([i % N_KEYS, float(i) * 1.25]) for i in idx]
                stamps = [BASE_TS + i * DT for i in idx]
                if transport == "shm":
                    producer.send_batch(vals, timestamps=stamps)
                else:
                    for v, ts in zip(vals, stamps):
                        producer.send(v, timestamp=ts)
                time.sleep(0.005)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        if schedule is not None:
            injector = FaultInjector(FaultSchedule.parse(schedule), seed=1, cluster=cluster,
                                     topic="chaos", stream=stream, service=svc,
                                     pilot=flink).start()
        deadline = time.monotonic() + 60
        while stream.stats.fired_windows < EXPECTED_WINDOWS:
            assert time.monotonic() < deadline, (
                f"{stream.stats.fired_windows}/{EXPECTED_WINDOWS} windows fired; events="
                f"{injector.events if injector else []}; recovery errors="
                f"{reconciler.errors if reconciler else []}")
            time.sleep(0.02)
        feeder.join(10)
        if injector is not None:
            injector.stop()
        if reconciler is not None:
            reconciler.close()
        stream.stop()
        info = {"fired": stream.stats.fired_windows, "late": stream.stats.late_records,
                "failovers": cluster.failovers, "lost": cluster.lost_records,
                "cons_retries": stream.consumer.retries,
                "poll_delay": stream.consumer.injected_poll_delay,
                "recoveries": stream.recoveries,
                "stage_recoveries": reconciler.recoveries if reconciler else 0,
                "events": list(injector.events) if injector else [], "bus": bus,
                "first_slots": first_slots, "owners": list(stream.store.owners),
                "new_slots": [list(p.plugin.slots) for p in recovered],
                "ring_name": ring_name,
                "copied_out": getattr(producer, "copied_out_records", 0),
                "restarts": stream.runtime.restarts if getattr(stream, "runtime", None) else 0}
    finally:
        svc.cancel()
    return results, info


@pytest.fixture(scope="module")
def baseline():
    results, info = _chaos("jax")
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS == len(results)
    return results


def _assert_bitwise(base: dict, other: dict, label: str) -> None:
    assert other.keys() == base.keys(), label
    for kw, agg in base.items():
        assert other[kw] == agg, f"{label}: window {kw}"


@pytest.mark.parametrize("schedule", ["kill_pilot @records=350", "kill_pilot @records=820",
                                      "drop_heartbeats @records=650"])
def test_pilot_loss_is_recovered_by_the_reconciler_bitwise(baseline, schedule):
    """A pilot crash, or a healthy pilot whose heartbeats stop: the
    reconciler fences, reprovisions and recovers from the checkpoint
    spool; zero lost, zero duplicated."""
    results, info = _chaos("torch", schedule, checkpoint_every=100, reconcile=True)
    assert info["recoveries"] >= 1 and info["stage_recoveries"] >= 1, info["events"]
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS
    assert info["bus"].value("pipeline.stage_recoveries", stage="chaos") >= 1
    assert info["bus"].value("stream.recovery_ms", stream="chaos") >= 0.0
    _assert_bitwise(baseline, results, schedule)


def test_reconciler_recovery_rehomes_onto_the_new_pilots_slots(baseline):
    """ROADMAP C6, closed in the port: after the reconciler's recovery the
    partitions belong to the replacement pilot's slots, not the dead
    pilot's, and every firing is still the JAX package's."""
    results, info = _chaos("torch", "kill_pilot @records=350", checkpoint_every=100,
                           reconcile=True)
    assert info["stage_recoveries"] >= 1 and info["new_slots"], info["events"]
    assert info["owners"] == info["new_slots"][-1] != info["first_slots"]
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS
    _assert_bitwise(baseline, results, "rehomed")


def test_kill_pilot_mp_executor_recovers(baseline):
    """A pilot crash with the partitions in worker processes: the crash
    kills the workers; recover() restores the host store from the spool,
    seeds a fresh worker fleet from it, and the rescale onto the new
    pilot's slots moves them between processes. Bitwise the JAX package's."""
    results, info = _chaos("torch", "kill_pilot @records=600", checkpoint_every=100,
                           reconcile=True, executor="mp")
    assert info["recoveries"] >= 1 and info["stage_recoveries"] >= 1, info["events"]
    assert info["owners"] == info["new_slots"][-1]
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS
    _assert_bitwise(baseline, results, "mp pilot kill")


def test_kill_pilot_shm_transport_recovers_and_cleans_ring(baseline):
    """A pilot crash while the stream rides the shared-memory ring: the
    replay floor (pinned at each checkpoint) held every slot the recovery
    replays, nothing was copied out, the firings are the JAX package's log
    run's, and the service's teardown unlinked the ring's segment."""
    from multiprocessing import shared_memory

    results, info = _chaos("torch", "kill_pilot @records=600", checkpoint_every=100,
                           reconcile=True, transport="shm")
    assert info["recoveries"] >= 1 and info["stage_recoveries"] >= 1, info["events"]
    assert info["lost"] == 0 and info["copied_out"] == 0
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS
    _assert_bitwise(baseline, results, "shm pilot kill")
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(info["ring_name"])


def test_broker_leader_kill_fails_over_without_drift(baseline):
    results, info = _chaos("torch", "kill_broker_node @records=500 node=leader blackout=0.25",
                           broker_nodes=3, replication_factor=2)
    assert info["failovers"] >= 1 and info["lost"] == 0, info["events"]
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS
    _assert_bitwise(baseline, results, "broker kill")


def test_slow_consumer_degrades_without_drift(baseline):
    results, info = _chaos("torch", "slow_consumer @records=300 delay=0.02 until_records=600")
    fired = [e for e in info["events"] if e.detail != "reverted"]
    reverted = [e for e in info["events"] if e.detail == "reverted"]
    assert len(fired) == 1 and len(reverted) == 1, info["events"]
    assert info["poll_delay"] == 0.0
    assert info["late"] == 0 and info["fired"] == EXPECTED_WINDOWS
    _assert_bitwise(baseline, results, "slow consumer")


# -- preemption: the controller's park and unpark, and a stage of a spec ----------------


def test_scale_to_zero_parks_and_regrant_unparks():
    svc = PilotComputeService(devices=[CPU] * 4)
    try:
        pilot = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink"})
        calls = []
        bus = MetricsBus()
        ctl = ElasticController(
            svc, pilot, bus, ThresholdHysteresisPolicy(high_lag=1e9, low_lag=-1.0),
            config=ElasticConfig(min_devices=0, cooldown=0.0),
            hooks=PreemptionHooks(checkpoint=lambda: calls.append("checkpoint"),
                                  kill=lambda: calls.append("kill"),
                                  resume=lambda p: calls.append("resume")))
        ctl.scale_to(3)
        assert ctl.devices == 3
        assert ctl.scale_to(0) == 0 and ctl.parked
        assert calls == ["checkpoint", "kill"]
        assert svc.pool.leased_devices == 0 and bus.value("elastic.parked") == 1.0
        assert ctl.scale_to(0) == 0 and calls == ["checkpoint", "kill"]
        assert ctl.scale_to(2) == 2 and not ctl.parked and calls[-1] == "resume"
        assert bus.value("elastic.parked") == 0.0
        actions = [e.action for e in ctl.events]
        assert "park" in actions and "unpark" in actions
    finally:
        svc.cancel()


N_RECORDS = 300
PREEMPT_WINDOWS = 29 * 3  # 3.0 s of 0.1 s windows x 3 keys


def _append(cluster, record_cls, i):
    cluster.append("t", 0, record_cls(bytes([i % 3]), None, 1000.0 + i * 0.01))


def _jax_preemption_baseline() -> dict:
    """The JAX package's undisturbed stage on the same trace."""
    svc = JaxService(devices=[0])
    results: dict = {}
    try:
        cluster = JaxCluster(1)
        cluster.create_topic("t", 1)
        for i in range(N_RECORDS):
            _append(cluster, JaxRecord, i)
        pilot = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink"})
        stream = pilot.get_context().stream(
            cluster, "t", group="g", assigner=JaxTumbling(0.1),
            window_fn=lambda key, w, msgs: (key, w, len(msgs)),
            key_fn=lambda m: m.value[0] % 3,
            emit=lambda out: results.__setitem__((out[0], out[1]), out[2]),
            checkpoint_every=50)
        stream.start()
        deadline = time.monotonic() + 30
        while stream.stats.fired_windows < PREEMPT_WINDOWS:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        stream.stop()
    finally:
        svc.cancel()
    return results


class _Counted:
    """A keyed window processor collecting each firing it is handed."""

    results: dict = {}

    def process(self, key, w, msgs):
        return key, w, len(msgs)

    def key_fn(self, m):
        return m.value[0] % 3

    def emit(self, out):
        assert (out[0], out[1]) not in _Counted.results, f"duplicate firing {out}"
        _Counted.results[(out[0], out[1])] = out[2]


torch_pipeline.register_processor("faults_counted", _Counted)


def test_preempted_pipeline_stage_resumes_with_zero_lost_or_duplicated_firings():
    """A checkpointing continuous stage of a ``PipelineSpec`` loses both
    slots to a higher-priority tenant mid-stream: the runner's hooks park
    it (checkpoint, fence, cancel), the tenant leaves, the regrant resumes
    it from the pre-kill spool. Its firings equal the JAX package's
    undisturbed stage's."""
    baseline = _jax_preemption_baseline()
    assert len(baseline) == PREEMPT_WINDOWS
    _Counted.results = {}
    spec = (torch_pipeline.Pipeline.named("pre").topic("t", partitions=1)
            .stage("s", topic="t", processor="faults_counted", engine="continuous",
                   window={"window": "tumbling", "size": 0.1}, checkpoint_every=50)
            .elastic("s", policy="threshold", high_lag=1e9, low_lag=-1.0, min_devices=0,
                     max_devices=2, cooldown=0.0, preemptible=True)
            .build())
    with spec.run(devices=[CPU] * 2) as run:
        stream, ctl, arb = run.stream("s"), run.controller("s"), run.arbiter

        def feed():
            for i in range(N_RECORDS):
                _append(run.cluster, Record, i)
                time.sleep(0.002)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        deadline = time.monotonic() + 30
        while stream.stats.fired_windows < 30:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        hi = PoolTenant(run.service)
        arb.submit(hi.request("hi", min_devices=0, priority=1))
        arb.update("hi", 2)
        arb.reconcile()
        assert ctl.parked and ctl.devices == 0 and hi.devices == 2
        fired_at_park = stream.stats.fired_windows
        assert fired_at_park < PREEMPT_WINDOWS, "preemption landed too late to prove anything"
        time.sleep(0.05)
        assert stream.stats.fired_windows == fired_at_park, "parked stream kept firing"
        feeder.join(timeout=10)
        arb.update("hi", 0)
        arb.reconcile()
        assert not ctl.parked and ctl.devices >= 1 and stream.recoveries == 1
        while stream.stats.fired_windows < PREEMPT_WINDOWS:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        hi.close()
    assert run.errors == [] and run.service.pool.leased_devices == 0
    assert _Counted.results == baseline


# -- the worker supervisor's restart backoff ----------------------------------------------


class _NullMonitor:
    def watch(self, *a, **kw):
        pass

    def unwatch(self, *a, **kw):
        pass


class _FakeSup(WorkerSupervisor):
    """Backoff policy under test, process machinery stubbed out."""

    def spawn(self, wait=True):
        return self

    def kill(self):
        pass


def test_respawn_storm_backs_off_exponentially_with_cap():
    sup = _FakeSup(0, owner=None, window_fn=None, monitor=_NullMonitor(),
                   ctx=None, restart_backoff=0.01, restart_backoff_cap=0.04)
    t0 = time.monotonic()
    delays = [sup.respawn().last_backoff_s for _ in range(5)]
    storm = time.monotonic() - t0
    # the first restart of a streak is immediate; then 0.01, 0.02, 0.04, 0.04 (cap)
    assert delays == [0.0, 0.01, 0.02, 0.04, 0.04]
    assert sup.restarts == 5
    assert storm >= 0.11  # the storm actually waited, not just recorded
    # a worker that survived a while gets an immediate restart again
    time.sleep(sup.restart_backoff_cap * 2 + 0.02)
    assert sup.respawn().last_backoff_s == 0.0


def test_isolated_crash_restarts_immediately():
    sup = _FakeSup(0, owner=None, window_fn=None, monitor=_NullMonitor(),
                   ctx=None, restart_backoff=0.5, restart_backoff_cap=5.0)
    t0 = time.monotonic()
    sup.respawn()
    assert time.monotonic() - t0 < 0.1
    assert sup.last_backoff_s == 0.0
