"""The port's partitioned keyed state against the JAX package's: the same
partitions for the same keys, the same range assignments and moved
partitions, byte-equal partition snapshots that deserialize in either
package, and equal migration reports for the same migrations — by hand on
stores, and through pilots, where the port's owners are the pool's slots:
``[cpu] * 4`` slots move the partitions the JAX package moves between
devices ``[0, 1, 2, 3]``, on grow and on shrink of a middle slot. Then the
JAX package's always-run state cases, on the port."""
import dataclasses
import os
import random

import numpy as np
import pytest
import torch

import repro.state as jstate
import repro_torch.state as tstate
from repro.broker.consumer import Message as JMessage
from repro.core import PilotComputeService as JaxService
from repro.elastic import MetricsBus as JaxBus
from repro.streaming import TumblingWindow as JTumbling
from repro_torch.broker.consumer import Message
from repro_torch.core import PilotComputeService
from repro_torch.elastic import MetricsBus, MetricsSnapshot
from repro_torch.state import (
    LOCAL_OWNER,
    PartitionedStateStore,
    StateMigrator,
    deserialize_partition,
    moved_partitions,
    partition_for,
    range_assignment,
    serialize_partition,
)
from repro_torch.streaming import TumblingWindow

torch.set_num_threads(1)

CPU = torch.device("cpu")
PACKAGES = {"jax": (jstate, JMessage), "torch": (tstate, Message)}


def _keys(n: int, seed: int) -> list:
    rng = random.Random(seed)
    pool = []
    for j in range(n):
        kind = j % 8
        if kind == 0:
            pool.append(rng.randrange(-10**6, 10**6))
        elif kind == 1:
            pool.append(rng.uniform(-1e3, 1e3))
        elif kind == 2:
            pool.append(f"k{rng.randrange(10**5)}")
        elif kind == 3:
            pool.append((rng.randrange(50), f"s{rng.randrange(9)}"))
        elif kind == 4:
            pool.append(bytes([rng.randrange(256) for _ in range(rng.randrange(1, 6))]))
        elif kind == 5:
            pool.append(rng.choice([None, True, False, 2**70, -0.0, float(rng.randrange(99))]))
        elif kind == 6:
            pool.append(np.int64(rng.randrange(-500, 500)))
        else:
            pool.append(((rng.randrange(4), (rng.random(),)), "nested"))
    return pool


# -- key routing and assignment ------------------------------------------------


@pytest.mark.parametrize("n_partitions", [1, 7, 64, 256])
def test_partition_for_equals_the_jax_package(n_partitions):
    keys = _keys(3000, seed=n_partitions)
    ours = [partition_for(k, n_partitions) for k in keys]
    theirs = [jstate.partition_for(k, n_partitions) for k in keys]
    assert ours == theirs
    assert [tstate.key_bytes(k) for k in keys] == [jstate.key_bytes(k) for k in keys]


def test_range_assignment_and_moves_equal_the_jax_package_over_1_2_4_3():
    for n in (1, 7, 16, 64, 100):
        seq = [[0], [0, 1], [0, 1, 2, 3], [0, 1, 3]]
        prev_t = prev_j = None
        for owners in seq:
            a_t, a_j = range_assignment(n, owners), jstate.range_assignment(n, owners)
            assert a_t == a_j and sorted(a_t) == list(range(n))
            if prev_t is not None:
                assert moved_partitions(prev_t, a_t) == jstate.moved_partitions(prev_j, a_j)
            prev_t, prev_j = a_t, a_j
    with pytest.raises(ValueError):
        range_assignment(8, [])


# -- partition snapshots ----------------------------------------------------------


def _values(rng: np.random.Generator, j: int):
    kind = j % 6
    if kind == 0:
        return rng.normal(size=(5, 3))
    if kind == 1:
        return rng.normal(size=(4,)).astype(np.float32)
    if kind == 2:
        return {"a": [1, 2], "b": f"x{j}"}
    if kind == 3:
        return (j, "y", b"z")
    if kind == 4:
        return np.float64(j * 0.5)
    return None


def _fill(pkg: str, n_partitions: int, seed: int, n: int = 60):
    """The same appends, observes and late records into a store of
    ``pkg``."""
    mod, msg_cls = PACKAGES[pkg]
    store = mod.PartitionedStateStore(n_partitions, owners=[0])
    rng = np.random.default_rng(seed)
    keys = _keys(12, seed)
    for j in range(n):
        key = keys[j % len(keys)]
        ts = 100.0 + 0.25 * j
        w = (float(int(ts)), float(int(ts)) + 1.0)
        store.observe(key, ts)
        store.append(key, w, msg_cls(j % 3, j, ts, _values(rng, j)))
        if j % 11 == 0:
            store.record_late(key)
    return store


def test_serialized_partitions_are_byte_equal_and_cross_the_packages():
    s_t, s_j = _fill("torch", 16, 0), _fill("jax", 16, 0)
    for pid in range(16):
        b_t = serialize_partition(s_t.partitions[pid])
        b_j = jstate.serialize_partition(s_j.partitions[pid])
        assert b_t == b_j
        # each package reads the other's bytes back to its own snapshot
        assert serialize_partition(deserialize_partition(b_j)) == b_j
        assert jstate.serialize_partition(jstate.deserialize_partition(b_t)) == b_t


def _report(r) -> dict:
    d = dataclasses.asdict(r)
    d.pop("duration_ms")
    d.pop("spool_path")
    return d


def test_migration_reports_equal_the_jax_package(tmp_path):
    for seed in range(6):
        rnd = random.Random(seed)
        n = rnd.choice([8, 32, 64])
        stores = {pkg: _fill(pkg, n, seed) for pkg in PACKAGES}
        migs = {"torch": StateMigrator(str(tmp_path / f"t{seed}")),
                "jax": jstate.StateMigrator(str(tmp_path / f"j{seed}"))}
        for _ in range(5):
            owners = rnd.sample(range(10), rnd.randint(1, 6))
            r_t = migs["torch"].migrate(stores["torch"], owners)
            r_j = migs["jax"].migrate(stores["jax"], owners)
            assert _report(r_t) == _report(r_j)
            assert stores["torch"].assignment == stores["jax"].assignment
        for pid in range(n):
            assert serialize_partition(stores["torch"].partitions[pid]) == \
                jstate.serialize_partition(stores["jax"].partitions[pid])


# -- through pilots: slots of one device own like distinct devices ------------------


def _slot_run(pkg: str) -> list:
    """A flink pilot on 2 of a 4-entry pool, a 1-slot extension, another,
    then the first extension (a middle slot) cancelled; returns the
    migration reports."""
    svc = (PilotComputeService(devices=[CPU] * 4) if pkg == "torch"
           else JaxService(devices=list(range(4))))
    tumbling = TumblingWindow if pkg == "torch" else JTumbling
    try:
        kafka = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"})
        cluster = kafka.get_context()
        cluster.create_topic("st", 1)
        flink = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 2, "type": "flink"})
        stream = flink.get_context().stream(
            cluster, "st", group="g", assigner=tumbling(1.0),
            window_fn=lambda k, w, msgs: len(msgs), n_partitions=64)
        mod, msg_cls = PACKAGES[pkg]
        for j in range(40):  # state in every partition range
            stream.store.append(j, (0.0, 1.0), msg_cls(0, j, 0.5, np.array([float(j)])))
        stream.start()
        ext1 = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink",
                                 "parent": flink})
        svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink",
                          "parent": flink})
        ext1.cancel()
        reports = list(stream.migrator.reports)
        stream.stop()
    finally:
        svc.cancel()
    return reports


def test_cpu_slots_move_the_partitions_the_jax_package_moves_between_devices():
    ours, theirs = _slot_run("torch"), _slot_run("jax")
    assert [_report(r) for r in ours] == [_report(r) for r in theirs]
    assert [r.to_owners for r in ours] == [(0, 1, 2), (0, 1, 2, 3), (0, 1, 3)]
    assert all(r.moved for r in ours)  # every rescale moved state between slots


def test_plugin_shrink_drops_the_slot_that_left_not_an_equal_device():
    svc = PilotComputeService(devices=[CPU] * 4)
    try:
        flink = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink"})
        exts = [svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "flink",
                                  "parent": flink}) for _ in range(3)]
        plugin = flink.plugin
        assert plugin.slots == [0, 1, 2, 3] and plugin.devices == [CPU] * 4
        exts[1].cancel()
        assert plugin.slots == [0, 1, 3]
        assert sorted(svc.pool._free) == [2]
    finally:
        svc.cancel()
    assert svc.pool.leased_devices == 0


# -- the JAX package's always-run state cases, on the port ---------------------------


def _state_of(store):
    return {kw: [(m.offset, m.timestamp) for m in msgs] for kw, msgs in store.items()}


def test_partitioner_stability_and_numeric_folding():
    for key in [None, True, 0, -7, 2**70, 3.5, -0.0, "k", b"k", ("a", 1), ()]:
        p = partition_for(key, 64)
        assert 0 <= p < 64 and partition_for(key, 64) == p
    assert partition_for(3, 64) == partition_for(3.0, 64) == partition_for(np.int64(3), 64)
    assert partition_for(True, 64) == partition_for(1, 64)
    assert partition_for(2**53, 64) == partition_for(float(2**53), 64)
    assert partition_for(-0.0, 64) == partition_for(0, 64)


def test_seeded_migration_fuzz_no_loss_no_dup():
    for seed in range(30):
        rnd = random.Random(seed)
        n = rnd.choice([1, 8, 32, 64])
        store = PartitionedStateStore(n)
        for j in range(rnd.randint(1, 50)):
            key = rnd.choice([None, j % 7, f"k{j % 5}", (j % 3, "x"), float(j % 4), b"b"])
            w = (float(j % 5), float(j % 5) + 1.0)
            store.append(key, w, Message(0, j, 0.5 + j, np.array([float(j)])))
        snap = _state_of(store)
        migrator = StateMigrator()
        for _ in range(rnd.randint(1, 8)):
            owners = rnd.sample(range(10), rnd.randint(1, 6))
            report = migrator.migrate(store, owners)
            assert _state_of(store) == snap
            for (key, _w) in snap:
                assert store.owner_of(key) in owners
            for pid, part in store.partitions.items():
                for (k, _w) in part.buffers:
                    assert partition_for(k, n) == pid
            assert set(report.moved) <= set(range(n))
        migrator.cleanup()


def test_unmoved_partitions_keep_identity():
    store = PartitionedStateStore(32, owners=[0, 1])
    for j in range(40):
        store.append(f"k{j}", (0.0, 1.0), Message(0, j, 0.5, float(j)))
    before = dict(store.partitions)
    mig = StateMigrator()
    report = mig.migrate(store, [0, 1, 2])
    assert report.moved
    for pid in range(32):
        if pid in report.moved:
            assert store.partitions[pid] is not before[pid]
        else:
            assert store.partitions[pid] is before[pid]
    mig.cleanup()


def test_partition_counters_count_records_not_window_assignments():
    store = PartitionedStateStore(8)
    msg = Message(0, 0, 1.5, 1.0)
    store.observe("k", msg.timestamp)
    store.append("k", (0.0, 2.0), msg)
    store.append("k", (1.0, 3.0), msg)
    part = store.partitions[store.partition_of("k")]
    assert part.records == 1 and part.buffered_records == 2
    assert part.max_event_time == 1.5


def test_session_merge_order_is_migration_invariant():
    def build():
        s = PartitionedStateStore(8)
        s.append("k", (25.0, 35.0), Message(0, 2, 25.0, np.array([2.0])))
        s.append("k", (0.0, 18.0), Message(0, 0, 0.0, np.array([0.5])))
        s.append("k", (0.0, 18.0), Message(0, 1, 8.0, np.array([1.5])))
        return s
    plain = build()
    plain.merge_session("k", (0.0, 35.0))
    migrated = build()
    mig = StateMigrator()
    mig.migrate(migrated, [0, 1])
    mig.cleanup()
    migrated.merge_session("k", (0.0, 35.0))

    def order(s):
        return [m.offset for m in s.partitions[s.partition_of("k")].buffers[("k", (0.0, 35.0))]]
    assert order(plain) == order(migrated) == [0, 1, 2]


def test_arbitrary_hashable_keys_route_and_migrate():
    exotic = [frozenset({1, 2}), frozenset(), ("nested", frozenset({"x"}))]
    store = PartitionedStateStore(16)
    for j, key in enumerate(exotic):
        store.append(key, (0.0, 1.0), Message(0, j, 0.5, float(j)))
    snap = _state_of(store)
    mig = StateMigrator()
    mig.migrate(store, [0, 1, 2])
    mig.cleanup()
    assert _state_of(store) == snap
    fired = store.pop_ready(1.0)
    assert sorted(msgs[0].offset for (_, _, msgs) in fired) == [0, 1, 2]


def test_structured_dtype_values_survive_migration():
    rec = np.zeros(3, dtype=[("a", "<f4"), ("b", "<i4")])
    rec["a"] = [1.5, 2.5, 3.5]
    rec["b"] = [1, 2, 3]
    store = PartitionedStateStore(8)
    store.append("k", (0.0, 1.0), Message(0, 0, 0.5, rec))
    mig = StateMigrator()
    mig.migrate(store, [0, 1])
    mig.cleanup()
    ((_, msgs),) = list(store.items())
    got = msgs[0].value
    assert got.dtype == rec.dtype and np.array_equal(got, rec)


def test_empty_owner_set_falls_back_to_local():
    store = PartitionedStateStore(8)
    assert store.owners == [LOCAL_OWNER]
    StateMigrator().migrate(store, [])
    assert store.owners == [LOCAL_OWNER]


def test_migrator_spool_is_atomic_and_bounded(tmp_path):
    store = PartitionedStateStore(16, owners=[0])
    for j in range(20):
        store.append(f"k{j}", (0.0, 1.0), Message(0, j, 0.5, float(j)))
    mig = StateMigrator(directory=str(tmp_path), keep_last=2)
    for owners in ([0, 1], [0, 1, 2], [0], [0, 3]):
        mig.migrate(store, owners)
    names = sorted(os.listdir(tmp_path))
    assert all(not n.endswith(".tmp") for n in names)
    assert len([n for n in names if n.startswith("migration_")]) <= 2
    mig.cleanup()
    assert os.path.isdir(tmp_path)


def test_migrator_cleans_up_its_own_tempdir():
    store = PartitionedStateStore(8, owners=[0])
    store.append("k", (0.0, 1.0), Message(0, 0, 0.5, 1.0))
    mig = StateMigrator()
    mig.migrate(store, [0, 1])
    spool_root = mig.directory
    assert spool_root is not None and os.path.isdir(spool_root)
    mig.cleanup()
    assert not os.path.exists(spool_root)
    mig.cleanup()
    mig.migrate(store, [0])


def test_migrator_publishes_gauges_like_the_jax_package():
    values = {}
    for pkg, bus in (("torch", MetricsBus()), ("jax", JaxBus())):
        mod, msg_cls = PACKAGES[pkg]
        store = mod.PartitionedStateStore(16, owners=[0])
        for j in range(10):
            store.append(j, (0.0, 1.0), msg_cls(0, j, 0.5, float(j)))
        mig = mod.StateMigrator(bus=bus, label="s1")
        report = mig.migrate(store, [0, 1])
        mig.cleanup()
        assert bus.value("state.migration_ms", stream="s1") == pytest.approx(report.duration_ms)
        values[pkg] = (bus.value("state.migrated_partitions", stream="s1"),
                       bus.value("state.bytes_moved", stream="s1"))
        if pkg == "torch":
            snap = MetricsSnapshot.capture(bus, stream="s1")
            assert snap.state_migration_ms == pytest.approx(report.duration_ms)
    assert values["torch"] == values["jax"]
