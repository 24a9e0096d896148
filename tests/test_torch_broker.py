"""The port's copy of the log-plane broker and pilot layer: the behaviours
the Mini-App path and the paper's Listings 2/4 rely on."""
import numpy as np
import pytest
import torch

from repro_torch.broker import BrokerCluster, BrokerTimeout, Consumer, ConsumerGroup, Producer
from repro_torch.core import PilotComputeDescription, PilotComputeService, registered_plugins

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _consume_all(consumer, n, timeout=5.0):
    got = []
    while len(got) < n:
        batch = consumer.poll(timeout=timeout)
        assert batch, f"stalled at {len(got)}/{n}"
        got.extend(batch)
    return got


def test_npy_round_trip_and_lag():
    cluster = BrokerCluster(2)
    cluster.create_topic("t", 3)
    prod = Producer(cluster, "t")
    arrays = [np.arange(i, i + 6, dtype=np.float64).reshape(2, 3) for i in range(9)]
    for a in arrays:
        prod.send(a)
    consumer = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m")
    got = _consume_all(consumer, 9)
    assert sorted(m.value.sum() for m in got) == sorted(a.sum() for a in arrays)
    assert sum(cluster.lag("g", "t").values()) == 9
    consumer.commit()
    assert sum(cluster.lag("g", "t").values()) == 0


def test_group_range_assignment_splits_partitions():
    cluster = BrokerCluster(1)
    cluster.create_topic("t", 5)
    group = ConsumerGroup(cluster, "g", "t")
    a, b = Consumer(cluster, group, "a"), Consumer(cluster, group, "b")
    assert a.assignment == [0, 1, 2] and b.assignment == [3, 4]
    b.close()
    assert a.assignment == [0, 1, 2, 3, 4]


def test_replicated_topic_survives_leader_loss():
    cluster = BrokerCluster(3)
    cluster.create_topic("t", 2, replication_factor=2)
    prod = Producer(cluster, "t", serializer="raw")
    for i in range(10):
        prod.send(bytes([i]))
    leader = cluster.topic("t").leaders[0]
    cluster.fail_node(leader)
    assert cluster.failovers >= 1 and cluster.lost_records == 0
    consumer = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m", deserialize=False)
    assert sorted(m.value for m in _consume_all(consumer, 10)) == [bytes([i]) for i in range(10)]


def test_send_timeout_raises_during_blackout():
    cluster = BrokerCluster(2)
    cluster.create_topic("t", 1)
    cluster.fail_node(cluster.topic("t").leaders[0], blackout=5.0)
    prod = Producer(cluster, "t", serializer="raw", send_timeout=0.2, retry_timeout=0.2)
    with pytest.raises(BrokerTimeout):
        prod.send(b"x")


def test_pilots_lease_devices_and_extend():
    assert {"kafka", "spark"} <= set(registered_plugins())
    cpu = torch.device("cpu")
    svc = PilotComputeService(devices=[cpu, cpu, cpu])
    try:
        broker = svc.submit_pilot({"number_of_nodes": 2, "type": "kafka"})
        assert broker.get_context().n_nodes == 2 and svc.pool.leased_devices == 0
        spark = svc.submit_pilot({"number_of_nodes": 1, "type": "spark"})
        assert spark.get_context().devices == [cpu] and svc.pool.free_devices == 2
        ext = svc.submit_pilot(PilotComputeDescription(
            number_of_nodes=2, framework="spark", parent=spark))
        assert len(spark.get_context().devices) == 3
        ext.cancel()
        assert len(spark.get_context().devices) == 1 and svc.pool.free_devices == 2
    finally:
        svc.cancel()
