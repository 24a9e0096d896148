"""Broker plugin: manage a Kafka-analog cluster through the Pilot API.

``pilot.get_context()`` returns the BrokerCluster (the paper's Listing 6
native-client escape hatch). ``extend``/``shrink`` add/remove broker nodes
with automatic partition rebalancing; ``on_failure`` is an involuntary
shrink.
"""
from __future__ import annotations

from repro_torch.broker.cluster import BrokerCluster
from repro_torch.core.plugin import Lease, ManagerPlugin, register_plugin


@register_plugin("broker")
@register_plugin("kafka")  # paper naming convenience
class BrokerPlugin(ManagerPlugin):
    USES_DEVICES = False

    def __init__(self, pcd):
        super().__init__(pcd)
        self.cluster: BrokerCluster | None = None
        self._lease_nodes: dict[int, list[int]] = {}

    def submit_job(self, lease: Lease) -> None:
        io_rate = self.pcd.config.get("io_rate_per_node")
        self.cluster = BrokerCluster(n_nodes=0, io_rate_per_node=io_rate)
        ids = [self.cluster.add_node() for _ in lease.nodes]
        self._lease_nodes[lease.lease_id] = ids

    def wait(self) -> None:
        assert self.cluster is not None

    def extend(self, lease: Lease) -> None:
        ids = [self.cluster.add_node() for _ in lease.nodes]
        self._lease_nodes[lease.lease_id] = ids

    def shrink(self, lease: Lease) -> None:
        for nid in self._lease_nodes.pop(lease.lease_id, []):
            self.cluster.remove_node(nid)

    def on_failure(self, lease: Lease) -> None:
        for nid in self._lease_nodes.pop(lease.lease_id, []):
            self.cluster.fail_node(nid)

    def cancel(self) -> None:
        """Close all logs — a cancelled broker pilot wakes every blocked
        producer and consumer."""
        if self.cluster is not None:
            self.cluster.close()

    def get_context(self, configuration: dict | None = None) -> BrokerCluster:
        return self.cluster

    def get_config_data(self) -> dict:
        return {"n_nodes": self.cluster.n_nodes if self.cluster else 0, **self.pcd.config}
