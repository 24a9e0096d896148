"""ManagerPlugin SPI — the paper's Listing 1, verbatim method set (+shrink).

A framework plugin encapsulates everything Pilot-Streaming needs to manage
one kind of cluster (Kafka-analog broker, micro-batch engine, continuous
engine, task pool): provisioning, readiness, elastic extension and the
native-context escape hatch (Listing 6).
"""
from __future__ import annotations

import abc
from typing import Any, Callable

from repro_torch.core.compute_unit import ComputeUnit
from repro_torch.core.description import PilotComputeDescription

_REGISTRY: dict[str, type["ManagerPlugin"]] = {}


def register_plugin(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        return cls

    return deco


def plugin_class(name: str) -> type["ManagerPlugin"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no plugin {name!r}; registered: {sorted(_REGISTRY)}") from None


def registered_plugins() -> list[str]:
    return sorted(_REGISTRY)


class ManagerPlugin(abc.ABC):
    """Paper Listing 1 interface."""

    def __init__(self, pilot_compute_description: PilotComputeDescription):
        self.pcd = pilot_compute_description

    @abc.abstractmethod
    def submit_job(self, lease: "Lease") -> None:
        """Provision the framework on the lease (bootstrap script analog)."""

    @abc.abstractmethod
    def wait(self) -> None:
        """Block until the framework is ready to accept work."""

    @abc.abstractmethod
    def extend(self, lease: "Lease") -> None:
        """Add resources to the running cluster (paper Listing 4)."""

    def shrink(self, lease: "Lease") -> None:
        """Remove previously-extended resources (voluntary or failure)."""
        raise NotImplementedError(f"{type(self).__name__} cannot shrink")

    @abc.abstractmethod
    def get_context(self, configuration: dict | None = None) -> Any:
        """Native framework handle (paper Listing 6)."""

    def get_config_data(self) -> dict:
        return dict(self.pcd.config)

    # -- compute units (Listing 5) -----------------------------------------

    def run_cu(self, cu: ComputeUnit) -> ComputeUnit:
        raise NotImplementedError(f"{type(self).__name__} does not execute CUs")

    # -- lifecycle ----------------------------------------------------------

    def cancel(self) -> None:
        pass

    def on_failure(self, lease: "Lease") -> None:
        """Resources died involuntarily; rebalance/recover."""
        self.shrink(lease)


class Lease:
    """A slice of the resource pool held by one pilot."""

    def __init__(self, lease_id: int, devices: list, nodes: list[int]):
        self.lease_id = lease_id
        self.devices = devices  # torch.device entries (compute plugins)
        self.nodes = nodes  # logical host slots (broker plugin)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Lease({self.lease_id}, devices={len(self.devices)}, nodes={self.nodes})"
