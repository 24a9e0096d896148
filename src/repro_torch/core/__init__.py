"""Pilot abstraction (paper §4): service, pilots, compute units, plugin SPI."""
from repro_torch.core.compute_unit import ComputeUnit, CUState
from repro_torch.core.description import PilotComputeDescription
from repro_torch.core.plugin import Lease, ManagerPlugin, plugin_class, register_plugin, registered_plugins
from repro_torch.core.service import DevicePool, Pilot, PilotComputeService, PilotState

# importing the engines registers this slice's two plugins: the broker
# ("kafka") and the micro-batch engine ("spark")
import repro_torch.engines  # noqa: E402,F401

__all__ = [
    "CUState",
    "ComputeUnit",
    "DevicePool",
    "Lease",
    "ManagerPlugin",
    "Pilot",
    "PilotComputeDescription",
    "PilotComputeService",
    "PilotState",
    "plugin_class",
    "register_plugin",
    "registered_plugins",
]
