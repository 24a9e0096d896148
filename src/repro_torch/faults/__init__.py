"""repro_torch.faults — deterministic seeded fault injection.

The chaos harness for the robustness layer: declare *what* breaks and
*when* (in the stream's logical coordinates — record counts or
watermarks) in a :class:`FaultSchedule`, bind it to a live pipeline with a
:class:`FaultInjector`, and assert the run's outputs are bit-identical to
a fault-free baseline (tests/test_torch_faults.py, and the continuous
phase of ``chip_smoke.py`` on the card).
"""
from repro_torch.faults.injector import FaultEvent, FaultInjector
from repro_torch.faults.schedule import KINDS, FaultSchedule, FaultSpec

__all__ = [
    "KINDS",
    "FaultEvent",
    "FaultInjector",
    "FaultSchedule",
    "FaultSpec",
]
