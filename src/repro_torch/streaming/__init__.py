from repro_torch.streaming.dispatch import AsyncWindow, LatencyWindow, completion_event
from repro_torch.streaming.rate_control import PIDRateController

__all__ = [
    "AsyncWindow",
    "LatencyWindow",
    "PIDRateController",
    "completion_event",
]
