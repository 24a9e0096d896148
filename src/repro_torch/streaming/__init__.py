from repro_torch.streaming.dispatch import (
    AsyncWindow,
    LatencyWindow,
    ShapeBuckets,
    completion_event,
    next_pow2,
    pad_rows,
)
from repro_torch.streaming.rate_control import PIDRateController

__all__ = [
    "AsyncWindow",
    "LatencyWindow",
    "PIDRateController",
    "ShapeBuckets",
    "completion_event",
    "next_pow2",
    "pad_rows",
]
