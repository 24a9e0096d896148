from repro_torch.streaming.dispatch import (
    AsyncWindow,
    LatencyWindow,
    ShapeBuckets,
    completion_event,
    next_pow2,
    pad_rows,
)
from repro_torch.streaming.rate_control import PIDRateController
from repro_torch.streaming.windows import (
    SessionWindow,
    SlidingWindow,
    TumblingWindow,
    WatermarkTracker,
)

__all__ = [
    "AsyncWindow",
    "LatencyWindow",
    "PIDRateController",
    "SessionWindow",
    "ShapeBuckets",
    "SlidingWindow",
    "TumblingWindow",
    "WatermarkTracker",
    "completion_event",
    "next_pow2",
    "pad_rows",
]
