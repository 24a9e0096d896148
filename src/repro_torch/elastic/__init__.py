"""Elastic autoscaling control plane (paper §4.2 "dynamically respond to
resource requirements by adding/removing resources at runtime").

bus (``MetricsBus``) -> policy (``ScalingPolicy``) -> reconciler
(``ElasticController``) -> pilots (``submit_pilot(parent=...)`` / ``cancel``).
"""
from repro_torch.elastic.controller import (
    ElasticConfig,
    ElasticController,
    PreemptionHooks,
)
from repro_torch.elastic.events import EventLog, ScalingEvent, timeline
from repro_torch.elastic.forecast import ForecastPolicy
from repro_torch.elastic.metrics import (
    BatchMetrics,
    ContinuousStats,
    MetricsBus,
    MetricsSnapshot,
    Sample,
    StreamStats,
)
from repro_torch.elastic.policy import (
    HOLD,
    BinPackingPolicy,
    BrokerSaturationPolicy,
    LatencyPolicy,
    PIDScalingPolicy,
    ScalingDecision,
    ScalingPolicy,
    SLOPolicy,
    ThresholdHysteresisPolicy,
    first_fit_decreasing,
)

__all__ = [
    "BatchMetrics",
    "BinPackingPolicy",
    "BrokerSaturationPolicy",
    "ContinuousStats",
    "ElasticConfig",
    "ElasticController",
    "EventLog",
    "ForecastPolicy",
    "HOLD",
    "LatencyPolicy",
    "MetricsBus",
    "MetricsSnapshot",
    "PIDScalingPolicy",
    "PreemptionHooks",
    "Sample",
    "SLOPolicy",
    "ScalingDecision",
    "ScalingEvent",
    "ScalingPolicy",
    "StreamStats",
    "ThresholdHysteresisPolicy",
    "first_fit_decreasing",
    "timeline",
]
