"""Telemetry of the elastic control plane: the metrics bus the engines
publish to. The controller and its scaling policies come in a later slice."""
from repro_torch.elastic.metrics import BatchMetrics, MetricsBus, Sample, StreamStats

__all__ = ["BatchMetrics", "MetricsBus", "Sample", "StreamStats"]
