"""PID-based backpressure rate controller (Spark Streaming's
``spark.streaming.backpressure`` estimator, adapted).

Keeps the micro-batch processing time at or below the batch interval by
adjusting the per-batch ingestion bound. The dysfunctional-system failure
mode this prevents — processing rate < production rate -> unbounded lag —
is the paper's core motivating scenario (§1, §3.3).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PIDRateController:
    batch_interval: float  # target seconds per micro-batch
    kp: float = 1.0
    ki: float = 0.2
    kd: float = 0.0
    min_rate: float = 10.0  # records/sec floor

    _latest_rate: float = 0.0
    _latest_error: float = 0.0
    _integral: float = 0.0
    _initialized: bool = False

    def update(self, n_records: int, processing_delay: float, scheduling_delay: float = 0.0) -> float:
        """Returns the new max ingestion rate (records/sec)."""
        if n_records <= 0 or processing_delay <= 0:
            return self._latest_rate or self.min_rate
        processing_rate = n_records / processing_delay
        error = self._latest_rate - processing_rate if self._initialized else 0.0
        # records queued due to scheduling delay act as accumulated error
        hist_error = scheduling_delay * processing_rate / self.batch_interval
        d_error = (error - self._latest_error) / max(self.batch_interval, 1e-6)
        new_rate = processing_rate - self.kp * error - self.ki * hist_error - self.kd * d_error
        if not self._initialized:
            new_rate = processing_rate
            self._initialized = True
        new_rate = max(new_rate, self.min_rate)
        self._latest_rate = new_rate
        self._latest_error = error
        return new_rate

    @property
    def max_records_per_batch(self) -> int:
        rate = self._latest_rate or self.min_rate
        return max(int(rate * self.batch_interval), 1)
