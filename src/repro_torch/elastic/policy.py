"""Scaling policies: snapshot in, device-delta out.

Three families, per the stream-elasticity literature:

* :class:`ThresholdHysteresisPolicy` — lag high/low watermarks with
  consecutive-observation hysteresis and a busy-fraction guard so the
  scale-down leg cannot oscillate against a still-loaded pipeline
  (de Assunção et al., arXiv:1709.01363 §4: lag/throughput elasticity).
* :class:`PIDScalingPolicy` — closed-loop control on consumer lag, the
  same PID idiom as ``streaming/rate_control.py`` but actuating devices
  instead of ingestion rate.
* :class:`BinPackingPolicy` — first-fit-decreasing packing of per-stage
  demand onto fixed-capacity devices (Stein et al., arXiv:2001.10865:
  online bin-packing for stream autoscaling).

Policies are pure deciders: they never touch the pool or pilots. The
:class:`ElasticController` clamps and applies their deltas.
"""
from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field

from repro_torch.elastic.metrics import MetricsSnapshot


@dataclass(frozen=True)
class ScalingDecision:
    delta_devices: int  # >0 grow, <0 shrink, 0 hold
    reason: str = ""
    #: False: delta counts scaling *actions* (one extension-pilot lease each,
    #: threshold/PID style). True: delta is an exact device count (bin-packing
    #: style) — the controller rounds grows up to whole leases and shrinks
    #: down, so a target between lease multiples holds instead of flapping.
    absolute: bool = False

    @property
    def scale_up(self) -> bool:
        return self.delta_devices > 0

    @property
    def scale_down(self) -> bool:
        return self.delta_devices < 0


HOLD = ScalingDecision(0, "hold")


class ScalingPolicy(abc.ABC):
    @abc.abstractmethod
    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        """Map one reconcile-time snapshot to a device delta."""


@dataclass
class ThresholdHysteresisPolicy(ScalingPolicy):
    """Scale up when lag stays above ``high_lag``; scale down when lag stays
    below ``low_lag`` AND the pipeline is mostly idle (``busy_frac`` below
    ``max_busy_for_down`` — without this guard a drained-but-saturated
    pipeline immediately gives back the devices it still needs)."""

    high_lag: float
    low_lag: float
    up_stable: int = 2  # consecutive observations before acting
    down_stable: int = 3
    max_busy_for_down: float = 0.5
    step: int = 1  # lease-sized scaling actions per decision (relative delta)

    _above: int = field(default=0, repr=False)
    _below: int = field(default=0, repr=False)

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        # inclusive up-leg (>=), like every other hysteresis policy here: a
        # signal sitting exactly on the watermark must accumulate toward
        # up_stable, not fall into the in-band else and zero both counters
        if snap.lag >= self.high_lag:
            self._above += 1
            self._below = 0
        elif snap.lag < self.low_lag and snap.busy_frac < self.max_busy_for_down:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.up_stable:
            self._above = 0
            return ScalingDecision(self.step, f"lag {snap.lag:.0f} >= {self.high_lag:.0f} "
                                              f"for {self.up_stable} observations")
        if self._below >= self.down_stable:
            self._below = 0
            return ScalingDecision(-self.step, f"lag {snap.lag:.0f} < {self.low_lag:.0f}, "
                                               f"busy {snap.busy_frac:.2f}")
        return HOLD


@dataclass
class PIDScalingPolicy(ScalingPolicy):
    """PID on consumer lag. Lag integrates (ingress − throughput), so the
    proportional term already acts like an integral of rate error — gains
    stay small and the integral is clamped (anti-windup), mirroring
    ``PIDRateController``'s first-update initialization idiom."""

    target_lag: float
    kp: float = 1.0
    ki: float = 0.1
    kd: float = 0.0
    #: control units per device: u == lag_per_device means "one device short"
    lag_per_device: float = 100.0
    deadband: float = 0.25  # hold while |u| (already in device units) is below this
    integral_limit: float = 10.0  # in device units

    _latest_error: float = 0.0
    _integral: float = 0.0
    _last_t: float = 0.0
    _initialized: bool = False

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        error = snap.lag - self.target_lag
        if not self._initialized:
            self._initialized = True
            self._latest_error = error
            self._last_t = snap.t
            return HOLD
        dt = max(snap.t - self._last_t, 1e-6)
        self._integral += error * dt / self.lag_per_device
        self._integral = max(-self.integral_limit, min(self.integral_limit, self._integral))
        d_error = (error - self._latest_error) / dt
        u = (self.kp * error / self.lag_per_device
             + self.ki * self._integral
             + self.kd * d_error / self.lag_per_device)
        self._latest_error = error
        self._last_t = snap.t
        if abs(u) < self.deadband:
            return HOLD
        delta = int(math.copysign(max(1, min(abs(u), 4)), u))
        if delta < 0 and snap.busy_frac >= 0.75:
            return HOLD  # draining but saturated: keep the devices
        if delta < 0:
            self._integral = min(self._integral, 0.0)  # release wound-up surplus
        return ScalingDecision(delta, f"pid u={u:.2f} lag={snap.lag:.0f}")


@dataclass
class LatencyPolicy(ScalingPolicy):
    """React to per-batch compute-latency quantiles *before* they surface as
    lag: the policy that consumes ``latency_p50``/``latency_p99``.

    A micro-batch pipeline saturates when batch compute time approaches the
    batch interval: at ``p99 >= up_frac * batch_interval`` the stream is about
    to fall behind even if lag still reads low, so scale up. Scale down only
    when the *median* is comfortably below ``down_frac * batch_interval`` AND
    lag is drained — p50 is used for the down leg so one slow straggler batch
    (a p99 artifact) cannot hold surplus devices forever. Both legs require
    consecutive observations, mirroring :class:`ThresholdHysteresisPolicy`.
    """

    batch_interval: float
    up_frac: float = 0.8
    down_frac: float = 0.3
    max_lag_for_down: float = 10.0
    up_stable: int = 2
    down_stable: int = 3
    step: int = 1

    _above: int = field(default=0, repr=False)
    _below: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.batch_interval <= 0:
            raise ValueError("batch_interval must be positive")

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        high = self.up_frac * self.batch_interval
        low = self.down_frac * self.batch_interval
        if snap.latency_p99 >= high:
            self._above += 1
            self._below = 0
        elif (
            0.0 < snap.latency_p50 <= low and snap.lag <= self.max_lag_for_down
        ):
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.up_stable:
            self._above = 0
            return ScalingDecision(
                self.step,
                f"p99 {snap.latency_p99 * 1e3:.0f}ms >= {high * 1e3:.0f}ms "
                f"({self.up_frac:.0%} of batch interval)",
            )
        if self._below >= self.down_stable:
            self._below = 0
            return ScalingDecision(
                -self.step,
                f"p50 {snap.latency_p50 * 1e3:.0f}ms <= {low * 1e3:.0f}ms, "
                f"lag {snap.lag:.0f}",
            )
        return HOLD


@dataclass
class SLOPolicy(ScalingPolicy):
    """Hold an *absolute* latency SLO instead of a fraction of the batch
    interval: the serving tail-latency loop.

    :class:`LatencyPolicy` asks "is the pipeline about to fall behind?";
    this policy asks "is the p99 the user sees above the contract?" — the
    right question for serving, where admission control keeps lag near zero
    by shedding load and the SLO is the only signal that the engine is
    degrading (1909.06055: drive scaling from the latency model, not
    incurred lag). Scale up when ``latency_p99`` (the ``stream.latency_p99``
    gauge, fed by the serving engine) sits above ``slo_p99``; scale down
    only when the p99 — not the median: a tail breach with a healthy median
    is exactly the case serving must react to — is far below the SLO
    (``down_margin``) and lag is drained. Consecutive-observation hysteresis
    on both legs, as everywhere else in this module.
    """

    slo_p99: float  # seconds: the contract
    up_margin: float = 1.0  # scale up when p99 >= up_margin * slo
    down_margin: float = 0.4  # scale down when p99 <= down_margin * slo
    max_lag_for_down: float = 10.0
    up_stable: int = 2
    down_stable: int = 4
    step: int = 1

    _above: int = field(default=0, repr=False)
    _below: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.slo_p99 <= 0:
            raise ValueError("slo_p99 must be positive")
        if not 0 < self.down_margin < self.up_margin:
            raise ValueError("need 0 < down_margin < up_margin")

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        p99 = snap.latency_p99
        if p99 >= self.up_margin * self.slo_p99:
            self._above += 1
            self._below = 0
        elif 0.0 < p99 <= self.down_margin * self.slo_p99 and snap.lag <= self.max_lag_for_down:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.up_stable:
            self._above = 0
            return ScalingDecision(
                self.step,
                f"p99 {p99 * 1e3:.0f}ms breaches SLO {self.slo_p99 * 1e3:.0f}ms "
                f"for {self.up_stable} observations",
            )
        if self._below >= self.down_stable:
            self._below = 0
            return ScalingDecision(
                -self.step,
                f"p99 {p99 * 1e3:.0f}ms <= {self.down_margin:.0%} of SLO, "
                f"lag {snap.lag:.0f}",
            )
        return HOLD


@dataclass
class BrokerSaturationPolicy(ScalingPolicy):
    """Broker-node elasticity from the producer-side token-bucket signal.

    When producers spend a sustained fraction of wall-clock time blocked in
    the broker nodes' token buckets (``snap.broker_stall_frac`` — the
    paper's 1-broker-bottleneck effect, Figs. 8/9), the cluster needs more
    nodes; when the buckets are idle, it can give nodes back. Same
    consecutive-observation hysteresis as
    :class:`ThresholdHysteresisPolicy`, but the actuation unit is broker
    *nodes*, not devices (the controller runs with ``unit="nodes"``).
    """

    high_stall: float = 0.3  # fraction of time producers sit in buckets
    low_stall: float = 0.02
    up_stable: int = 2
    down_stable: int = 4
    step: int = 1

    _above: int = field(default=0, repr=False)
    _below: int = field(default=0, repr=False)

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        stall = snap.broker_stall_frac
        if stall >= self.high_stall:
            self._above += 1
            self._below = 0
        elif stall <= self.low_stall:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.up_stable:
            self._above = 0
            return ScalingDecision(self.step,
                                   f"broker stall {stall:.0%} >= {self.high_stall:.0%}")
        if self._below >= self.down_stable:
            self._below = 0
            return ScalingDecision(-self.step,
                                   f"broker stall {stall:.0%} <= {self.low_stall:.0%}")
        return HOLD


def first_fit_decreasing(items: dict[str, float], capacity: float) -> list[list[str]]:
    """Pack named demands into the fewest ``capacity``-sized bins (FFD).

    Items larger than one bin get a bin of their own (they are pipeline
    stages that will saturate a device regardless of placement).
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    bins: list[tuple[float, list[str]]] = []  # (used, members)
    for name in sorted(items, key=lambda n: (-items[n], n)):
        demand = items[name]
        for i, (used, members) in enumerate(bins):
            if used + demand <= capacity:
                bins[i] = (used + demand, members + [name])
                break
        else:
            bins.append((demand, [name]))
    return [members for _, members in bins]


@dataclass
class BinPackingPolicy(ScalingPolicy):
    """Size the pool to the FFD bin count of per-stage demand.

    Each stage's demand is its observed records/sec (from the snapshot's
    ``stage_demands``), inflated by ``headroom`` plus a lag-proportional
    catch-up term so a backlogged pipeline packs into more bins than its
    steady state needs.
    """

    device_records_per_sec: float
    headroom: float = 0.2  # fraction of spare capacity per stage
    lag_weight: float = 0.5  # extra demand fraction per (lag / lag_norm)
    lag_norm: float = 1000.0
    min_devices: int = 1

    def desired_devices(self, snap: MetricsSnapshot) -> int:
        if not snap.stage_demands:
            return self.min_devices
        boost = 1.0 + self.headroom + self.lag_weight * (snap.lag / self.lag_norm)
        demands = {k: v * boost for k, v in snap.stage_demands.items() if v > 0}
        if not demands:
            return self.min_devices
        bins = first_fit_decreasing(demands, self.device_records_per_sec)
        # an oversized stage still only saturates whole devices
        extra = sum(
            math.ceil(sum(demands[m] for m in b) / self.device_records_per_sec) - 1
            for b in bins
        )
        return max(self.min_devices, len(bins) + extra)

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        desired = self.desired_devices(snap)
        # sized against the controlled pipeline, not pool-wide leases —
        # unrelated pilots sharing the service must not skew the delta
        delta = desired - snap.pipeline_devices
        if delta == 0:
            return HOLD
        return ScalingDecision(delta, f"ffd wants {desired} devices "
                                      f"(pipeline {snap.pipeline_devices}, lag {snap.lag:.0f})",
                               absolute=True)
