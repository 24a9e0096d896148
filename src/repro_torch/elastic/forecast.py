"""ForecastPolicy — predictive, cost-aware scaling from a fitted model.

Every other policy in :mod:`repro_torch.elastic.policy` is reactive: it scales
from lag the pipeline has *already incurred*. This one follows the
performance-modeling formulation of arXiv:1909.06055 — fit an online
throughput model to the telemetry stream and size the pool from the
model's *forecast* over a horizon — and gates the resulting rescale on
the migration cost it would pay (``MetricsSnapshot.state_migration_ms``,
which no other policy consumes).

The model is deliberately small, because the snapshot gives exactly two
load-bearing observables per tick:

* **Per-device service rate** ``mu`` (records/s/device): scalar recursive
  least squares with a forgetting factor over ``(pipeline_devices,
  records_per_sec)`` pairs — ``records_per_sec ~= mu * devices`` while the
  pipeline is saturated. Samples are only fed to RLS when the pipeline is
  demonstrably *capacity-limited* (backlogged or busy): an idle pipeline's
  throughput equals its offered load, and learning from it would bias
  ``mu`` toward whatever trickle is arriving.
* **Arrival rate** ``a`` (records/s): flow conservation,
  ``a = throughput + d(lag)/dt``, smoothed by an EWMA. This reads the
  offered load even while the pipeline is falling behind, which is the
  regime where reacting to raw lag is already too late.

Sizing then solves the drain equation over ``horizon`` seconds::

    n* = ceil( (a * (1 + headroom) + max(lag - target_lag, 0) / horizon)
               / mu )

i.e. enough devices to absorb the predicted arrivals *and* work off the
excess backlog within the horizon. The decision is returned as an
absolute device count (``ScalingDecision(..., absolute=True)``), like
:class:`BinPackingPolicy`.

**Migration gate.** A rescale of a stateful stage pays a quiesce +
snapshot + restore pause; during it, arrivals pile up. The policy holds
(reason ``"migration gate"``) unless the expected gain over the horizon —
``mu * |delta| * horizon`` records of extra (or surplus) service capacity
— exceeds ``migration_gain_ratio`` times the predicted pile-up,
``a * state_migration_ms / 1e3`` records. A stateless stage publishes no
migration cost and is never gated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.elastic.metrics import MetricsSnapshot
from repro_torch.elastic.policy import HOLD, ScalingDecision, ScalingPolicy


@dataclass
class ForecastPolicy(ScalingPolicy):
    """Size the pool from predicted lag over ``horizon`` seconds.

    Pure decider like every other policy: snapshot in, absolute device
    target out. The controller/arbiter still clamp and actuate.
    """

    #: backlog (records) the pipeline is allowed to carry at steady state
    target_lag: float = 0.0
    #: seconds over which predicted excess backlog must drain
    horizon: float = 5.0
    #: spare service capacity provisioned above the predicted arrivals
    headroom: float = 0.1
    #: RLS forgetting factor (1.0 = infinite memory; lower tracks drift)
    forgetting: float = 0.95
    #: EWMA smoothing on the flow-conservation arrival estimate
    arrival_alpha: float = 0.4
    #: snapshots consumed before the model is trusted to act
    min_observations: int = 3
    #: expected gain must exceed this multiple of the predicted migration
    #: pile-up before a rescale is released (0 disables the gate)
    migration_gain_ratio: float = 1.0
    #: busy_frac at or above which a lag-free pipeline still counts as
    #: capacity-limited for the RLS update
    busy_saturated: float = 0.8
    #: floor on the learned service rate (guards the division)
    min_mu: float = 1e-3

    # -- fitted state (not constructor params in spirit, but dataclass
    # fields so repr/tests can introspect the model) --
    _mu: float = field(default=0.0, repr=False)
    _P: float = field(default=1e6, repr=False)  # RLS covariance
    _arrival: float = field(default=0.0, repr=False)
    _have_arrival: bool = field(default=False, repr=False)
    _prev_t: float | None = field(default=None, repr=False)
    _prev_lag: float = field(default=0.0, repr=False)
    _n_obs: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.horizon <= 0:
            raise ValueError("horizon must be positive")
        if not 0 < self.forgetting <= 1:
            raise ValueError("forgetting must be in (0, 1]")
        if not 0 < self.arrival_alpha <= 1:
            raise ValueError("arrival_alpha must be in (0, 1]")

    # -- model ---------------------------------------------------------------

    @property
    def service_rate(self) -> float:
        """The fitted per-device service rate (records/s/device)."""
        return max(self._mu, self.min_mu)

    @property
    def arrival_rate(self) -> float:
        """The smoothed arrival-rate estimate (records/s)."""
        return self._arrival

    def _observe(self, snap: MetricsSnapshot) -> None:
        # arrival by flow conservation needs two snapshots
        if self._prev_t is not None:
            dt = snap.t - self._prev_t
            if dt > 0:
                inst = max(snap.records_per_sec
                           + (snap.lag - self._prev_lag) / dt, 0.0)
                if self._have_arrival:
                    self._arrival += self.arrival_alpha * (inst - self._arrival)
                else:
                    self._arrival = inst
                    self._have_arrival = True
        self._prev_t = snap.t
        self._prev_lag = snap.lag

        # RLS on (devices, throughput) — capacity-limited samples only
        saturated = snap.lag > 0 or snap.busy_frac >= self.busy_saturated
        x = float(max(snap.pipeline_devices, 1))
        if saturated and snap.records_per_sec > 0:
            lam = self.forgetting
            k = self._P * x / (lam + x * self._P * x)
            self._mu += k * (snap.records_per_sec - self._mu * x)
            self._P = (self._P - k * x * self._P) / lam
            self._mu = max(self._mu, 0.0)
        self._n_obs += 1

    def _desired(self, snap: MetricsSnapshot) -> int:
        mu = self.service_rate
        drain = max(snap.lag - self.target_lag, 0.0) / self.horizon
        need = self._arrival * (1.0 + self.headroom) + drain
        return max(int(math.ceil(need / mu)), 1) if need > 0 else 1

    def predicted_lag(self, snap: MetricsSnapshot, devices: int | None = None) -> float:
        """Forecast backlog ``horizon`` seconds out at ``devices`` (default:
        the pipeline's current size) — what the sizing inverts."""
        n = snap.pipeline_devices if devices is None else devices
        return max(snap.lag + (self._arrival - self.service_rate * n)
                   * self.horizon, 0.0)

    # -- decider -------------------------------------------------------------

    def decide(self, snap: MetricsSnapshot) -> ScalingDecision:
        self._observe(snap)
        if self._n_obs < self.min_observations:
            return HOLD
        desired = self._desired(snap)
        delta = desired - snap.pipeline_devices
        if delta == 0:
            return HOLD
        # migration gate: expected gain over the horizon vs the pile-up the
        # rescale pause would cost (finally consuming state_migration_ms
        # from the snapshot itself)
        cost_s = snap.state_migration_ms / 1e3
        if cost_s > 0 and self.migration_gain_ratio > 0:
            gain = self.service_rate * abs(delta) * self.horizon
            pileup = self._arrival * cost_s
            if gain < self.migration_gain_ratio * pileup:
                return ScalingDecision(
                    0,
                    f"migration gate: gain {gain:.0f} rec < "
                    f"{self.migration_gain_ratio:.1f} x pile-up {pileup:.0f} rec "
                    f"(cost {snap.state_migration_ms:.0f}ms)",
                )
        return ScalingDecision(
            delta,
            f"forecast wants {desired} devices (mu={self.service_rate:.1f} rec/s/dev, "
            f"arrival={self._arrival:.1f} rec/s, lag={snap.lag:.0f}, "
            f"pred_lag={self.predicted_lag(snap):.0f}@{self.horizon:.0f}s)",
            absolute=True,
        )
