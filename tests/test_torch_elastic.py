"""The port's elastic control plane against the JAX package's, on the same
inputs: the metrics bus's readers and snapshot, every scaling policy's
decisions on one seeded bus history, the controller's grow/shrink and its
arbiter-mode actuator, the event timeline, rate-step scenarios and the
window assigners (quirks included). Every module here is plain Python in
both packages, so the results must be equal, not close."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.elastic as jax_elastic
import repro.miniapps as jax_miniapps
import repro.streaming.windows as jax_windows
import repro_torch.core as torch_core
import repro_torch.elastic as torch_elastic
import repro_torch.miniapps as torch_miniapps
import repro_torch.streaming.windows as torch_windows

torch.set_num_threads(1)

PACKAGES = {"jax": (jax_core, jax_elastic, jax_miniapps),
            "torch": (torch_core, torch_elastic, torch_miniapps)}
CPU = torch.device("cpu")


def _devices(pkg: str, n: int) -> list:
    """n device slots: logical ids for the JAX package, CPU devices for the
    port (which refuses to run without CUDA unless told)."""
    return list(range(n)) if pkg == "jax" else [CPU] * n


# ---------------------------------------------------------------------------
# a seeded bus history
# ---------------------------------------------------------------------------


def _history(n_ticks: int = 60, seed: int = 0) -> list[list[tuple]]:
    """Per tick, the samples a two-stage pipeline publishes: lag rising into
    a burst and draining, busy fraction, latency quantiles, throughput,
    broker stall and one state migration; (name, value, t, labels)."""
    rng = np.random.default_rng(seed)
    ticks = []
    for i in range(n_ticks):
        t = 100.0 + 0.25 * i
        burst = 1.0 if 15 <= i < 35 else 0.0
        samples = []
        for stream, scale in (("p/a/g", 1.0), ("p/b/g", 0.3)):
            lag = max(0.0, burst * (40 * (i - 15)) * scale + rng.normal(0, 5))
            samples += [
                ("stream.lag", lag, t, {"stream": stream}),
                ("stream.busy_frac", float(np.clip(0.2 + 0.7 * burst + rng.normal(0, 0.1), 0, 1.5)),
                 t, {"stream": stream}),
                ("stream.records_per_sec", float(200 * scale + 300 * burst + rng.normal(0, 10)),
                 t, {"stream": stream}),
                ("stream.latency_p50", float(0.01 + 0.03 * burst + abs(rng.normal(0, 0.002))),
                 t, {"stream": stream}),
                ("stream.latency_p99", float(0.02 + 0.06 * burst + abs(rng.normal(0, 0.004))),
                 t, {"stream": stream}),
                ("stream.processing_delay", float(0.02 + 0.02 * burst), t, {"stream": stream}),
                ("stream.scheduling_delay", float(0.001 * i), t, {"stream": stream}),
                ("broker.stall_frac", float(np.clip(0.5 * burst + rng.normal(0, 0.05), 0, 1)),
                 t, {"stream": stream}),
            ]
        if i == 20:
            samples.append(("state.migration_ms", 800.0, t, {"stream": "p/a/g"}))
        samples += [("pool.devices_total", 8.0, t, {}), ("pool.devices_leased", 3.0, t, {}),
                    ("pool.utilization", 3 / 8, t, {})]
        ticks.append(samples)
    return ticks


def _publish(bus, samples) -> None:
    for name, value, t, labels in samples:
        bus.publish(name, value, t=t, **labels)


def _snapshots(elastic, stream=None, devices=lambda i: 1 + i % 3) -> list:
    """One snapshot per tick of :func:`_history`, captured from the
    package's bus; ``t`` is set to the tick's time (capture stamps the
    monotonic clock)."""
    bus = elastic.MetricsBus()
    out = []
    for i, samples in enumerate(_history()):
        _publish(bus, samples)
        snap = elastic.MetricsSnapshot.capture(bus, pipeline_devices=devices(i), stream=stream)
        out.append(dataclasses.replace(snap, t=samples[0][2]))
    return out


def _fields(snap) -> dict:
    d = dataclasses.asdict(snap)
    d.pop("t")
    return d


# ---------------------------------------------------------------------------
# metrics bus and snapshot
# ---------------------------------------------------------------------------


def test_metrics_bus_readers_match_jax():
    buses = {}
    for name, (_, elastic, _) in PACKAGES.items():
        bus = elastic.MetricsBus()
        for samples in _history()[:30]:
            _publish(bus, samples)
        bus.publish("stream.records", 0, t=0.0, stream="c")
        bus.publish("stream.records", 50, t=5.0, stream="c")
        buses[name] = bus
    j, t = buses["jax"], buses["torch"]
    for name in ("stream.lag", "stream.busy_frac", "state.migration_ms"):
        assert t.latest_by_label(name, "stream") == j.latest_by_label(name, "stream")
        assert ({k: (s.value, s.t, s.labels) for k, s in t.samples_by_label(name, "stream").items()}
                == {k: (s.value, s.t, s.labels) for k, s in j.samples_by_label(name, "stream").items()})
        assert t.sum_latest(name) == j.sum_latest(name)
        assert t.series(name) == j.series(name)
    assert t.rate("stream.records", window=10.0, stream="c") == j.rate(
        "stream.records", window=10.0, stream="c") == pytest.approx(10.0)
    assert t.rate("stream.lag", window=1.0) == j.rate("stream.lag", window=1.0)


@pytest.mark.parametrize("stream", [None, "p/a/g", "p/b/g"])
def test_snapshot_capture_matches_jax(stream):
    jax_snaps = _snapshots(jax_elastic, stream)
    torch_snaps = _snapshots(torch_elastic, stream)
    assert [_fields(s) for s in torch_snaps] == [_fields(s) for s in jax_snaps]


def test_snapshot_capture_reads_a_pool_and_the_probe_lag():
    class Pool:
        total_devices, leased_devices, utilization = 8, 5, 5 / 8

    out = []
    for elastic in (jax_elastic, torch_elastic):
        bus = elastic.MetricsBus()
        bus.publish("stream.lag", 40, stream="s")
        bus.publish("elastic.lag", 7, stream="s")
        out.append(_fields(elastic.MetricsSnapshot.capture(bus, Pool(), stream="s")))
    assert out[0] == out[1]
    assert out[1]["lag"] == 7 and out[1]["devices_leased"] == 5


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

POLICIES = [
    ("ThresholdHysteresisPolicy", dict(high_lag=100, low_lag=10, up_stable=2, down_stable=3)),
    ("PIDScalingPolicy", dict(target_lag=50, kp=1.0, ki=0.2, kd=0.05, lag_per_device=100)),
    ("LatencyPolicy", dict(batch_interval=0.05, up_frac=0.8, down_frac=0.3)),
    ("SLOPolicy", dict(slo_p99=0.05, down_margin=0.5)),
    ("BrokerSaturationPolicy", dict(high_stall=0.3, low_stall=0.05, up_stable=2, down_stable=3)),
    ("BinPackingPolicy", dict(device_records_per_sec=250, lag_norm=500)),
    ("ForecastPolicy", dict(target_lag=20, horizon=2.0, migration_gain_ratio=1.0)),
]


@pytest.mark.parametrize("stream", [None, "p/a/g"])
@pytest.mark.parametrize("cls,params", POLICIES, ids=[c for c, _ in POLICIES])
def test_policy_decisions_match_jax(cls, params, stream):
    """Every policy, fed the same seeded bus history through each package's
    snapshot, makes the same decisions (delta, reason, absolute), and the
    history makes each policy act at least once."""
    decisions = []
    for elastic in (jax_elastic, torch_elastic):
        policy = getattr(elastic, cls)(**params)
        decisions.append([(d.delta_devices, d.reason, d.absolute)
                          for d in map(policy.decide, _snapshots(elastic, stream))])
    assert decisions[1] == decisions[0]
    assert any(delta for delta, _, _ in decisions[1]), cls


def test_first_fit_decreasing_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        items = {f"s{i}": float(rng.uniform(0.1, 2.5)) for i in range(rng.integers(1, 12))}
        assert (torch_elastic.first_fit_decreasing(items, 2.0)
                == jax_elastic.first_fit_decreasing(items, 2.0))


@pytest.mark.parametrize("cls,bad", [
    ("LatencyPolicy", dict(batch_interval=0)), ("SLOPolicy", dict(slo_p99=-1)),
    ("SLOPolicy", dict(slo_p99=1, down_margin=2)), ("ForecastPolicy", dict(horizon=0)),
    ("ForecastPolicy", dict(forgetting=0)), ("ForecastPolicy", dict(arrival_alpha=2)),
])
def test_policies_refuse_the_same_params(cls, bad):
    errors = []
    for elastic in (jax_elastic, torch_elastic):
        with pytest.raises(ValueError) as ei:
            getattr(elastic, cls)(**bad)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


class _Scripted:
    """A policy that returns a fixed sequence of decisions (relative or
    absolute), then holds."""

    def __init__(self, elastic, script):
        self.elastic, self.script = elastic, list(script)

    def decide(self, snap):
        if not self.script:
            return self.elastic.HOLD
        delta, absolute = self.script.pop(0)
        return self.elastic.ScalingDecision(delta, f"scripted {delta}", absolute=absolute)


SCRIPT = [(1, False), (1, False), (0, False), (5, False), (-1, False), (3, True), (-2, True),
          (-1, False), (-1, False), (-1, False), (2, False)]


def _drive_direct(pkg: str) -> tuple:
    core, elastic, _ = PACKAGES[pkg]
    svc = core.PilotComputeService(devices=_devices(pkg, 8))
    try:
        base = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 2, "type": "spark"})
        bus = elastic.MetricsBus()
        ctl = elastic.ElasticController(
            svc, base, bus, _Scripted(elastic, SCRIPT),
            config=elastic.ElasticConfig(min_devices=2, max_devices=7, devices_per_step=2,
                                         cooldown=0.0),
            lag_probe=lambda: 3.0, stream="s")
        trace = []
        for _ in SCRIPT:
            d = ctl.step()
            trace.append((d.delta_devices, ctl.devices, svc.pool.leased_devices,
                          len(base.children)))
        events = [(e.action, e.delta, e.devices_before, e.devices_after, e.reason)
                  for e in ctl.events]
        devices_series = [v for _, v in bus.series("elastic.devices")]
        ctl.shutdown()
        return trace, events, devices_series, svc.pool.leased_devices
    finally:
        svc.cancel()


def test_controller_direct_mode_matches_jax():
    """Relative and absolute deltas, lease rounding, the max and min clamps
    and a rejection for want of headroom: the same devices after every
    step, the same events and the same ``elastic.devices`` series."""
    jax_run, torch_run = _drive_direct("jax"), _drive_direct("torch")
    assert torch_run == jax_run
    actions = {a for a, *_ in torch_run[1]}
    assert {"scale_up", "scale_down"} <= actions


def _drive_arbitrated(pkg: str) -> tuple:
    """A controller in arbiter mode beside a static reservation and a
    higher-priority tenant: grants, preemption and the controller's
    ``scale_to`` actuator, reconciled by hand."""
    core, elastic, _ = PACKAGES[pkg]
    sched = __import__("repro.scheduler" if pkg == "jax" else "repro_torch.scheduler",
                       fromlist=["x"])
    svc = core.PilotComputeService(devices=_devices(pkg, 6))
    try:
        bus = elastic.MetricsBus()
        arb = svc.get_arbiter(bus)
        base = svc.submit_pilot({"number_of_nodes": 1, "cores_per_node": 1, "type": "spark"})
        req = sched.ResourceRequest("p/stage", min_devices=1, max_devices=5)
        ctl = elastic.ElasticController(
            svc, base, bus, _Scripted(elastic, [(4, False), (0, False), (0, False), (-1, False)]),
            config=elastic.ElasticConfig(min_devices=1, max_devices=5, cooldown=0.0),
            lag_probe=lambda: 0.0, stream="s", arbiter=arb, request=req)
        tenant = sched.PoolTenant(svc)
        trace = []
        for i in range(4):
            ctl.step()
            if i == 1:
                arb.submit(tenant.request("hi", min_devices=0, priority=1))
                arb.update("hi", 3)
            granted = arb.reconcile()
            trace.append((ctl.devices, tenant.devices, svc.pool.free_devices, sorted(granted.items())))
        events = [(e.action, e.delta, e.devices_before, e.devices_after) for e in arb.events]
        ctl_events = [(e.action, e.delta, e.devices_before, e.devices_after, e.reason)
                      for e in ctl.events]
        free = [v for _, v in bus.series("scheduler.free")]
        ctl.shutdown()
        tenant.close()
        return trace, events, ctl_events, free, arb.preemptions
    finally:
        svc.cancel()


def test_controller_arbiter_mode_matches_jax():
    jax_run, torch_run = _drive_arbitrated("jax"), _drive_arbitrated("torch")
    assert torch_run == jax_run
    trace, events, _, free, preemptions = torch_run
    assert preemptions == 1 and "preempt" in {a for a, *_ in events}
    assert min(free) >= 0


def test_timeline_matches_jax():
    out = []
    for elastic in (jax_elastic, torch_elastic):
        bus = elastic.MetricsBus()
        for samples in _history()[:10]:
            _publish(bus, samples)
        bus.publish("elastic.devices", 2, t=101.0)
        events = [elastic.ScalingEvent(101.2, "scale_up", 1, 1, 2, "r"),
                  elastic.ScalingEvent(100.7, "scale_down", -1, 2, 1, "q")]
        log = elastic.EventLog()
        for e in events:
            log.record(e)
        out.append((elastic.timeline(bus, log), len(log), [e.t for e in log.of("scale_up")]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# rate steps and windows
# ---------------------------------------------------------------------------


def test_rate_step_scenario_matches_jax():
    """The same schedule through both packages' scenarios: the same rates in
    the same order (bare tuples and RateSteps alike), each applied to the
    source's live producers; the scenario ends after its total duration."""
    schedule = [(0.05, 40), (0.05, 0), (0.05, None), (0.05, 120)]
    runs = []
    for name, (core, _, miniapps) in PACKAGES.items():
        cluster = core.PilotComputeService(devices=_devices(name, 1))
        try:
            broker = cluster.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
            broker.create_topic("t", 1)
            src = miniapps.KMeansStaticSource(
                broker, miniapps.SourceConfig("t", rate_msgs_per_s=10, n_producers=2),
                points_per_msg=4)
            src.start()
            deadline = time.monotonic() + 10
            while len(src.producers) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            steps = [miniapps.RateStep(*schedule[0])] + schedule[1:]
            sc = miniapps.RateStepScenario(src, steps)
            assert sc.total_duration == pytest.approx(0.2)
            sc.start()
            sc.join(10)
            assert sc.finished
            src.stop()
            runs.append(([r for _, r in sc.transitions], src.config.rate_msgs_per_s,
                         sorted(p.rate for p in src.producers)))
        finally:
            cluster.cancel()
    assert runs[0] == runs[1] == ([40, 0, None, 120], 120, [60.0, 60.0])


def test_sources_finish_only_when_finite():
    for name, (core, _, miniapps) in PACKAGES.items():
        svc = core.PilotComputeService(devices=_devices(name, 1))
        try:
            broker = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
            broker.create_topic("t", 1)
            src = miniapps.KMeansStaticSource(
                broker, miniapps.SourceConfig("t", total_messages=6), points_per_msg=4)
            assert not src.finished
            src.start().join(10)
            assert src.finished and src.sent_records == 6
        finally:
            svc.cancel()


def _window_runs(windows):
    rng = np.random.default_rng(7)
    ts = rng.uniform(0, 100, 300).round(3)
    out = [[windows.TumblingWindow(2.5).assign(float(t)) for t in ts],
           [windows.SlidingWindow(3.0, 1.25).assign(float(t)) for t in ts]]
    sess = windows.SessionWindow(gap=4.0)
    keys = rng.integers(0, 3, len(ts))
    out.append([sess.assign(float(t), key=int(k)) for t, k in zip(ts, keys)])
    out.append([sess.sessions(k) for k in range(3)])
    out.append(sess.close_before(60.0, key=1))
    out.append(sess.close_before(80.0))
    out.append([sess.sessions(k) for k in range(3)])
    wm = windows.WatermarkTracker(allowed_lateness=1.5)
    late = []
    for t in ts:
        late.append(wm.is_late(float(t)))
        wm.observe(float(t))
    out.append((late, wm.watermark))
    return out


def test_windows_match_jax():
    assert _window_runs(torch_windows) == _window_runs(jax_windows)


def test_session_window_keeps_the_reference_behaviour():
    """The reference's SessionWindow merges an out-of-order arrival into the
    sessions its proto-session overlaps and no further, so (0, 10) and
    (25, 35) bridged by 8.0 give (0, 18) beside (25, 35); the port keeps
    that (the JAX package's own test of a full bridge fails on it)."""
    out = []
    for windows in (jax_windows, torch_windows):
        s = windows.SessionWindow(gap=10.0)
        s.assign(0.0, key="k")
        s.assign(25.0, key="k")
        out.append((s.assign(8.0, key="k"), s.sessions("k")))
    assert out[0] == out[1] == ([(0.0, 18.0)], [(0.0, 18.0), (25.0, 35.0)])
