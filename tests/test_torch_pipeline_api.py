"""The port's Pipeline API against the JAX package's: specs cross between
the packages as JSON, ``Pipeline.validate`` reports the same problems (the port adds
a refusal for each stage kind that waits for a later module), runs tear
down in the same order, and the same deterministic K-Means and ML-EM specs
end in the same state. Then the port alone: device slots, app placement,
the refusal to run without CUDA unasked, the CLI, and a closed elastic loop
on CPU slots."""
import json
import time

import numpy as np
import pytest
import torch

import repro.miniapps as jax_miniapps
import repro.pipeline as jax_pipeline
import repro_torch.miniapps as torch_miniapps
import repro_torch.pipeline as torch_pipeline
from repro_torch.pipeline import cli as torch_cli
from repro_torch.pipeline import registry as torch_registry
from repro_torch.pipeline.runner import device_slots

torch.set_num_threads(1)

CPU = torch.device("cpu")
PACKAGES = {"jax": (jax_pipeline, jax_miniapps), "torch": (torch_pipeline, torch_miniapps)}


def _devices(pkg: str, n: int) -> list:
    return list(range(n)) if pkg == "jax" else [CPU] * n


# a tiny source and processors, registered under the same names in both
# packages' registries

def _register(pipeline, miniapps) -> None:
    class Vec8(miniapps.StreamSource):
        def make_message(self, rng, i):
            return rng.normal(size=(8,))

    class Exploding:
        def __init__(self):
            self.batches = 0

        def process(self, state, msgs):
            self.batches += 1
            if self.batches > 2:
                raise RuntimeError("stage blew up mid-run")
            return (state or 0) + len(msgs)

    class BrokenFactory:
        def __init__(self):
            raise RuntimeError("cannot construct processor")

    def count(state, msgs):
        return (state or 0) + len(msgs)

    pipeline.register_source("parity_vec8", Vec8)
    pipeline.register_processor("parity_count", count)
    pipeline.register_processor("parity_explode", Exploding)
    pipeline.register_processor("parity_broken", BrokenFactory)


for _pipeline, _miniapps in PACKAGES.values():
    _register(_pipeline, _miniapps)


# ---------------------------------------------------------------------------
# specs across the packages
# ---------------------------------------------------------------------------


def _full_spec(pipeline):
    """A spec using every field, continuous and checkpointing stages
    included (the JAX ``Pipeline`` takes them; as data they cross unchanged)."""
    return (pipeline.Pipeline.named("rt")
            .broker(nodes=2, io_rate_per_node=1e6, replication_factor=2)
            .broker_elastic(min_nodes=1, max_nodes=3, high_stall=0.4)
            .share(2.0)
            .topic("a", partitions=4).topic("b", partitions=2).topic("c", partitions=1)
            .source("a", kind="cluster", rate_msgs_per_s=100, n_producers=2, seed=4,
                    rate_schedule=[(1.0, 100), (2.0, 300)], n_clusters=4, dim=3)
            .stage("first", topic="a", processor="kmeans", cores_per_node=2,
                   emits=True, output_topic="b", n_clusters=4, dim=3, priority=1, share=0.5)
            .stage("second", topic="b", processor="parity_count", engine="continuous",
                   window={"window": "session", "gap": 0.5}, state_partitions=16,
                   checkpoint_every=50, async_emit=2)
            .stage("third", topic="a", processor="parity_count", colocate_with="first",
                   group="g3", max_batch_records=7, backpressure=False)
            .sink("drain", topic="b")
            .elastic("first", policy="latency", up_frac=0.7, interval=0.2,
                     migration_cost_frac=0.5, max_devices=4)
            .elastic("second", policy="threshold", high_lag=10, low_lag=2, min_devices=0,
                     preemptible=True)
            .build())


def test_spec_json_crosses_between_the_packages():
    """Built in the JAX package, read back by the port, and back again:
    ``to_dict`` equal both ways, and each spec equal to its own round trip."""
    spec_j = _full_spec(jax_pipeline)
    spec_t = torch_pipeline.PipelineSpec.from_json(spec_j.to_json())
    assert spec_t.to_dict() == spec_j.to_dict()
    assert torch_pipeline.PipelineSpec.from_dict(spec_t.to_dict()) == spec_t
    back = jax_pipeline.PipelineSpec.from_json(spec_t.to_json())
    assert back == spec_j
    assert json.loads(spec_t.to_json()) == spec_t.to_dict()
    # a spec the port's ``Pipeline`` makes crosses the other way too
    spec_p = (torch_pipeline.Pipeline.named("p").topic("t", partitions=3)
              .source("t", kind="lightsource", total_messages=5, n_angles=48, n_det=64)
              .stage("r", topic="t", processor="mlem", n=64, mlem_iters=2)
              .elastic("r", policy="threshold", high_lag=4, low_lag=1, max_devices=3)
              .build())
    assert jax_pipeline.PipelineSpec.from_json(spec_p.to_json()).to_dict() == spec_p.to_dict()


def test_spec_is_frozen_and_does_not_alias_caller_dicts():
    opts = {"n_clusters": 4}
    spec = (torch_pipeline.Pipeline.named("fz").topic("a")
            .stage("s", topic="a", processor="kmeans", **opts).build())
    opts["n_clusters"] = 99
    assert spec.stage("s").options["n_clusters"] == 4
    with pytest.raises(AttributeError):
        spec.stage("s").topic = "other"


# each: a ``Pipeline`` program over either package; every one is invalid
BAD_SPECS = {
    "many": lambda p: (p.Pipeline.named("bad").topic("a").topic("b")
                       .stage("s1", topic="ghost", processor="nope", engine="weird")
                       .stage("s1", topic="a", processor="parity_count")
                       .elastic("missing", policy="alien")),
    "cycle": lambda p: (p.Pipeline.named("cyc").topic("a").topic("b")
                        .stage("f", topic="a", processor="parity_count", emits=True,
                               output_topic="b")
                        .stage("g", topic="b", processor="parity_count", emits=True,
                               output_topic="a")),
    "emits": lambda p: (p.Pipeline.named("em").topic("a").topic("b")
                        .stage("f", topic="a", processor="parity_count", output_topic="b")
                        .stage("h", topic="a", processor="parity_count", emits=True)),
    "policy_params": lambda p: (p.Pipeline.named("pp").topic("a")
                                .stage("s", topic="a", processor="parity_count")
                                .elastic("s", policy="threshold")
                                .elastic("s2", policy="slo", slo_p99=-1)),
    "broker": lambda p: (p.Pipeline.named("").broker(nodes=0, replication_factor=2,
                                                     transport="udp")
                         .topic("a", partitions=0)
                         .broker_elastic(policy="pid", min_nodes=0)
                         .source("zz", kind="mystery", n_producers=0)
                         .sink("k", topic="zz", fn="no_such_sink").sink("k", topic="a")
                         .share(0)),
    "colocation": lambda p: (p.Pipeline.named("co").topic("a")
                             .stage("h", topic="a", processor="parity_count")
                             .stage("g", topic="a", processor="parity_count", colocate_with="h",
                                    share=0)
                             .stage("x", topic="a", processor="parity_count", colocate_with="x")
                             .stage("y", topic="a", processor="parity_count", colocate_with="q")
                             .stage("z", topic="a", processor="parity_count", colocate_with="g")
                             .elastic("g", policy="threshold", high_lag=1, low_lag=0)),
    "knobs": lambda p: (p.Pipeline.named("kn").topic("a")
                        .stage("s", topic="a", processor="parity_count",
                               window={"window": "tumbling"}, state_partitions=0,
                               checkpoint_every=-1, async_emit=-1, executor="remote",
                               transport="carrier-pigeon")),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_validation_errors_match_jax(case):
    """The same bad programs give the same error lists, in the same order,
    from ``validate()`` and from ``build()``'s exception."""
    lists = []
    for pipeline, _ in PACKAGES.values():
        pipe = BAD_SPECS[case](pipeline)
        errors = pipe.validate()
        with pytest.raises(pipeline.PipelineValidationError) as ei:
            pipe.build()
        assert ei.value.errors == errors
        lists.append(errors)
    assert lists[1] == lists[0] and lists[1]


# each: (``Pipeline`` program, the refusals the port adds)
WAITING = {
    "continuous": (lambda p: p.Pipeline.named("w").topic("a")
                   .stage("s", topic="a", processor="parity_count", engine="continuous",
                          window={"window": "tumbling", "size": 1.0}),
                   ["stage 's': engine='continuous' waits for the port's continuous engine "
                    "(ROADMAP A2)"]),
    "mp": (lambda p: p.Pipeline.named("w").topic("a")
           .stage("s", topic="a", processor="parity_count", engine="continuous",
                  executor="mp"),
           ["stage 's': engine='continuous' waits for the port's continuous engine (ROADMAP A2)",
            "stage 's': executor='mp' waits for the port's worker processes (ROADMAP A2)"]),
    "shm": (lambda p: p.Pipeline.named("w").broker(transport="shm").topic("a")
            .stage("s", topic="a", processor="parity_count", transport="shm"),
            ["broker: transport='shm' waits for the port's shared-memory transport (ROADMAP A2)",
             "stage 's': transport='shm' waits for the port's shared-memory transport "
             "(ROADMAP A2)"]),
    "checkpoint": (lambda p: p.Pipeline.named("w").topic("a")
                   .stage("s", topic="a", processor="parity_count", engine="continuous",
                          checkpoint_every=10)
                   .elastic("s", policy="threshold", high_lag=5, low_lag=1, min_devices=0,
                            preemptible=True),
                   ["stage 's': engine='continuous' waits for the port's continuous engine "
                    "(ROADMAP A2)",
                    "stage 's': checkpoint_every > 0 waits for the port's crash checkpoints and "
                    "StageReconciler (ROADMAP A2, A4)",
                    "elastic on 's': preemptible=True waits for the port's checkpoint-then-kill "
                    "preemption (ROADMAP A2, A4)"]),
    "with_other_errors": (lambda p: p.Pipeline.named("w").topic("a")
                          .stage("s", topic="ghost", processor="parity_count", engine="continuous",
                                 emits=True),
                          ["stage 's': engine='continuous' waits for the port's continuous engine "
                           "(ROADMAP A2)"]),
}


@pytest.mark.parametrize("case", sorted(WAITING))
def test_validation_refuses_what_waits_naming_its_roadmap_item(case):
    """The port lists the JAX package's errors for the program (none, where
    the JAX ``Pipeline`` takes it) and then one refusal per waiting stage kind,
    each naming the ROADMAP item it waits for."""
    program, refusals = WAITING[case]
    jax_errors = program(jax_pipeline).validate()
    torch_errors = program(torch_pipeline).validate()
    assert torch_errors == jax_errors + refusals
    with pytest.raises(torch_pipeline.PipelineValidationError):
        program(torch_pipeline).build()


def test_run_refuses_a_waiting_spec_built_elsewhere():
    """A spec the JAX ``Pipeline`` made with a continuous stage: the port's
    runner refuses it at start (no stage runs as something else) and
    leaves nothing behind."""
    spec = torch_pipeline.PipelineSpec.from_json(WAITING["continuous"][0](jax_pipeline)
                                                 .build().to_json())
    run = spec.run(devices=[CPU] * 2)
    with pytest.raises(torch_pipeline.PipelineValidationError, match="ROADMAP A2"):
        run.start()
    assert run.teardown_log == ["service"] and run.service.pool.leased_devices == 0


# ---------------------------------------------------------------------------
# runs in both packages
# ---------------------------------------------------------------------------


def _tiny(pipeline, name, processor="parity_count", total=64, rate=400):
    return (pipeline.Pipeline.named(name)
            .topic("in", partitions=2)
            .source("in", kind="parity_vec8", rate_msgs_per_s=rate, total_messages=total)
            .stage("s", topic="in", processor=processor, batch_interval=0.05,
                   backpressure=False)
            .build())


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_run_lifecycle_matches_jax():
    """A finite run: every record processed, the same reverse-order
    teardown, idempotent stop, the pool whole again."""
    logs = []
    for pkg, (pipeline, _) in PACKAGES.items():
        run = _tiny(pipeline, "life").run(devices=_devices(pkg, 2)).start()
        _wait(lambda: run.sources_finished and run.lag("s") == 0
              and run.stream("s").stats.records == 64)
        run.stop()
        first = list(run.teardown_log)
        run.stop()
        assert run.teardown_log == first and run.errors == []
        assert run.service.pool.leased_devices == 0 and run.service.pilots == []
        logs.append(first)
    assert logs[0] == logs[1] == ["source:in", "stream:s", "service"]


def test_teardown_order_when_a_stage_fails_mid_run_matches_jax():
    out = []
    for pkg, (pipeline, _) in PACKAGES.items():
        spec = _tiny(pipeline, "boom", processor="parity_explode", total=None)
        with spec.run(devices=_devices(pkg, 2)) as run:
            _wait(lambda: run.stream("s")._error is not None)
        out.append((run.teardown_log, [str(e) for e in run.errors],
                    run.service.pool.leased_devices))
    assert out[0] == out[1]
    assert out[1] == (["source:in", "stream:s", "service"], ["stage blew up mid-run"], 0)


def test_unwinding_a_half_provisioned_run_matches_jax():
    out = []
    for pkg, (pipeline, _) in PACKAGES.items():
        run = _tiny(pipeline, "halfway", processor="parity_broken").run(devices=_devices(pkg, 2))
        with pytest.raises(RuntimeError, match="cannot construct"):
            run.start()
        out.append((run.teardown_log, run.service.pool.leased_devices))
    assert out[0] == out[1] == (["service"], 0)


def _run_to_end(pkg, spec, stage, n_batches):
    pipeline, _ = PACKAGES[pkg]
    with spec.run(devices=_devices(pkg, 2)) as run:
        run.await_batches(stage, n_batches, timeout=120)
        _wait(lambda: run.sources_finished and run.lag(stage) == 0, 120)
        app = run.processor(stage)
        app.sync()
        state = run.stream(stage).state
        return (state, app, run.stream(stage).stats.records, run.source(spec.stages[0].topic))


def test_kmeans_spec_ends_in_the_jax_state():
    """One partition, one message per batch and a fixed, seeded source: both
    packages see the same batch sequence from the same initial centroids
    (the same seed). Final centroids within 1e-5 (f32 sums in another
    order over six batches)."""
    states = {}
    for pkg, (pipeline, _) in PACKAGES.items():
        spec = (pipeline.Pipeline.named("km")
                .topic("t", partitions=1)
                .source("t", kind="cluster", total_messages=6, seed=3, n_clusters=4, dim=3,
                        points_per_msg=400)
                .stage("k", topic="t", processor="kmeans", batch_interval=0.02,
                       max_batch_records=1, n_clusters=4, dim=3, seed=1, decay=0.8)
                .build())
        states[pkg] = _run_to_end(pkg, spec, "k", 6)
    (j_state, j_app, j_rec, _), (t_state, t_app, t_rec, t_src) = states["jax"], states["torch"]
    assert t_rec == j_rec == t_src.sent_records == 6
    assert t_state.device == CPU and t_app.device == CPU
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), rtol=1e-5, atol=1e-5)
    assert t_app.inertia == pytest.approx(j_app.inertia, rel=1e-4)


def test_mlem_spec_ends_in_the_jax_state():
    """A small ML-EM stage (48 angles, n = 64, one frame per batch): the
    last reconstruction within 1e-3 (the ML-EM tolerance of the app test);
    each package makes its own template frame."""
    states = {}
    for pkg, (pipeline, _) in PACKAGES.items():
        spec = (pipeline.Pipeline.named("ml")
                .topic("f", partitions=1)
                .source("f", kind="lightsource", total_messages=3, n_angles=48, n_det=64)
                .stage("r", topic="f", processor="mlem", batch_interval=0.02,
                       max_batch_records=1, n=64, mlem_iters=2)
                .build())
        states[pkg] = _run_to_end(pkg, spec, "r", 3)
    (j_state, _, j_rec, j_src), (t_state, t_app, t_rec, t_src) = states["jax"], states["torch"]
    assert t_rec == j_rec == 3 and t_app.device == CPU and t_state.shape == (64, 64)
    np.testing.assert_allclose(t_src._payload, j_src._payload, atol=1e-4)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state), atol=1e-3)


# ---------------------------------------------------------------------------
# the port's devices
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_run_needs_cuda_unless_given_cpu_slots(no_cuda):
    spec = _tiny(torch_pipeline, "nocuda")
    for devices in (4, None):
        with pytest.raises(RuntimeError, match="CUDA"):
            spec.run(devices=devices)
    assert device_slots([CPU] * 3) == [CPU] * 3


def test_device_slots_spread_round_robin_over_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_slots(5) == [torch.device("cuda", i) for i in (0, 1, 0, 1, 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert device_slots(4) == [torch.device("cuda", 0)] * 4


def test_apps_are_placed_on_their_pilots_device():
    """Factories that take ``device`` get the first device of the stage
    pilot's lease, as they get the bus; an explicit option wins."""
    placed = []

    @torch_pipeline.register_processor("parity_placed")
    class Placed:
        def __init__(self, device="cuda", metrics=None):
            placed.append((device, metrics is not None))

        def process(self, state, msgs):
            return state

    other = torch.device("meta")
    spec = (torch_pipeline.Pipeline.named("place").topic("a")
            .stage("x", topic="a", processor="parity_placed")
            .stage("y", topic="a", processor="parity_placed", device=other)
            .stage("z", topic="a", processor="mlem", n=16)
            .build())
    with spec.run(devices=[CPU] * 3) as run:
        assert run.processor("z").device == CPU
    assert placed == [(CPU, True), (other, True)]
    assert torch_registry.make_processor("parity_count", {}, device=CPU) is not None


def test_cli_validates_and_refuses_what_waits(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(_tiny(torch_pipeline, "cli").to_json())
    assert torch_cli.main(["validate", str(good)]) == 0
    assert "OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(WAITING["continuous"][0](jax_pipeline).build().to_json())
    assert torch_cli.main(["validate", str(bad)]) == 1
    assert "engine='continuous' waits for the port's continuous engine (ROADMAP A2)" \
        in capsys.readouterr().err
    assert torch_cli.main(["run", str(good), "--device", "cpu", "--devices", "2",
                           "--duration", "20", "--report-every", "100"]) == 0
    assert "stage 's': 64 records" in capsys.readouterr().out


def test_elastic_closed_loop_scales_up_and_down_on_cpu_slots():
    """The JAX package's closed-loop scenario, with its settings, on eight
    CPU slots: a rate step overloads a stage whose capacity follows its
    devices, the controller (through the arbiter) grows it, the drain
    shrinks it back; the arbiter never grants more than the pool holds."""
    capacity = {"n": 2}

    @torch_pipeline.register_processor("parity_slow_stage")
    class Slow:
        def process(self, state, msgs):
            time.sleep(len(msgs) * 0.01 / capacity["n"])
            return (state or 0) + len(msgs)

        def on_rescale(self, devices):
            capacity["n"] = max(len(devices), 1)
            return None

    spec = (torch_pipeline.Pipeline.named("elastic")
            .topic("points", partitions=4)
            .source("points", kind="parity_vec8", rate_msgs_per_s=60,
                    rate_schedule=[(0.5, 60), (4.0, 300), (4.0, 40)])
            .stage("work", topic="points", processor="parity_slow_stage",
                   cores_per_node=2, batch_interval=0.05,
                   max_batch_records=32, backpressure=False)
            .elastic("work", policy="threshold", high_lag=80, low_lag=15,
                     up_stable=2, down_stable=3, interval=0.1, cooldown=1.0,
                     min_devices=2, max_devices=6, devices_per_step=2)
            .build())
    with spec.run(devices=[CPU] * 8) as run:
        ctl, t0 = run.controller("work"), time.monotonic()
        while time.monotonic() - t0 < 25:
            if run.scenario("points").finished and ctl.devices == 2 and ctl.events.of("scale_down"):
                break
            time.sleep(0.25)
        assert ctl.events.of("scale_up"), "burst should trigger a scale-up"
        assert ctl.events.of("scale_down"), "drain should trigger a scale-down"
        free = [v for _, v in run.bus.series("scheduler.free")]
        assert free and min(free) >= 0
        assert max(e.devices_after for e in ctl.events) <= 6
    assert run.teardown_log[-1] == "service" and run.errors == []
    assert run.service.pool.leased_devices == 0
