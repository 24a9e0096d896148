"""PipelineRun — one call from spec to a live, elastic pipeline.

Implements the declarative layer purely on top of the imperative API
(``PilotComputeService`` / engine plugins / ``repro_torch.elastic``):
nothing the runner does is impossible by hand, it just encodes the ordering
and wiring that every hand-written example used to repeat.

Start order (dependencies first)::

    service -> broker pilot -> topics -> engine pilots -> sinks
            -> streams -> controllers -> sources -> rate scenarios

Teardown runs the exact reverse, even when ``start()`` fails half-way or a
stage dies mid-run: every component is pushed onto a stack as it comes up,
and ``stop()`` pops the stack, recording (not raising) per-component
errors so one wedged component cannot leak the pilots behind it.

Devices: ``devices=N`` is a pool of N slots spread round-robin over the
host's CUDA cards (on one card, N slots of ``cuda:0``); a list is the pool
itself (tests pass ``[torch.device("cpu")] * N``); ``None`` is every card.
Each stage's app is placed on the first device of its pilot's lease. On one
card, scaling a stage adds slots that share that card: the control loop,
the arbiter's grants and the apps' ``on_rescale`` state moves are real, but
no arithmetic throughput is added.

What waits for later modules (the continuous engine, the mp executor, the
shm transport, crash checkpoints with their StageReconciler, preemption:
ROADMAP A2, A4) is refused at start, as ``Pipeline.validate`` refuses it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

from repro_torch.broker.consumer import Consumer, ConsumerGroup
from repro_torch.broker.producer import Producer
from repro_torch.core import PilotComputeService
from repro_torch.core.service import cuda_devices
from repro_torch.elastic import ElasticConfig, ElasticController, MetricsBus
from repro_torch.pipeline import registry
from repro_torch.pipeline.builder import PipelineValidationError, waiting_errors
from repro_torch.pipeline.spec import ElasticSpec, PipelineSpec, SinkSpec, StageSpec
from repro_torch.scheduler import HOSTS, ResourceRequest


class BrokerStallProbe:
    """Differentiates the cluster's cumulative token-bucket stall seconds
    into a per-tick stall *fraction* — the broker controller's saturation
    signal (clamped to [0, 1]; concurrent producers can stall in
    parallel)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._t = time.monotonic()
        self._s = cluster.io_stall_seconds()

    def __call__(self) -> float:
        now, s = time.monotonic(), self.cluster.io_stall_seconds()
        dt = max(now - self._t, 1e-6)
        frac = (s - self._s) / dt
        self._t, self._s = now, s
        return min(max(frac, 0.0), 1.0)


class SinkRunner:
    """Terminal consumer: drains a topic, applying a fn or collecting."""

    def __init__(self, spec: SinkSpec, cluster, fn: Callable | None):
        self.spec = spec
        self.items: list = []
        self._fn = fn
        group = ConsumerGroup(cluster, f"sink-{spec.name}", spec.topic)
        self._consumer = Consumer(cluster, group, member_id=f"sink-{spec.name}")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                msgs = self._consumer.poll(max_records=256, timeout=0.05)
                for m in msgs:
                    if self._fn is not None:
                        self._fn(m)
                    else:
                        self.items.append(m.value)
                if msgs:
                    self._consumer.commit()
            except BaseException as e:
                self.error = e
                return

    def start(self) -> "SinkRunner":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.error is not None:  # surfaced into PipelineRun.errors
            raise self.error


class PipelineRun:
    """Context manager around one provisioned pipeline.

    ``with spec.run(devices=8) as run:`` starts everything; leaving the
    block (or calling :meth:`stop`, which is idempotent) tears down in
    reverse order. Pass an existing ``service`` to share a device pool with
    other pipelines; the run then only cancels the pilots *it* created.
    """

    def __init__(self, spec: PipelineSpec, *, service: PilotComputeService | None = None,
                 devices: int | list | None = None, bus: MetricsBus | None = None,
                 share: float | None = None):
        self.spec = spec
        self.bus = bus or MetricsBus()
        self._own_service = service is None
        if service is None:
            service = PilotComputeService(devices=device_slots(devices), metrics=self.bus)
        self.service = service
        #: pipeline-level fair-share weight (spec.share unless overridden);
        #: every stage request carries ``share * stage.share``
        self.share = spec.share if share is None else share
        #: the service's single ResourceArbiter — set during provisioning
        #: iff any stage (or the broker) is elastic
        self.arbiter = None
        self.cluster = None
        self._streams: dict[str, Any] = {}
        self._pilots: dict[str, Any] = {}
        self._controllers: dict[str, ElasticController] = {}
        self._sources: dict[str, list] = {}  # topic -> sources, spec order
        self._scenarios: dict[str, list] = {}
        self._sinks: dict[str, SinkRunner] = {}
        self._processors: dict[str, Any] = {}
        #: LIFO of (label, stop_callable) — teardown pops from the end
        self._teardown: list[tuple[str, Callable[[], None]]] = []
        #: labels in the order components were torn down (tests assert this)
        self.teardown_log: list[str] = []
        #: component errors collected during stop() — never raised there
        self.errors: list[BaseException] = []
        self._started = False
        self._stopped = False
        self._lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "PipelineRun":
        if self._started:
            return self
        self._started = True
        try:
            self._provision()
        except BaseException:
            # unwind whatever came up before the failure, then re-raise
            self.stop()
            raise
        return self

    def __enter__(self) -> "PipelineRun":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def stop(self) -> None:
        """Reverse-order teardown; safe to call twice (second call no-ops)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            steps, self._teardown = list(self._teardown), []
        for label, fn in reversed(steps):
            try:
                fn()
            except BaseException as e:
                self.errors.append(e)
            finally:
                self.teardown_log.append(label)

    # -- provisioning (start order = spec dependency order) --------------------

    def _push(self, label: str, stop_fn: Callable[[], None]) -> None:
        self._teardown.append((label, stop_fn))

    def _provision(self) -> None:
        spec = self.spec
        if self._own_service:
            self._push("service", self.service.cancel)
        waiting = waiting_errors(
            spec.broker, spec.stages,
            {s.name: s.elastic for s in spec.stages if s.elastic is not None})
        if waiting:
            raise PipelineValidationError(waiting)

        # one arbiter per *service*: every run sharing the pool files its
        # requests here, so contention resolves by weight/priority instead
        # of first-come-first-served. Refcounted — the loop stops when the
        # last run releases it.
        if spec.broker.elastic is not None or any(
            s.elastic is not None for s in spec.stages
        ):
            self.arbiter = self.service.get_arbiter(self.bus).retain()
            self._push("arbiter", self.arbiter.release)

        broker_pilot = self.service.submit_pilot({
            "number_of_nodes": spec.broker.nodes,
            "type": spec.broker.framework,
            "io_rate_per_node": spec.broker.io_rate_per_node,
        })
        self._pilots["__broker__"] = broker_pilot
        if not self._own_service:
            self._push("broker", broker_pilot.cancel)
        self.cluster = broker_pilot.get_context()
        self.cluster.metrics = self.bus  # broker.failovers/lost_records
        for topic, parts in spec.broker.topics.items():
            self.cluster.create_topic(
                topic, parts,
                replication_factor=min(spec.broker.replication_factor,
                                       spec.broker.nodes))

        # host stages before their co-located guests (a guest reuses the
        # host's pilot, so the host must exist first)
        ordered = [s for s in spec.stages if s.colocate_with is None] + [
            s for s in spec.stages if s.colocate_with is not None
        ]
        for stage in ordered:
            self._provision_stage(stage)

        for sink in spec.sinks:
            fn = None if sink.kind == "collect" else registry.resolve_sink(sink.kind)
            runner = SinkRunner(sink, self.cluster, fn)
            self._sinks[sink.name] = runner
            runner.start()
            self._push(f"sink:{sink.name}", runner.stop)

        for stage in spec.stages:
            stream = self._streams[stage.name]
            stream.start()
            self._push(f"stream:{stage.name}", stream.stop)

        for stage in spec.stages:
            if stage.elastic is not None:
                ctl = self._make_controller(stage)
                self._controllers[stage.name] = ctl
                ctl.start()
                self._push(f"controller:{stage.name}", ctl.shutdown)

        if spec.broker.elastic is not None:
            ctl = self._make_broker_controller(spec.broker.elastic)
            self._controllers["__broker__"] = ctl
            ctl.start()
            self._push("controller:__broker__", ctl.shutdown)

        for src_spec in spec.sources:
            source, scenario = self._make_source(src_spec)
            self._sources.setdefault(src_spec.topic, []).append(source)
            source.start()
            self._push(f"source:{src_spec.topic}", source.stop)
            if scenario is not None:
                self._scenarios.setdefault(src_spec.topic, []).append(scenario)
                scenario.start()
                self._push(f"scenario:{src_spec.topic}", scenario.stop)

    def _provision_stage(self, stage: StageSpec) -> None:
        if stage.colocate_with is not None:
            # spec-level placement: the guest rides the host's pilot (and
            # its rescales); the host owns provisioning and teardown
            pilot = self._pilots[stage.colocate_with]
            self._pilots[stage.name] = pilot
        else:
            pilot = self.service.submit_pilot({
                "number_of_nodes": stage.nodes,
                "cores_per_node": stage.cores_per_node,
                "type": "spark",
            })
            self._pilots[stage.name] = pilot
            if not self._own_service:
                self._push(f"pilot:{stage.name}", pilot.cancel)
        ctx = pilot.get_context()
        # the app lives on the first device of its pilot's lease (a pilot
        # that got no device leaves the factory's own default: the card)
        lease = pilot.lease.devices
        proc = registry.make_processor(
            stage.processor, dict(stage.options), metrics=self.bus,
            device=lease[0] if lease else None)
        self._processors[stage.name] = proc
        # topic alone is ambiguous when two stages consume the same topic,
        # and topic/group alone is ambiguous when two *pipelines* share a
        # bus (the multi-tenant case) — qualify with the pipeline name so
        # each controller only ever reads its own stage's gauges
        label = f"{self.spec.name}/{stage.topic}/{stage.consumer_group}"

        process_fn = proc.process if hasattr(proc, "process") else proc
        on_rescale = getattr(proc, "on_rescale", None)
        sync_fn = getattr(proc, "sync", None)
        if stage.emits:
            process_fn = self._emitting(process_fn, stage.output_topic)
        stream = ctx.stream(
            self.cluster, stage.topic,
            group=stage.consumer_group,
            process_fn=process_fn,
            batch_interval=stage.batch_interval,
            max_batch_records=stage.max_batch_records,
            backpressure=stage.backpressure,
            metrics=self.bus,
            sync_fn=sync_fn,
            on_rescale=on_rescale,
            metrics_label=label,
            transport=stage.transport,
        )
        self._streams[stage.name] = stream

    def _emitting(self, fn: Callable, topic: str) -> Callable:
        """Wrap a ``(state, msgs) -> (state, outputs)`` processor so outputs
        land on the stage's output topic."""
        producer = Producer(self.cluster, topic, serializer="npy")

        def wrapped(state, msgs):
            state, outs = fn(state, msgs)
            for out in outs or ():
                producer.send(out)
            return state

        return wrapped

    def _request_name(self, component: str) -> str:
        return f"{self.spec.name}/{component}"

    def _make_controller(self, stage: StageSpec) -> ElasticController:
        el = stage.elastic
        params = dict(el.params)
        if el.policy == "latency":
            params.setdefault("batch_interval", stage.batch_interval)
        policy = registry.resolve_policy(el.policy)(**params)
        stream = self._streams[stage.name]
        # no colocate hint on the request: an elastic stage is never a
        # co-location guest (``Pipeline.validate`` checks), so spec-level placement is
        # entirely the pilot sharing done in _provision_stage
        request = ResourceRequest(
            name=self._request_name(stage.name),
            min_devices=el.min_devices,
            max_devices=el.max_devices,
            weight=stage.share * self.share,
            priority=stage.priority,
        )
        return ElasticController(
            self.service, self._pilots[stage.name], self.bus, policy,
            config=ElasticConfig(
                interval=el.interval, min_devices=el.min_devices,
                max_devices=el.max_devices,
                devices_per_step=el.devices_per_step, cooldown=el.cooldown,
                migration_cost_frac=el.migration_cost_frac,
            ),
            lag_probe=lambda: sum(stream.lag().values()),
            # scope the controller's snapshot to this stage's stream gauges
            # (the bus is shared by every stage in the pipeline)
            stream=stream.metrics_label,
            arbiter=self.arbiter,
            request=request,
        )

    def _make_broker_controller(self, el: ElasticSpec) -> ElasticController:
        """Spec-driven broker elasticity: a node-unit controller estimates
        demand from the producer token-bucket saturation signal; arbiter
        grants become ``BrokerCluster.add_node/remove_node`` via extension
        pilots on the broker pilot — no direct ``add_node`` calls here."""
        label = self._request_name("__broker__")
        policy = registry.resolve_policy(el.policy)(**dict(el.params))
        request = ResourceRequest(
            name=label,
            min_devices=el.min_devices,
            max_devices=el.max_devices,
            weight=self.share,
            unit=HOSTS,
        )
        return ElasticController(
            self.service, self._pilots["__broker__"], self.bus, policy,
            config=ElasticConfig(
                interval=el.interval, min_devices=el.min_devices,
                max_devices=el.max_devices,
                devices_per_step=el.devices_per_step, cooldown=el.cooldown,
            ),
            probes={"broker.stall_frac": BrokerStallProbe(self.cluster)},
            stream=label,
            unit="nodes",
            arbiter=self.arbiter,
            request=request,
        )

    def _make_source(self, src) -> tuple:
        from repro_torch.miniapps import RateStepScenario, SourceConfig

        factory = registry.resolve_source(src.kind)
        config = SourceConfig(
            src.topic, rate_msgs_per_s=src.rate_msgs_per_s,
            total_messages=src.total_messages, n_producers=src.n_producers,
            seed=src.seed,
        )
        source = factory(self.cluster, config, **dict(src.options))
        scenario = None
        if src.rate_schedule:
            scenario = RateStepScenario(source, [tuple(s) for s in src.rate_schedule])
        return source, scenario

    # -- accessors ------------------------------------------------------------

    def stream(self, stage: str):
        return self._streams[stage]

    def processor(self, stage: str):
        return self._processors[stage]

    def controller(self, stage: str) -> ElasticController:
        return self._controllers[stage]

    def source(self, topic: str, index: int = 0):
        """The ``index``-th source feeding ``topic`` (spec order) — a topic
        may have several producer groups."""
        return self._sources[topic][index]

    def scenario(self, topic: str, index: int = 0):
        return self._scenarios[topic][index]

    def sink(self, name: str) -> SinkRunner:
        return self._sinks[name]

    @property
    def controllers(self) -> dict[str, ElasticController]:
        """Live controllers by stage name (plus ``__broker__``) — the
        public view the CLI's progress loop reads."""
        return dict(self._controllers)

    @property
    def sources_finished(self) -> bool:
        """True once every (finite) source has produced its quota."""
        return all(
            src.finished for srcs in self._sources.values() for src in srcs
        )

    def pilot(self, stage: str):
        return self._pilots[stage]

    @property
    def broker_pilot(self):
        """The broker's pilot — parent for manual extension pilots
        (paper Listing 4)."""
        return self._pilots["__broker__"]

    @property
    def broker_controller(self) -> ElasticController:
        """The node-unit controller created by ``BrokerSpec.elastic``."""
        return self._controllers["__broker__"]

    def await_batches(self, stage: str, n: int, timeout: float = 60.0) -> None:
        self._streams[stage].await_batches(n, timeout=timeout)

    def lag(self, stage: str) -> float:
        return float(sum(self._streams[stage].lag().values()))


def device_slots(devices: int | list | None) -> list | None:
    """The device pool of a run: ``N`` slots round-robin over the host's
    CUDA cards (raises without one), a list as it is, ``None`` for the
    service's default (every card)."""
    if isinstance(devices, int):
        cards = cuda_devices()
        return [cards[i % len(cards)] for i in range(devices)]
    return devices
