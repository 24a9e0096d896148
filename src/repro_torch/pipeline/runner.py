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

Continuous stages run on ``flink`` pilots, whose keyed state is
partitioned over the pilot's slots (``engines/continuous.py``); a stage
that checkpoints is recovered from a pilot crash by the
:class:`StageReconciler`, and a preemptible one is parked and resumed by
checkpoint-then-kill. A continuous stage with ``executor="mp"`` runs its
partitions in worker processes, spawned where its slots are on a CUDA card.
A broker with ``transport="shm"`` mounts one shared-memory ring per topic
before any data flows.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

from repro_torch.broker.consumer import Consumer, ConsumerGroup
from repro_torch.broker.producer import Producer
from repro_torch.core import PilotComputeService
from repro_torch.core.service import cuda_devices
from repro_torch.elastic import (
    ElasticConfig,
    ElasticController,
    MetricsBus,
    PreemptionHooks,
)
from repro_torch.pipeline import registry
from repro_torch.pipeline.spec import ElasticSpec, PipelineSpec, SinkSpec, StageSpec
from repro_torch.scheduler import HOSTS, ResourceRequest
from repro_torch.streaming.windows import SessionWindow, SlidingWindow, TumblingWindow
from repro_torch.transport import ShmTransport


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


class StageReconciler:
    """Pilot-crash recovery for continuous stages.

    Subscribes to the service's :class:`HeartbeatMonitor` failure
    callbacks; when a *managed* stage pilot goes stale — a real crash
    (``inject_failure``) or a false positive (the ``drop_heartbeats``
    fault) — it fences first and recovers second:

    1. ``stream.crash()`` — idempotent; after this the old incarnation
       cannot emit, so a false positive costs one recovery, never a
       duplicate firing;
    2. ``service.submit_pilot(pcd)`` — a replacement pilot on fresh
       slots;
    3. attach the stream to the new pilot's plugin and ``stream.
       recover()`` — state restored from the latest ``sckpt_*`` spool
       (``StageSpec.checkpoint_every``), consumer re-seeked, replay with
       emit suppression: zero lost, zero duplicated firings;
    4. ``stream.rescale`` onto the new pilot's slots and devices — the
       restored assignment names the dead pilot's (the JAX package stops
       at step 3; its firings are the same either way).

    Usable standalone (tests bind it to hand-built streams) or via
    ``PipelineRun``, which manages every continuous stage that checkpoints.
    """

    def __init__(self, service: PilotComputeService, *, bus: MetricsBus | None = None,
                 on_recovered: Callable[[str, Any], None] | None = None):
        self.service = service
        self.bus = bus
        self.on_recovered = on_recovered
        self.recoveries = 0
        #: (stage name, recovery latency ms) per recovery, oldest first
        self.log: list[tuple[str, float]] = []
        #: recovery failures (kept, not raised — callbacks run on the
        #: monitor thread, which swallows exceptions)
        self.errors: list[BaseException] = []
        self._managed: dict[int, tuple[str, Any, dict]] = {}
        self._closed = False
        self._lock = threading.Lock()
        service.monitor.on_failure(self._on_failure)

    def manage(self, name: str, pilot: Any, stream: Any, pcd: dict) -> None:
        """Watch ``pilot``; on failure, reprovision from ``pcd`` and
        recover ``stream`` onto the replacement."""
        with self._lock:
            self._managed[id(pilot)] = (name, stream, dict(pcd))

    def unmanage(self, pilot: Any) -> None:
        with self._lock:
            self._managed.pop(id(pilot), None)

    def close(self) -> None:
        """Stop reconciling (the monitor keeps its callback — it just
        no-ops); teardown calls this before stopping streams so a stop
        is not mistaken for a crash."""
        with self._lock:
            self._closed = True
            self._managed.clear()

    def _on_failure(self, pilot: Any) -> None:
        with self._lock:
            if self._closed:
                return
            entry = self._managed.pop(id(pilot), None)
        if entry is None:
            return  # not ours (another run's pilot on a shared service)
        name, stream, pcd = entry
        t0 = time.perf_counter()
        try:
            stream.crash()  # fencing — safe and idempotent on a dead stream
            new_pilot = self.service.submit_pilot(pcd)
            plugin = new_pilot.plugin
            if hasattr(plugin, "streams") and stream not in plugin.streams:
                plugin.streams.append(stream)
            stream.recover()
            # the restored assignment still names the dead pilot's slots:
            # re-home the partitions onto the replacement's (the mp
            # executor places its workers by them)
            slots = list(getattr(plugin, "slots", []) or [])
            if slots:
                stream.rescale(slots, list(plugin.devices))
        except BaseException as e:
            self.errors.append(e)
            return
        ms = (time.perf_counter() - t0) * 1e3
        self.recoveries += 1
        self.log.append((name, ms))
        if self.bus is not None:
            self.bus.publish("pipeline.stage_recoveries", self.recoveries,
                             stage=name)
            self.bus.publish("pipeline.stage_recovery_ms", ms, stage=name)
        self.manage(name, new_pilot, stream, pcd)
        if self.on_recovered is not None:
            self.on_recovered(name, new_pilot)


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


def _make_assigner(window: dict):
    kind = window.get("window", "tumbling")
    if kind == "tumbling":
        return TumblingWindow(window.get("size", 1.0))
    if kind == "sliding":
        return SlidingWindow(window.get("size", 1.0), window.get("slide", 0.5))
    return SessionWindow(window.get("gap", 1.0))


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
        #: pilot-crash recovery — set during provisioning iff any
        #: continuous stage checkpoints (StageSpec.checkpoint_every)
        self.reconciler: StageReconciler | None = None
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
        if spec.broker.transport == "shm":
            # mount the zero-copy data plane before any topic carries data;
            # ring allocator stall joins io_stall_seconds, so the broker
            # saturation probe (and elasticity) needs no special casing
            transport = ShmTransport(**dict(spec.broker.transport_options))
            self.cluster.attach_transport(transport)
            self._push("transport", transport.close)
        for topic, parts in spec.broker.topics.items():
            self.cluster.create_topic(
                topic, parts,
                replication_factor=min(spec.broker.replication_factor,
                                       spec.broker.nodes))
            if spec.broker.transport == "shm":
                self.cluster.transport.mount(topic)

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

        recoverable = [
            s for s in spec.stages
            if s.engine == "continuous" and s.checkpoint_every
            and s.colocate_with is None
        ]
        if recoverable:
            self.reconciler = StageReconciler(
                self.service, bus=self.bus,
                on_recovered=lambda name, pilot: self._pilots.__setitem__(
                    name, pilot))
            for stage in recoverable:
                self.reconciler.manage(
                    stage.name, self._pilots[stage.name],
                    self._streams[stage.name],
                    {"number_of_nodes": stage.nodes,
                     "cores_per_node": stage.cores_per_node,
                     "type": "flink"})
            self._push("reconciler", self.reconciler.close)

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
            framework = "spark" if stage.engine == "microbatch" else "flink"
            pilot = self.service.submit_pilot({
                "number_of_nodes": stage.nodes,
                "cores_per_node": stage.cores_per_node,
                "type": framework,
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

        if stage.engine == "microbatch":
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
        else:
            window_fn = proc.process if hasattr(proc, "process") else proc
            # a processor object may key its records (``key_fn(msg)``), take
            # each fired window's output exactly once (``emit(out)``,
            # replays suppressed) and, for an mp stage, set its worker
            # runtime's knobs (``worker_options``: snapshot_every,
            # batch_timeout, heartbeat_timeout, ...). Without them every
            # record has the key None and outputs are dropped, as in the
            # JAX package's runner, whose StageSpec carries none of them
            # (ROADMAP C5)
            keyed = {k: getattr(proc, k) for k in ("key_fn", "emit", "worker_options")
                     if hasattr(proc, k)}
            stream = ctx.stream(
                self.cluster, stage.topic,
                group=stage.consumer_group,
                assigner=_make_assigner(stage.window),
                window_fn=window_fn,
                **keyed,
                allowed_lateness=stage.window.get("allowed_lateness", 0.0),
                metrics=self.bus,
                # rescale sync barrier auto-wires from a bound window_fn's
                # .sync, same as the micro-batch engine
                on_rescale=getattr(proc, "on_rescale", None),
                metrics_label=label,
                n_partitions=stage.state_partitions,
                executor=stage.executor,
                checkpoint_every=stage.checkpoint_every,
                transport=stage.transport,
                async_emit=stage.async_emit,
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
            hooks=(self._make_preemption_hooks(stage, stream)
                   if el.preemptible else None),
        )

    def _make_preemption_hooks(self, stage: StageSpec, stream) -> PreemptionHooks:
        """Checkpoint-then-kill wiring for a preemptible stage
        (``Pipeline.validate`` guarantees: continuous engine,
        checkpoint_every > 0, min_devices == 0). The kill hook detaches the
        stream from its plugin *before* the controller cancels the pilots —
        a plugin-driven ``stream.stop()`` would delete the sckpt spools the
        resume needs — and unmanages the pilot so the reconciler cannot
        mistake the deliberate cancel for a crash."""
        name = stage.name
        pcd = {"number_of_nodes": stage.nodes,
               "cores_per_node": stage.cores_per_node, "type": "flink"}

        def checkpoint() -> None:
            stream.checkpoint()

        def kill() -> None:
            pilot = self._pilots[name]
            plugin = getattr(pilot, "plugin", None)
            if plugin is not None and stream in getattr(plugin, "streams", ()):
                plugin.streams.remove(stream)
            if self.reconciler is not None:
                self.reconciler.unmanage(pilot)
            stream.crash()

        def resume(pilot) -> None:
            plugin = pilot.plugin
            if hasattr(plugin, "streams") and stream not in plugin.streams:
                plugin.streams.append(stream)
            stream.recover()
            # the replacement pilot may hold other slots than the parked
            # one (that's the whole point of preemption): re-home the
            # restored state onto the new owner set (the mp executor
            # places its workers by them)
            slots = list(getattr(plugin, "slots", []) or [])
            if slots:
                stream.rescale(slots, list(plugin.devices))
            self._pilots[name] = pilot
            if self.reconciler is not None:
                self.reconciler.manage(name, pilot, stream, pcd)

        return PreemptionHooks(checkpoint, kill, resume)

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

    def await_windows(self, stage: str, n: int, timeout: float = 30.0) -> None:
        self._streams[stage].await_windows(n, timeout=timeout)

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
