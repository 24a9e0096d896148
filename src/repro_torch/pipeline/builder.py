"""Fluent pipeline builder — compose, then validate, then get a frozen spec.

    pipe = (Pipeline.named("kmeans")
            .broker(nodes=2)
            .topic("points", partitions=8)
            .source("points", kind="cluster", rate_msgs_per_s=200,
                    n_clusters=10, dim=3)
            .stage("score", topic="points", processor="kmeans",
                   cores_per_node=2, batch_interval=0.05,
                   n_clusters=10, dim=3)
            .elastic("score", policy="threshold", high_lag=80, low_lag=15)
            .build())
    with pipe.run(devices=8) as run:
        run.await_batches("score", 10)

Validation happens in :meth:`Pipeline.build` — unknown topics, duplicate
names, topic cycles, unknown processors/sources/policies, engine/knob
mismatches, and the stage kinds the port cannot run yet
(:func:`waiting_errors`) — so misconfigurations fail before any pilot is
provisioned, not minutes into a run.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.pipeline import registry
from repro_torch.pipeline.spec import (
    BrokerSpec,
    ElasticSpec,
    PipelineSpec,
    SinkSpec,
    SourceSpec,
    StageSpec,
)

_STAGE_FIELDS = {
    "engine", "nodes", "cores_per_node", "group", "output_topic", "emits",
    "batch_interval", "max_batch_records", "backpressure", "window",
    "state_partitions", "executor", "checkpoint_every", "priority", "share",
    "colocate_with", "transport", "async_emit",
}
_TRANSPORTS = {"log", "shm"}
_SOURCE_FIELDS = {
    "rate_msgs_per_s", "total_messages", "n_producers", "seed", "rate_schedule",
}
_ENGINES = {"microbatch", "continuous"}
_EXECUTORS = {"inline", "mp"}
_WINDOWS = {"tumbling", "sliding", "session"}


class PipelineValidationError(ValueError):
    """Raised by :meth:`Pipeline.build` with every problem found (not just
    the first)."""

    def __init__(self, errors: list[str]):
        self.errors = list(errors)
        super().__init__(
            "invalid pipeline:\n" + "\n".join(f"  - {e}" for e in errors)
        )


class Pipeline:
    """Mutable accumulator behind the fluent API; ``build()`` returns the
    immutable :class:`PipelineSpec`."""

    def __init__(self, name: str):
        self._name = name
        self._broker = BrokerSpec()
        self._broker_elastic: ElasticSpec | None = None
        self._topics: dict[str, int] = {}
        self._sources: list[SourceSpec] = []
        self._stages: list[StageSpec] = []
        self._sinks: list[SinkSpec] = []
        self._elastic: dict[str, ElasticSpec] = {}
        self._share = 1.0

    @classmethod
    def named(cls, name: str) -> "Pipeline":
        return cls(name)

    @classmethod
    def from_spec(cls, spec: PipelineSpec) -> "Pipeline":
        """Rehydrate a ``Pipeline`` from a (possibly deserialized) spec so it can
        be re-validated — the ``python -m repro_torch.pipeline validate`` path for specs
        that never went through ``build()``."""
        p = cls(spec.name)
        p._broker = spec.broker
        p._broker_elastic = spec.broker.elastic
        p._topics = dict(spec.broker.topics)
        p._sources = list(spec.sources)
        p._stages = list(spec.stages)
        p._sinks = list(spec.sinks)
        p._elastic = {s.name: s.elastic for s in spec.stages if s.elastic is not None}
        p._share = spec.share
        return p

    def validate(self) -> list[str]:
        """Every problem in the accumulated topology (empty = valid)."""
        return self._validate()

    # -- broker ---------------------------------------------------------------

    def broker(self, *, nodes: int = 1, framework: str = "kafka",
               io_rate_per_node: float | None = None,
               replication_factor: int = 1,
               transport: str = "log",
               transport_options: dict | None = None) -> "Pipeline":
        self._broker = BrokerSpec(nodes=nodes, framework=framework,
                                  io_rate_per_node=io_rate_per_node,
                                  replication_factor=replication_factor,
                                  transport=transport,
                                  transport_options=transport_options or {})
        return self

    def broker_elastic(self, *, policy: str = "broker_saturation",
                       interval: float = 0.5, min_nodes: int = 1,
                       max_nodes: int | None = None, cooldown: float = 1.0,
                       **params) -> "Pipeline":
        """Make the *broker* elastic: a node-unit controller scales
        ``BrokerCluster`` membership through the arbiter, by default off the
        producer token-bucket saturation signal (``broker.stall_frac``)."""
        self._broker_elastic = ElasticSpec(
            policy=policy, params=params, interval=interval,
            min_devices=min_nodes, max_devices=max_nodes, cooldown=cooldown,
        )
        return self

    def share(self, weight: float) -> "Pipeline":
        """Pipeline-level fair-share weight against other runs on a shared
        service (default 1.0)."""
        self._share = weight
        return self

    def topic(self, name: str, partitions: int = 4) -> "Pipeline":
        self._topics[name] = partitions
        return self

    # -- components -----------------------------------------------------------

    def source(self, topic: str, *, kind: str = "cluster", **kw) -> "Pipeline":
        """Attach a producer group to ``topic``. Keyword args split between
        :class:`SourceSpec` fields and factory ``options``."""
        spec_kw = {k: kw.pop(k) for k in list(kw) if k in _SOURCE_FIELDS}
        self._sources.append(
            SourceSpec(topic=topic, kind=kind, options=kw, **spec_kw)
        )
        return self

    def stage(self, name: str, *, topic: str,
              processor: str | Callable[..., Any], **kw) -> "Pipeline":
        """Add a processing stage consuming ``topic``. ``processor`` is a
        registry name or a callable (auto-registered under its
        ``__name__``). Remaining kwargs split between :class:`StageSpec`
        fields and processor ``options``."""
        if callable(processor):
            # qualify with the defining module so two pipelines' same-named
            # local functions cannot silently overwrite each other
            ref = f"{processor.__module__}.{processor.__qualname__}"
            registry.register_processor(ref, processor)
            processor = ref
        spec_kw = {k: kw.pop(k) for k in list(kw) if k in _STAGE_FIELDS}
        self._stages.append(
            StageSpec(name=name, topic=topic, processor=processor,
                      options=kw, **spec_kw)
        )
        return self

    def sink(self, name: str, *, topic: str,
             fn: str | Callable | None = None, **options) -> "Pipeline":
        """Drain ``topic``: collect messages (default) or apply ``fn`` per
        message (a registry name or callable)."""
        kind = "collect"
        if fn is not None:
            if callable(fn):
                ref = f"{fn.__module__}.{fn.__qualname__}"
                registry.register_sink(ref, fn)
                fn = ref
            kind = fn
        self._sinks.append(SinkSpec(name=name, topic=topic, kind=kind,
                                    options=options))
        return self

    def elastic(self, stage: str, *, policy: str = "threshold",
                interval: float = 0.5, min_devices: int = 1,
                max_devices: int | None = None, devices_per_step: int = 1,
                cooldown: float = 1.0,
                migration_cost_frac: float | None = None,
                preemptible: bool = False,
                **params) -> "Pipeline":
        """Make ``stage`` elastic: ``policy`` + ``params`` select/configure
        the ScalingPolicy, the rest configure the controller.
        ``migration_cost_frac`` holds rescales while the last keyed-state
        migration is still amortizing (continuous stages).
        ``preemptible=True`` lets a zero-device grant park the whole stage
        via checkpoint-then-kill instead of keeping the base pilot's floor
        (continuous + checkpoint_every > 0 + min_devices == 0 only)."""
        self._elastic[stage] = ElasticSpec(
            policy=policy, params=params, interval=interval,
            min_devices=min_devices, max_devices=max_devices,
            devices_per_step=devices_per_step, cooldown=cooldown,
            migration_cost_frac=migration_cost_frac,
            preemptible=preemptible,
        )
        return self

    # -- finalize -------------------------------------------------------------

    def build(self) -> PipelineSpec:
        errors = self._validate()
        if errors:
            raise PipelineValidationError(errors)
        stages = tuple(
            s if s.name not in self._elastic
            else StageSpec(**{**_stage_kwargs(s), "elastic": self._elastic[s.name]})
            for s in self._stages
        )
        broker = BrokerSpec(
            nodes=self._broker.nodes,
            framework=self._broker.framework,
            topics=dict(self._topics),
            io_rate_per_node=self._broker.io_rate_per_node,
            replication_factor=self._broker.replication_factor,
            transport=self._broker.transport,
            transport_options=dict(self._broker.transport_options),
            elastic=self._broker_elastic,
        )
        return PipelineSpec(
            name=self._name,
            broker=broker,
            sources=tuple(self._sources),
            stages=stages,
            sinks=tuple(self._sinks),
            share=self._share,
        )

    def _validate(self) -> list[str]:
        errors: list[str] = []
        if not self._name:
            errors.append("pipeline needs a non-empty name")
        if self._broker.nodes < 1:
            errors.append(f"broker needs >= 1 node, got {self._broker.nodes}")
        if self._broker.replication_factor < 1:
            errors.append(
                "broker replication_factor must be >= 1, got "
                f"{self._broker.replication_factor}"
            )
        elif self._broker.replication_factor > self._broker.nodes:
            errors.append(
                f"broker replication_factor {self._broker.replication_factor} "
                f"exceeds node count {self._broker.nodes}: replicas live on "
                "distinct nodes"
            )
        if self._broker.transport not in _TRANSPORTS:
            errors.append(
                f"broker: unknown transport {self._broker.transport!r} "
                f"(expected one of {sorted(_TRANSPORTS)})"
            )
        for name, parts in self._topics.items():
            if parts < 1:
                errors.append(f"topic {name!r} needs >= 1 partition, got {parts}")

        seen_stage: set[str] = set()
        for s in self._stages:
            if s.name in seen_stage:
                errors.append(f"duplicate stage name {s.name!r}")
            seen_stage.add(s.name)
            if s.topic not in self._topics:
                errors.append(f"stage {s.name!r} consumes unknown topic {s.topic!r}")
            if s.output_topic is not None and s.output_topic not in self._topics:
                errors.append(
                    f"stage {s.name!r} emits to unknown topic {s.output_topic!r}"
                )
            if s.output_topic == s.topic:
                errors.append(
                    f"stage {s.name!r} reads and writes topic {s.topic!r} "
                    "(self-loop)"
                )
            if s.engine not in _ENGINES:
                errors.append(
                    f"stage {s.name!r}: unknown engine {s.engine!r} "
                    f"(expected one of {sorted(_ENGINES)})"
                )
            if s.executor not in _EXECUTORS:
                errors.append(
                    f"stage {s.name!r}: unknown executor {s.executor!r} "
                    f"(expected one of {sorted(_EXECUTORS)})"
                )
            elif s.executor == "mp" and s.engine != "continuous":
                errors.append(
                    f"stage {s.name!r}: executor='mp' requires the "
                    "continuous engine (the micro-batch engine has no "
                    "partition workers)"
                )
            if s.engine == "continuous":
                w = s.window.get("window", "tumbling")
                if w not in _WINDOWS:
                    errors.append(
                        f"stage {s.name!r}: unknown window kind {w!r} "
                        f"(expected one of {sorted(_WINDOWS)})"
                    )
                if s.emits:
                    errors.append(
                        f"stage {s.name!r}: emits=True requires the "
                        "micro-batch engine"
                    )
            elif s.window:
                errors.append(
                    f"stage {s.name!r}: window options only apply to the "
                    "continuous engine"
                )
            if s.emits and s.output_topic is None:
                errors.append(f"stage {s.name!r}: emits=True needs output_topic")
            if s.output_topic is not None and not s.emits:
                errors.append(
                    f"stage {s.name!r}: output_topic needs emits=True "
                    "(processor must return (state, outputs))"
                )
            if s.transport is not None:
                if s.transport not in _TRANSPORTS:
                    errors.append(
                        f"stage {s.name!r}: unknown transport {s.transport!r} "
                        f"(expected one of {sorted(_TRANSPORTS)})"
                    )
                elif s.transport == "shm" and self._broker.transport != "shm":
                    errors.append(
                        f"stage {s.name!r}: transport='shm' requires the "
                        "broker to mount the shm data plane "
                        "(broker(transport='shm'))"
                    )
            if s.processor not in registry.known_processors():
                errors.append(f"stage {s.name!r}: unknown processor {s.processor!r}")
            if s.share <= 0:
                errors.append(f"stage {s.name!r}: share must be > 0, got {s.share}")
            if s.state_partitions < 1:
                errors.append(
                    f"stage {s.name!r}: state_partitions must be >= 1, "
                    f"got {s.state_partitions}"
                )
            if s.checkpoint_every < 0:
                errors.append(
                    f"stage {s.name!r}: checkpoint_every must be >= 0, "
                    f"got {s.checkpoint_every}"
                )
            elif s.checkpoint_every and s.engine != "continuous":
                errors.append(
                    f"stage {s.name!r}: checkpoint_every only applies to the "
                    "continuous engine (the micro-batch engine checkpoints "
                    "per batch already)"
                )
            if s.async_emit < 0:
                errors.append(
                    f"stage {s.name!r}: async_emit must be >= 0, "
                    f"got {s.async_emit}"
                )
            elif s.async_emit and s.engine != "continuous":
                errors.append(
                    f"stage {s.name!r}: async_emit only applies to the "
                    "continuous engine (the micro-batch engine double-buffers "
                    "inside its apps)"
                )
            elif s.async_emit and s.executor == "mp":
                errors.append(
                    f"stage {s.name!r}: async_emit requires the inline "
                    "executor (mp workers already overlap host routing with "
                    "device compute across processes)"
                )

        by_stage_name = {s.name: s for s in self._stages}
        for s in self._stages:
            if s.colocate_with is None:
                continue
            target = by_stage_name.get(s.colocate_with)
            if s.colocate_with == s.name:
                errors.append(f"stage {s.name!r} cannot colocate_with itself")
            elif target is None:
                errors.append(
                    f"stage {s.name!r}: unknown co-location target "
                    f"{s.colocate_with!r}"
                )
            elif target.engine != s.engine:
                errors.append(
                    f"stage {s.name!r} (engine {s.engine!r}) cannot colocate "
                    f"with {target.name!r} (engine {target.engine!r}): "
                    "co-located stages share one pilot"
                )
            elif target.colocate_with is not None:
                errors.append(
                    f"stage {s.name!r}: co-location target {target.name!r} is "
                    "itself co-located; point at the host stage directly"
                )
            if s.elastic is not None or s.name in self._elastic:
                errors.append(
                    f"stage {s.name!r}: a co-located stage cannot have its own "
                    "elastic policy (the host stage's controller owns the pilot)"
                )

        if self._share <= 0:
            errors.append(f"pipeline share must be > 0, got {self._share}")

        if self._broker_elastic is not None:
            el = self._broker_elastic
            try:
                cls = registry.resolve_policy(el.policy)
            except KeyError as e:
                errors.append(str(e.args[0]))
            else:
                try:
                    cls(**dict(el.params))
                except (TypeError, ValueError) as e:
                    errors.append(f"broker elastic policy {el.policy!r}: {e}")
            if el.min_devices < 1:
                errors.append("broker elastic: min_nodes must be >= 1")

        errors.extend(self._cycle_errors())
        errors.extend(waiting_errors(self._broker, self._stages, self._elastic))

        for src in self._sources:
            if src.topic not in self._topics:
                errors.append(f"source feeds unknown topic {src.topic!r}")
            if src.kind not in registry.known_sources():
                errors.append(f"unknown source kind {src.kind!r}")
            if src.n_producers < 1:
                errors.append(
                    f"source on {src.topic!r} needs >= 1 producer, got "
                    f"{src.n_producers}"
                )

        seen_sink: set[str] = set()
        for sk in self._sinks:
            if sk.name in seen_sink:
                errors.append(f"duplicate sink name {sk.name!r}")
            seen_sink.add(sk.name)
            if sk.topic not in self._topics:
                errors.append(f"sink {sk.name!r} drains unknown topic {sk.topic!r}")
            if sk.kind != "collect" and sk.kind not in registry.known_sinks():
                errors.append(f"sink {sk.name!r}: unknown sink fn {sk.kind!r}")

        by_name = {s.name: s for s in self._stages}
        for stage_name, el in self._elastic.items():
            if stage_name not in by_name:
                errors.append(f"elastic policy attached to unknown stage {stage_name!r}")
            if el.preemptible and stage_name in by_name:
                target = by_name[stage_name]
                # parking cancels the base pilot; only a checkpointing
                # continuous stream can be resumed from a spool afterwards
                if target.engine != "continuous" or not target.checkpoint_every:
                    errors.append(
                        f"elastic on {stage_name!r}: preemptible=True requires "
                        "the continuous engine with checkpoint_every > 0 "
                        "(parking resumes from a crash checkpoint)"
                    )
                if el.min_devices != 0:
                    errors.append(
                        f"elastic on {stage_name!r}: preemptible=True requires "
                        f"min_devices == 0 (got {el.min_devices}) — a nonzero "
                        "floor means the stage is never driven to zero"
                    )
            try:
                cls = registry.resolve_policy(el.policy)
            except KeyError as e:
                errors.append(str(e.args[0]))
                continue
            params = dict(el.params)
            if el.policy in ("latency", "slo") and stage_name in by_name:
                # the inline continuous executor never publishes
                # latency_p50/p99, so a latency/slo policy on it would
                # silently hold forever; the mp executor publishes per-worker
                # and aggregate quantiles, so it may use one
                target = by_name[stage_name]
                if target.engine == "continuous" and target.executor != "mp":
                    errors.append(
                        f"elastic policy {el.policy!r} on {stage_name!r}: the "
                        "continuous engine's inline executor publishes no "
                        "latency quantiles; use executor='mp' or a "
                        "lag-based policy (threshold/pid/binpack)"
                    )
                    continue
                if el.policy == "latency":
                    # the runner injects the stage's batch interval the same way
                    params.setdefault("batch_interval", by_name[stage_name].batch_interval)
            try:
                cls(**params)
            except (TypeError, ValueError) as e:
                errors.append(f"elastic policy {el.policy!r} on {stage_name!r}: {e}")
        return errors

    def _cycle_errors(self) -> list[str]:
        """Topic-level DFS: stage edges topic -> output_topic must be acyclic."""
        edges: dict[str, list[str]] = {}
        for s in self._stages:
            if s.output_topic is not None:
                edges.setdefault(s.topic, []).append(s.output_topic)
        state: dict[str, int] = {}  # 0 visiting, 1 done

        def visit(t: str, path: tuple) -> list[str]:
            if state.get(t) == 1:
                return []
            if state.get(t) == 0:
                cyc = path[path.index(t):] + (t,)
                return [f"topic cycle: {' -> '.join(cyc)}"]
            state[t] = 0
            errs = []
            for nxt in edges.get(t, ()):
                errs += visit(nxt, path + (t,))
            state[t] = 1
            return errs

        errs: list[str] = []
        for t in list(edges):
            errs += visit(t, ())
        return errs


def waiting_errors(broker: BrokerSpec, stages, elastic: dict) -> list[str]:
    """What the port cannot run yet, each naming the ROADMAP item it waits
    for: the continuous engine, the mp executor and the shm transport (A2),
    crash checkpoints with their StageReconciler and checkpoint-then-kill
    preemption (A2, A4). ``elastic`` maps stage names to their ElasticSpec.
    ``Pipeline.validate`` lists these among its other errors; the runner refuses a
    spec that has any, so no such stage runs as something else."""
    errors: list[str] = []
    if broker.transport == "shm":
        errors.append("broker: transport='shm' waits for the port's shared-memory "
                      "transport (ROADMAP A2)")
    for s in stages:
        if s.engine == "continuous":
            errors.append(f"stage {s.name!r}: engine='continuous' waits for the port's "
                          "continuous engine (ROADMAP A2)")
        if s.executor == "mp":
            errors.append(f"stage {s.name!r}: executor='mp' waits for the port's worker "
                          "processes (ROADMAP A2)")
        if s.transport == "shm":
            errors.append(f"stage {s.name!r}: transport='shm' waits for the port's "
                          "shared-memory transport (ROADMAP A2)")
        if s.checkpoint_every > 0:
            errors.append(f"stage {s.name!r}: checkpoint_every > 0 waits for the port's crash "
                          "checkpoints and StageReconciler (ROADMAP A2, A4)")
    for name, el in elastic.items():
        if el.preemptible:
            errors.append(f"elastic on {name!r}: preemptible=True waits for the port's "
                          "checkpoint-then-kill preemption (ROADMAP A2, A4)")
    return errors


def _stage_kwargs(s: StageSpec) -> dict:
    return {
        "name": s.name, "topic": s.topic, "processor": s.processor,
        "engine": s.engine, "nodes": s.nodes, "cores_per_node": s.cores_per_node,
        "group": s.group, "output_topic": s.output_topic, "emits": s.emits,
        "batch_interval": s.batch_interval,
        "max_batch_records": s.max_batch_records,
        "backpressure": s.backpressure, "window": dict(s.window),
        "state_partitions": s.state_partitions,
        "executor": s.executor,
        "checkpoint_every": s.checkpoint_every,
        "transport": s.transport,
        "async_emit": s.async_emit,
        "options": dict(s.options),
        "priority": s.priority, "share": s.share,
        "colocate_with": s.colocate_with,
    }
