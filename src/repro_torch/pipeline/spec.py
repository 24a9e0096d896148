"""Declarative pipeline topology — the paper's composition pitch made data.

A :class:`PipelineSpec` is a frozen, JSON-serializable description of one
streaming pipeline: broker sizing, topics, sources, processing stages
(micro-batch or continuous) chained topic -> topic, sinks, and per-stage
elasticity policy. It describes *what* to run; ``Pipeline``
(:mod:`repro_torch.pipeline.builder`) checks it, and the runner
(:mod:`repro_torch.pipeline.runner`) turns it into pilots, streams and
controllers through the existing imperative API.

Callables (custom processors, sources, sinks) are referenced by *name*
through :mod:`repro_torch.pipeline.registry`, so a spec round-trips losslessly:
``PipelineSpec.from_dict(spec.to_dict()) == spec``.

The dataclasses are the JAX package's, field for field, so a spec's JSON
crosses between the two packages unchanged.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, fields, replace
from typing import Any, Mapping


def _freeze_options(opts: Mapping[str, Any] | None) -> dict:
    """Shallow-copy option mappings so frozen specs don't alias caller dicts."""
    return dict(opts or {})


@dataclass(frozen=True)
class BrokerSpec:
    """The broker pilot: node count, topic layout, and (optionally) its own
    elasticity. With ``elastic`` set, a node-unit controller watches the
    producer token-bucket saturation signal (``broker.stall_frac``) and
    drives ``BrokerCluster.add_node/remove_node`` through the arbiter —
    application code never calls ``add_node`` itself."""

    nodes: int = 1
    framework: str = "kafka"
    #: topic name -> partition count
    topics: dict = field(default_factory=dict)
    #: per-node byte-rate budget (None = unlimited), paper's 1-broker bottleneck
    io_rate_per_node: float | None = None
    #: replicas per topic partition (leader + followers on distinct nodes,
    #: acks=all): >= 2 makes acked records survive a broker-node loss with
    #: automatic leader failover
    replication_factor: int = 1
    #: data plane: "log" (payloads in the partition log) or "shm" (a
    #: shared-memory ring is mounted per topic and rf==1 payloads travel as
    #: zero-copy slot handles). With rf > 1 the shm plane copies out per
    #: record.
    transport: str = "log"
    #: ShmTransport kwargs (slot_bytes, n_slots) when transport == "shm"
    transport_options: dict = field(default_factory=dict)
    #: node-unit ElasticSpec (min_devices/max_devices count broker *nodes*)
    elastic: "ElasticSpec | None" = None

    def __post_init__(self):
        object.__setattr__(self, "transport_options",
                           _freeze_options(self.transport_options))


@dataclass(frozen=True)
class SourceSpec:
    """One MASS-style producer group feeding a topic.

    ``kind`` names a factory in the source registry — the built-in
    ``repro_torch.miniapps.SOURCES`` kinds ("cluster", "static", "lightsource",
    "tokens") plus anything registered via ``repro_torch.pipeline.register_source``.
    """

    topic: str
    kind: str = "cluster"
    rate_msgs_per_s: float | None = None
    total_messages: int | None = None
    n_producers: int = 1
    seed: int = 0
    #: factory kwargs beyond SourceConfig (e.g. n_clusters, dim)
    options: dict = field(default_factory=dict)
    #: optional [(duration_s, rate), ...] driven by a RateStepScenario
    rate_schedule: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "options", _freeze_options(self.options))
        object.__setattr__(
            self, "rate_schedule", tuple(tuple(s) for s in self.rate_schedule)
        )


@dataclass(frozen=True)
class ElasticSpec:
    """Per-stage elasticity: which policy watches the bus, and the
    controller's clamps. ``policy`` is one of POLICIES in
    :mod:`repro_torch.pipeline.registry` ("threshold", "pid", "binpack",
    "latency", "slo"); ``params`` are the policy's constructor kwargs."""

    policy: str = "threshold"
    params: dict = field(default_factory=dict)
    interval: float = 0.5
    min_devices: int = 1
    max_devices: int | None = None
    devices_per_step: int = 1
    cooldown: float = 1.0
    #: hold rescales while the last keyed-state migration is still
    #: amortizing (see ``ElasticConfig.migration_cost_frac``); None = off
    migration_cost_frac: float | None = None
    #: opt the stage into checkpoint-then-kill preemption: when the arbiter
    #: drives it to zero devices, the runner checkpoints the stream, fences
    #: it and cancels the whole pilot (base included); the next grant
    #: resubmits the pilot and resumes from the pre-kill spool. Requires
    #: the continuous engine, ``checkpoint_every > 0`` and
    #: ``min_devices == 0`` (checked by ``Pipeline.validate``)
    preemptible: bool = False

    def __post_init__(self):
        object.__setattr__(self, "params", _freeze_options(self.params))


@dataclass(frozen=True)
class StageSpec:
    """One processing stage: engine pilot + stream consuming ``topic``.

    ``processor`` names a factory in the processor registry — the built-in
    ``repro_torch.miniapps.PROCESSORS`` ("kmeans", "gridrec", "mlem",
    "lm_train", "lm_serve") or anything registered via
    ``repro_torch.pipeline.register_processor`` (including plain
    ``(state, msgs) -> state`` functions). When ``emits`` is true the
    processor returns ``(state, outputs)`` and outputs are produced to
    ``output_topic``.
    """

    name: str
    topic: str
    processor: str
    engine: str = "microbatch"  # "microbatch" | "continuous"
    nodes: int = 1
    cores_per_node: int = 1
    group: str | None = None  # consumer group (default: stage name)
    output_topic: str | None = None
    emits: bool = False
    # micro-batch knobs
    batch_interval: float = 0.5
    max_batch_records: int = 4096
    backpressure: bool = True
    # continuous knobs: {"window": "tumbling"|"sliding"|"session", "size": s,
    # "slide": s, "gap": s, "allowed_lateness": s}
    window: dict = field(default_factory=dict)
    #: size of the keyed-state partition ring (continuous engine only) —
    #: rescales migrate whole partitions, so more partitions = finer-grained
    #: (but chattier) state movement
    state_partitions: int = 64
    #: continuous engine execution mode: "inline" (in-process, the
    #: default) or "mp" (one supervised worker process per owner slot,
    #: failure isolation + restart with state recovery; spawned where the
    #: slot is on a CUDA card, so window functions must pickle there)
    executor: str = "inline"
    #: records between crash checkpoints (continuous engine): > 0 spools
    #: full-stream checkpoints so a crashed stage pilot is reprovisioned by
    #: the StageReconciler and resumes mid-stream; 0 = off
    checkpoint_every: int = 0
    #: stage-side transport opt-in: "shm" puts a micro-batch stage's
    #: consumer in zero-copy mode (frame views, sound because the batch is
    #: fully processed before commit); None inherits safe copy-out.
    #: Requires broker.transport == "shm".
    transport: str | None = None
    #: continuous engine only: depth of the emit double-buffer — fired
    #: windows are produced downstream asynchronously so host-side routing
    #: overlaps device compute; 0 = synchronous emits
    async_emit: int = 0
    #: processor factory kwargs
    options: dict = field(default_factory=dict)
    elastic: ElasticSpec | None = None
    # arbitration attributes (repro_torch.scheduler): strict priority tier,
    # proportional weight within a tier, and a placement hint
    priority: int = 0
    share: float = 1.0
    #: run on the same pilot as the named stage instead of provisioning a
    #: fresh one (spec-level co-location; engines must match)
    colocate_with: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "options", _freeze_options(self.options))
        object.__setattr__(self, "window", _freeze_options(self.window))

    @property
    def consumer_group(self) -> str:
        return self.group or self.name


@dataclass(frozen=True)
class SinkSpec:
    """A terminal consumer draining ``topic``. ``kind`` is "collect"
    (records kept on ``PipelineRun.sink(name).items``) or a registered
    sink callable applied per message."""

    name: str
    topic: str
    kind: str = "collect"
    options: dict = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "options", _freeze_options(self.options))


@dataclass(frozen=True)
class PipelineSpec:
    """The whole topology. Construct via the fluent ``Pipeline`` API
    (``Pipeline.named(...)``) which validates before instantiating."""

    name: str
    broker: BrokerSpec = field(default_factory=BrokerSpec)
    sources: tuple = ()
    stages: tuple = ()
    sinks: tuple = ()
    #: pipeline-level fair-share weight: several runs on one service split
    #: contended devices proportionally to their shares (stage requests
    #: carry ``pipeline.share * stage.share``)
    share: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "sources", tuple(self.sources))
        object.__setattr__(self, "stages", tuple(self.stages))
        object.__setattr__(self, "sinks", tuple(self.sinks))

    # -- accessors ------------------------------------------------------------

    def stage(self, name: str) -> StageSpec:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"no stage named {name!r}")

    @property
    def topics(self) -> dict:
        return dict(self.broker.topics)

    # -- serde ---------------------------------------------------------------

    def to_dict(self) -> dict:
        return _to_dict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PipelineSpec":
        d = dict(d)
        b = dict(d.pop("broker", {}))
        bel = b.pop("elastic", None)
        broker = BrokerSpec(**b, elastic=ElasticSpec(**bel) if bel is not None else None)
        sources = tuple(SourceSpec(**s) for s in d.pop("sources", ()))
        stages = []
        for s in d.pop("stages", ()):
            s = dict(s)
            el = s.pop("elastic", None)
            stages.append(
                StageSpec(**s, elastic=ElasticSpec(**el) if el is not None else None)
            )
        sinks = tuple(SinkSpec(**s) for s in d.pop("sinks", ()))
        return cls(broker=broker, sources=sources, stages=tuple(stages),
                   sinks=sinks, **d)

    @classmethod
    def from_json(cls, text: str) -> "PipelineSpec":
        return cls.from_dict(json.loads(text))

    # -- runner entry point ---------------------------------------------------

    def run(self, **kw):
        """Provision and start the pipeline; see
        :class:`repro_torch.pipeline.runner.PipelineRun`."""
        from repro_torch.pipeline.runner import PipelineRun

        return PipelineRun(self, **kw)


def _to_dict(obj: Any) -> Any:
    """Dataclass -> plain JSON-able structures (tuples become lists)."""
    if hasattr(obj, "__dataclass_fields__"):
        out = {}
        for f in fields(obj):
            v = getattr(obj, f.name)
            if v is None and f.name == "elastic":
                out[f.name] = None
            else:
                out[f.name] = _to_dict(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_dict(v) for k, v in obj.items()}
    return obj


def with_elastic(stage: StageSpec, elastic: ElasticSpec) -> StageSpec:
    """Frozen-friendly update used by ``Pipeline.build``."""
    return replace(stage, elastic=elastic)
