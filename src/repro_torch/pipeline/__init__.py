"""Declarative pipeline API (paper §4: one abstraction over broker, engine
and resource management).

Three layers, lowest first:

* :mod:`repro_torch.pipeline.spec` — frozen, JSON-round-trippable topology
  (``PipelineSpec`` and friends);
* :mod:`repro_torch.pipeline.builder` — fluent ``Pipeline.named(...)`` builder
  with build-time validation;
* :mod:`repro_torch.pipeline.runner` — ``PipelineRun``, the context manager that
  provisions pilots/topics/streams/controllers from a spec and tears them
  down in reverse order.

The imperative API underneath is unchanged.
"""
from repro_torch.pipeline.builder import Pipeline, PipelineValidationError
from repro_torch.pipeline.registry import (
    POLICIES,
    register_processor,
    register_sink,
    register_source,
)
from repro_torch.pipeline.runner import PipelineRun, SinkRunner
from repro_torch.pipeline.spec import (
    BrokerSpec,
    ElasticSpec,
    PipelineSpec,
    SinkSpec,
    SourceSpec,
    StageSpec,
)

__all__ = [
    "BrokerSpec",
    "ElasticSpec",
    "POLICIES",
    "Pipeline",
    "PipelineRun",
    "PipelineSpec",
    "PipelineValidationError",
    "SinkRunner",
    "SinkSpec",
    "SourceSpec",
    "StageSpec",
    "register_processor",
    "register_sink",
    "register_source",
]
