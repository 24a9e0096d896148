"""Name -> factory registries backing the declarative specs.

Specs reference behavior (sources, processors, sinks, scaling policies) by
string so they stay serializable; this module resolves those strings. The
built-in MASS sources, MASA processors and elastic policies are pre-seeded;
``register_source`` / ``register_processor`` / ``register_sink`` add custom
entries, including plain functions.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.elastic.forecast import ForecastPolicy
from repro_torch.elastic.policy import (
    BinPackingPolicy,
    BrokerSaturationPolicy,
    LatencyPolicy,
    PIDScalingPolicy,
    SLOPolicy,
    ThresholdHysteresisPolicy,
)

#: policy name (ElasticSpec.policy) -> ScalingPolicy class
POLICIES: dict[str, type] = {
    "threshold": ThresholdHysteresisPolicy,
    "pid": PIDScalingPolicy,
    "binpack": BinPackingPolicy,
    "latency": LatencyPolicy,
    "slo": SLOPolicy,
    "broker_saturation": BrokerSaturationPolicy,
    "forecast": ForecastPolicy,
}

_SOURCES: dict[str, Callable] = {}
_PROCESSORS: dict[str, Callable] = {}
_SINKS: dict[str, Callable] = {}


def register_source(name: str, factory: Callable | None = None):
    """Register a StreamSource factory ``(cluster, config, **options)``.
    Usable as a decorator: ``@register_source("mykind")``."""
    def deco(f):
        _SOURCES[name] = f
        return f
    return deco(factory) if factory is not None else deco


def register_processor(name: str, factory: Callable | None = None):
    """Register a stage processor. The factory may be

    * an app class/factory: ``factory(**options)`` returning an object with
      ``process(state, msgs)`` (MASA style), or
    * a plain ``(state, msgs) -> state`` function (``options`` must be
      empty) — what hand-written stages use.
    """
    def deco(f):
        _PROCESSORS[name] = f
        return f
    return deco(factory) if factory is not None else deco


def register_sink(name: str, fn: Callable | None = None):
    """Register a per-message sink callable ``fn(message)``."""
    def deco(f):
        _SINKS[name] = f
        return f
    return deco(fn) if fn is not None else deco


def _builtin_sources() -> dict:
    from repro_torch.miniapps import SOURCES

    return dict(SOURCES)


def _builtin_processors() -> dict:
    from repro_torch.miniapps import PROCESSORS

    return dict(PROCESSORS)


def resolve_source(kind: str) -> Callable:
    table = {**_builtin_sources(), **_SOURCES}
    if kind not in table:
        raise KeyError(
            f"unknown source kind {kind!r}; known: {sorted(table)} "
            "(register custom kinds via repro_torch.pipeline.register_source)"
        )
    return table[kind]


def resolve_processor(name: str) -> Callable:
    table = {**_builtin_processors(), **_PROCESSORS}
    if name not in table:
        raise KeyError(
            f"unknown processor {name!r}; known: {sorted(table)} "
            "(register custom processors via repro_torch.pipeline.register_processor)"
        )
    return table[name]


def resolve_sink(name: str) -> Callable:
    if name not in _SINKS:
        raise KeyError(
            f"unknown sink {name!r}; known: {sorted(_SINKS)} "
            "(register custom sinks via repro_torch.pipeline.register_sink)"
        )
    return _SINKS[name]


def resolve_policy(name: str) -> type:
    if name not in POLICIES:
        raise KeyError(f"unknown elastic policy {name!r}; known: {sorted(POLICIES)}")
    return POLICIES[name]


def known_processors() -> set[str]:
    return set(_builtin_processors()) | set(_PROCESSORS)


def known_sources() -> set[str]:
    return set(_builtin_sources()) | set(_SOURCES)


def known_sinks() -> set[str]:
    return set(_SINKS)


#: the JAX package's processor switches that the port's processors do not
#: take, and why: a spec written for the JAX package that sets one fails
#: ``Pipeline.validate()`` by name instead of at its stage's start
JAX_ONLY_OPTIONS = {
    "use_kernel": "CUDA tensors run the kernels, CPU tensors their plain versions",
    "interpret": "CUDA tensors run the kernels, CPU tensors their plain versions",
    "bucketed": "nothing is compiled per shape, so no batch is padded to a bucket",
    "buckets": "nothing is compiled per shape, so no batch is padded to a bucket",
    "batched": "ML-EM takes the whole batch in one call",
    "batch_buckets": "nothing is compiled per shape, so no batch is padded to a bucket",
    "mesh": "only LMTrainApp takes a mesh (a launch.mesh.MeshSpec: a rank group of its own); "
            "the other apps run on their stage's device",
}


def _parameters(factory: Callable) -> dict | None:
    """The parameters of a factory (a class's ``__init__``'s), or None
    where its signature cannot be read."""
    import inspect

    target = factory.__init__ if isinstance(factory, type) else factory
    try:
        return dict(inspect.signature(target).parameters)
    except (TypeError, ValueError):
        return None


def _is_plain_function(factory: Callable) -> bool:
    """A ``(state, msgs)`` or ``(key, window, msgs)`` processor: two or more
    positional parameters, defaults or not (a processor like
    ``(state, msgs=())`` must not be mistaken for a factory and called with
    zero args)."""
    if isinstance(factory, type):
        return False
    params = _parameters(factory)
    if params is None:
        return False
    positional = [p for p in params.values() if p.kind in (p.POSITIONAL_ONLY,
                                                          p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2


def option_errors(name: str, options: dict) -> list[str]:
    """What processor ``name`` cannot take in a stage's ``options``: any
    option of a plain function; a JAX-only switch (``JAX_ONLY_OPTIONS``)
    that the factory does not name, with why; and an option its signature
    does not take (unless it takes ``**kwargs``)."""
    factory = resolve_processor(name)
    if _is_plain_function(factory):
        return [f"processor {name!r} is a plain function; options {sorted(options)} have "
                "nowhere to go"] if options else []
    params = _parameters(factory)
    if params is None:
        return []
    named = {n for n, p in params.items() if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    any_kw = any(p.kind == p.VAR_KEYWORD for p in params.values())
    errors = []
    for key in sorted(options):
        if key in named:
            continue
        if key in JAX_ONLY_OPTIONS:
            errors.append(f"no `{key}` in the port: {JAX_ONLY_OPTIONS[key]} (processor {name!r})")
        elif not any_kw:
            errors.append(f"processor {name!r} takes no option {key!r}; it takes "
                          f"{sorted(named - {'self'})}")
    return errors


def make_processor(name: str, options: dict, *, metrics: Any = None,
                   device: Any = None) -> Any:
    """Instantiate a processor: app factories get ``options`` kwargs; plain
    process/window functions — ``(state, msgs)`` or ``(key, window, msgs)``
    — are returned as-is.

    ``metrics`` (the runner's MetricsBus) is injected into factories that
    accept a ``metrics`` kwarg — this is how app-level gauges (serving page
    pool, app latency quantiles) reach the elastic loop without every spec
    having to plumb the bus through ``options``. ``device`` (the first
    device of the stage pilot's lease) is injected the same way into
    factories that take a ``device`` kwarg, which places the port's apps.
    An explicit ``options["metrics"]`` or ``options["device"]`` wins."""
    factory = resolve_processor(name)
    if _is_plain_function(factory):
        if options:
            raise TypeError(
                f"processor {name!r} is a plain function; stage "
                f"options {sorted(options)} have nowhere to go"
            )
        return factory
    injected = {k: v for k, v in (("metrics", metrics), ("device", device))
                if v is not None and k not in options}
    if injected:
        params = _parameters(factory) or {}
        options = dict(options, **{k: v for k, v in injected.items() if k in params})
    return factory(**options)
