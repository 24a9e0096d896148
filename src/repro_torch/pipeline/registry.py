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
    import inspect

    if not isinstance(factory, type):
        try:
            sig = inspect.signature(factory)
        except (TypeError, ValueError):
            sig = None
        if sig is not None:
            # count positional params regardless of defaults: a processor
            # like (state, msgs=()) must not be mistaken for a factory and
            # called with zero args
            positional = [
                p for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            ]
            if len(positional) >= 2:
                if options:
                    raise TypeError(
                        f"processor {name!r} is a plain function; stage "
                        f"options {sorted(options)} have nowhere to go"
                    )
                return factory
    injected = {k: v for k, v in (("metrics", metrics), ("device", device))
                if v is not None and k not in options}
    if injected:
        target = factory.__init__ if isinstance(factory, type) else factory
        try:
            params = inspect.signature(target).parameters
        except (TypeError, ValueError):
            params = {}
        options = dict(options, **{k: v for k, v in injected.items() if k in params})
    return factory(**options)
