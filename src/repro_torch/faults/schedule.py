"""Fault-schedule DSL — declarative, deterministic chaos plans.

A schedule is an ordered list of :class:`FaultSpec`s, each naming a fault
kind, a *trigger* (a record count or an event-time watermark the stream
must reach), and kind-specific params. Triggers are expressed in the
stream's own progress coordinates, not wall-clock time, which is what
makes a chaos run reproducible: the same schedule + seed injects the same
faults at the same logical points on every machine and every run.

Text form (one fault per ``;`` or newline)::

    kill_broker_node @records=500 node=leader blackout=0.2
    kill_pilot       @records=900
    slow_consumer    @watermark=1003.5 delay=0.01 until_records=1200

Grammar: ``<kind> @records=<int> | @watermark=<float> [key=value ...]``.
Values parse as int, then float, then bare string. The same schedules are
built programmatically via the fluent methods (``FaultSchedule().
kill_broker_node(at_records=500, node="leader")``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

#: the fault vocabulary — keys of FaultInjector._ACTIONS
KINDS = (
    "kill_broker_node",
    "kill_pilot",
    "slow_consumer",
    "drop_heartbeats",
    "delay_io",
)


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: what, when (logical trigger), and how."""

    kind: str
    at_records: int | None = None
    at_watermark: float | None = None
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if (self.at_records is None) == (self.at_watermark is None):
            raise ValueError(
                f"{self.kind}: exactly one of at_records/at_watermark "
                "must be set (the injection trigger)")

    def due(self, records: int, watermark: float) -> bool:
        if self.at_records is not None:
            return records >= self.at_records
        return watermark >= self.at_watermark

    @property
    def trigger(self) -> str:
        if self.at_records is not None:
            return f"records>={self.at_records}"
        return f"watermark>={self.at_watermark}"


def _parse_value(text: str) -> Any:
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


class FaultSchedule:
    """An ordered fault plan; iterable, parseable, composable."""

    def __init__(self, specs: list[FaultSpec] | None = None):
        self.specs: list[FaultSpec] = list(specs or [])

    # -- construction -----------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "FaultSchedule":
        sched = cls()
        for line in text.replace(";", "\n").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            kind, at_records, at_watermark, params = tokens[0], None, None, {}
            for tok in tokens[1:]:
                if tok.startswith("@records="):
                    at_records = int(tok.split("=", 1)[1])
                elif tok.startswith("@watermark="):
                    at_watermark = float(tok.split("=", 1)[1])
                elif "=" in tok:
                    k, v = tok.split("=", 1)
                    params[k] = _parse_value(v)
                else:
                    raise ValueError(f"cannot parse token {tok!r} in {line!r}")
            sched.add(FaultSpec(kind, at_records, at_watermark, params))
        return sched

    def add(self, spec: FaultSpec) -> "FaultSchedule":
        self.specs.append(spec)
        return self

    def _fluent(self, kind: str, at_records: int | None,
                at_watermark: float | None, params: dict) -> "FaultSchedule":
        clean = {k: v for k, v in params.items() if v is not None}
        return self.add(FaultSpec(kind, at_records, at_watermark, clean))

    def kill_broker_node(self, *, at_records: int | None = None,
                         at_watermark: float | None = None,
                         node: int | str | None = None,
                         blackout: float | None = None) -> "FaultSchedule":
        return self._fluent("kill_broker_node", at_records, at_watermark,
                            {"node": node, "blackout": blackout})

    def kill_pilot(self, *, at_records: int | None = None,
                   at_watermark: float | None = None) -> "FaultSchedule":
        return self._fluent("kill_pilot", at_records, at_watermark, {})

    def slow_consumer(self, *, at_records: int | None = None,
                      at_watermark: float | None = None,
                      delay: float | None = None,
                      until_records: int | None = None) -> "FaultSchedule":
        return self._fluent("slow_consumer", at_records, at_watermark,
                            {"delay": delay, "until_records": until_records})

    def drop_heartbeats(self, *, at_records: int | None = None,
                        at_watermark: float | None = None) -> "FaultSchedule":
        return self._fluent("drop_heartbeats", at_records, at_watermark, {})

    def delay_io(self, *, at_records: int | None = None,
                 at_watermark: float | None = None,
                 delay: float | None = None,
                 until_records: int | None = None) -> "FaultSchedule":
        return self._fluent("delay_io", at_records, at_watermark,
                            {"delay": delay, "until_records": until_records})

    # -- introspection ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def __repr__(self) -> str:
        body = "; ".join(f"{s.kind} @{s.trigger}" for s in self.specs)
        return f"FaultSchedule({body})"
