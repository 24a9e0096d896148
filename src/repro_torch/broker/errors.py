"""Typed broker errors — the vocabulary of the fault-tolerance layer.

Producers and consumers distinguish *transient* unavailability (a leader
election in progress after a node loss — retry with backoff) from a
*deadline* (the caller bounded how long it is willing to block — surface a
typed error instead of hanging). ``BackpressureError`` (repro_torch.broker.log)
stays separate: it means the partition is full, a flow-control signal, not
a fault.
"""
from __future__ import annotations


class BrokerError(RuntimeError):
    """Base class for broker data-plane errors."""


class BrokerUnavailable(BrokerError):
    """The partition has no reachable leader right now (a failover is in
    flight, or placement changed mid-operation). Transient by contract:
    callers retry with jittered backoff; ``Producer.send`` and
    ``Consumer.poll`` do this built-in."""


class BrokerTimeout(BrokerError):
    """A bounded broker operation ran out of deadline — the token bucket
    stayed stalled past ``send_timeout``, or unavailability outlasted the
    retry budget. Raised instead of blocking forever."""
