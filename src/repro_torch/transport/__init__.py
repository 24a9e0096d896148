"""Zero-copy shared-memory data plane.

The broker stays the control plane (offsets, replication metadata,
retention); record *payloads* move through a ``multiprocessing.
shared_memory`` ring of fixed-size slots, written once as columnar batch
frames and read by same-host consumers as ``numpy.frombuffer`` views —
no per-message serde on the hot path. Backpressure is the slot
allocator's stall, surfaced through the same saturation signal the
broker token buckets feed (``BrokerCluster.io_stall_seconds``), so
broker elasticity keeps working unchanged.

The segment layout, the frame format and the slot records are byte for
byte the JAX package's: a frame written by either package decodes in the
other, and either can attach the other's ring by name.
"""
from repro_torch.transport.frames import (
    FrameBatch,
    ShmArrayView,
    decode_frame,
    encode_frame,
    pack_frame,
    unpack_frame,
)
from repro_torch.transport.plane import ShmTransport, decode_slot_record, encode_slot_record
from repro_torch.transport.ring import (
    RingTimeout,
    SharedMemoryRing,
    SlotReclaimedError,
    get_ring,
)

__all__ = [
    "FrameBatch",
    "RingTimeout",
    "SharedMemoryRing",
    "ShmArrayView",
    "ShmTransport",
    "SlotReclaimedError",
    "decode_frame",
    "decode_slot_record",
    "encode_frame",
    "encode_slot_record",
    "get_ring",
    "pack_frame",
    "unpack_frame",
]
