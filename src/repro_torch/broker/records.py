"""Records and serialization for the log-based broker.

Payloads are bytes on the wire (as in Kafka). Serializers provided:
``raw`` (bytes), ``npy`` (numpy arrays — the MASS/MASA data plane),
``msgpack`` (structured metadata). Optional zstd compression (the paper's
§5 calls out serialization formats/message sizes as first-order effects on
producer throughput).
"""
from __future__ import annotations

import io
import time
from dataclasses import dataclass, field
from typing import Any

import msgpack
import numpy as np

try:
    import zstandard as zstd

    _ZSTD = zstd.ZstdCompressor(level=1)
    _ZSTD_D = zstd.ZstdDecompressor()
except Exception:  # pragma: no cover
    _ZSTD = _ZSTD_D = None


@dataclass(slots=True)
class Record:
    """Treated as immutable once appended (logs share record objects
    across replicas); ``slots`` because producers mint one per message
    on the data-plane hot path."""

    value: bytes
    key: bytes | None = None
    timestamp: float = field(default_factory=time.time)
    offset: int = -1  # assigned by the partition log
    headers: dict = field(default_factory=dict)

    def size(self) -> int:
        return len(self.value) + (len(self.key) if self.key else 0)


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------


def encode_array(arr: np.ndarray, *, compress: bool = False) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    data = buf.getvalue()
    if compress and _ZSTD is not None:
        return b"Z" + _ZSTD.compress(data)
    return b"N" + data


def decode_array(data: bytes) -> np.ndarray:
    tag, body = data[:1], data[1:]
    if tag == b"Z":
        body = _ZSTD_D.decompress(body)
    return np.load(io.BytesIO(body), allow_pickle=False)


def encode_msg(obj: Any, *, compress: bool = False) -> bytes:
    data = msgpack.packb(obj, use_bin_type=True)
    if compress and _ZSTD is not None:
        return b"Z" + _ZSTD.compress(data)
    return b"M" + data


def decode_msg(data: bytes) -> Any:
    tag, body = data[:1], data[1:]
    if tag == b"Z":
        body = _ZSTD_D.decompress(body)
    return msgpack.unpackb(body, raw=False)


_NPY_MAGIC = b"\x93NUMPY"


def decode_compressed(data: bytes) -> Any:
    """Decode a ``Z``-tagged payload; both serializers compress to the same
    tag, so the inner format is sniffed via the npy magic prefix."""
    if _ZSTD_D is None:
        raise RuntimeError("zstandard not available to decode compressed payload")
    body = _ZSTD_D.decompress(data[1:])
    if body[: len(_NPY_MAGIC)] == _NPY_MAGIC:
        return np.load(io.BytesIO(body), allow_pickle=False)
    return msgpack.unpackb(body, raw=False)
