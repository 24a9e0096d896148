"""Assemble device batches from broker messages.

Own copy of the JAX package's ``data/batching.py``. ``shard_batch`` places a
host batch on a device (the JAX package's ``device_put`` onto shardings); on a
mesh every rank places the whole batch and keeps its rows and sequence shard
(``runtime/steps.py``).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def batch_messages(msgs: Sequence, *, batch: int, seq_len: int | None = None,
                   pad_value: int = 0) -> np.ndarray:
    """Concatenate npy message payloads to exactly (batch, ...) rows.

    Short windows are padded by repeating the last row (streaming windows
    are size-variable; the step runs at a fixed shape).
    """
    arrays = [np.asarray(m.value) for m in msgs]
    data = np.concatenate(arrays, axis=0)
    if seq_len is not None:
        data = data[:, :seq_len]
    if len(data) >= batch:
        return data[:batch]
    reps = np.repeat(data[-1:], batch - len(data), axis=0)
    return np.concatenate([data, reps], axis=0)


def shard_batch(batch: Any, device: torch.device | str, *, non_blocking: bool = False) -> Any:
    """A host batch tree (nested dicts, lists and tuples of numpy arrays or
    tensors) with every leaf as a tensor on ``device``."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, device, non_blocking=non_blocking) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, device, non_blocking=non_blocking) for v in batch)
    return torch.as_tensor(batch).to(device, non_blocking=non_blocking)
