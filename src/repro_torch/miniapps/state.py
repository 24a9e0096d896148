"""Processor state handed over from the JAX package.

Tests and the chip smoke run start both packages from the same learned
state. The JAX package's state arrives as numpy (``np.asarray`` of its
jax arrays), so this module needs neither package's arrays to import the
other's. On this slice's path the only learned state is the
``StreamingKMeans`` centroids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.service import resolve_device

#: state key -> dtype the port keeps it in
_KNOWN = {"centroids": np.float32}


def state_from_jax(arrays: dict[str, np.ndarray], device: torch.device | str) -> dict[str, torch.Tensor]:
    """``{"centroids": (K, D) array}`` -> the same keys as tensors on
    ``device``; raises on a key this slice does not know."""
    unknown = sorted(set(arrays) - set(_KNOWN))
    if unknown:
        raise KeyError(f"no port state for {unknown}; known: {sorted(_KNOWN)}")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=_KNOWN[k])).to(dev)
            for k, v in arrays.items()}
