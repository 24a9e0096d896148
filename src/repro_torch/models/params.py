"""Model weights and train states handed over from and to the JAX package.

Tests start both packages from the same weights, since the two draw
different random numbers from one seed. The JAX params arrive as numpy
(``jax.tree.map(np.asarray, params)`` on the caller's side), so this module
needs neither package's arrays to import the other's; :func:`tree_to_numpy`
hands the port's tensors back the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.service import resolve_device


def _tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16; JAX hands ml_dtypes' bf16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(tree: dict, device: torch.device | str) -> dict:
    """A JAX ``model.init`` pytree of numpy arrays (nested dicts) -> the
    same nesting of tensors on ``device``: the stacked (L, ...) layer axis
    and each leaf's storage dtype (f32 at full width) are kept as they are."""
    dev = resolve_device(device)

    def convert(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            raise TypeError("params_from_jax takes nested dicts of arrays; "
                            f"got a {type(node).__name__}")
        return _tensor(node, dev)

    return convert(tree)


def train_state_from_jax(state: dict, device: torch.device | str) -> dict:
    """A JAX train state ``{"params", "opt"}`` of numpy arrays (the params
    tree, and the optimizer state: an int32 ``step`` scalar and the moment
    trees) -> the same nesting of tensors on ``device``, every dtype kept."""
    if set(state) != {"params", "opt"}:
        raise ValueError(f"a train state has the keys 'params' and 'opt', got {sorted(state)}")
    return params_from_jax(state, device)


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors -> the same nesting of numpy arrays on the
    host (bf16 as ``ml_dtypes.bfloat16``, the type JAX hands out), for
    feeding the port's state to the JAX package."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # noqa: PLC0415 (only where a bf16 leaf crosses)

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()
