"""Model interface shared by every architecture family."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.common import SpecTree, init_params, spec_struct, torch_dtype, tree_leaves


class BaseModel:
    """A model = param specs + functions over a params dict (prefill /
    decode). Subclasses implement ``param_specs``, ``prefill``, ``decode``
    and ``cache_struct``. ``loss`` waits for the training slice."""

    #: the family supports the paged-KV serving path (runtime/steps.py):
    #: prefill honours ``batch["last_pos"]`` and its cache is the standard
    #: (L, B, S, KV, hd) {"k", "v"} dict
    SUPPORTS_PAGED = False

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        self.param_dtype = torch_dtype(cfg.param_dtype)

    # ---- params ----------------------------------------------------------

    def param_specs(self) -> SpecTree:
        raise NotImplementedError

    def param_struct(self) -> Any:
        """The params as ``meta`` tensors: shapes and dtypes, no storage."""
        return spec_struct(self.param_specs())

    def param_count(self) -> int:
        return sum(s.struct().numel() for s in tree_leaves(self.param_specs()))

    def init(self, generator: torch.Generator) -> Any:
        """Random params drawn from ``generator``, on its device."""
        return init_params(self.param_specs(), generator)

    # ---- compute ---------------------------------------------------------

    def prefill(self, params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
        """Process the full prompt; returns (last-token logits, cache)."""
        raise NotImplementedError

    def decode(self, params: Any, cache: Any, batch: dict) -> tuple[torch.Tensor, Any]:
        """One decode step; returns (logits, updated cache)."""
        raise NotImplementedError

    def cache_struct(self, shape: ShapeConfig) -> Any:
        """The decode cache at this shape as ``meta`` tensors."""
        raise NotImplementedError
