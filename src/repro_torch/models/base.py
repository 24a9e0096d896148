"""Model interface shared by every architecture family."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.common import (
    SpecTree,
    init_params,
    spec_axes,
    spec_struct,
    torch_dtype,
    tree_leaves,
    vocab_logits,
)


class BaseModel:
    """A model = param specs + functions over a params dict (loss /
    prefill / decode). Subclasses implement ``param_specs``, ``loss``,
    ``prefill``, ``decode`` and ``cache_struct``."""

    #: the family supports the paged-KV serving path (runtime/steps.py):
    #: prefill honours ``batch["last_pos"]`` and its cache is the standard
    #: (L, B, S, KV, hd) {"k", "v"} dict
    SUPPORTS_PAGED = False

    #: names of the leaves sharded on "model" that a serving decode step
    #: reads whole (small per-channel vectors), gathered where their layer
    #: runs; every other "model" leaf stays the rank's tile there, and the
    #: products take it tensor-parallel (``runtime/steps.py``)
    GATHERED_IN_DECODE: tuple = ()

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

    def param_axes(self) -> Any:
        """Each param's logical axis names (``runtime/sharding.py`` maps
        them onto a mesh)."""
        return spec_axes(self.param_specs())

    def param_count(self) -> int:
        return sum(s.struct().numel() for s in tree_leaves(self.param_specs()))

    def init(self, generator: torch.Generator) -> Any:
        """Random params drawn from ``generator``, on its device."""
        return init_params(self.param_specs(), generator)

    def compute_params(self, params: Any) -> Any:
        """The params as served. Each product casts its weight to the
        compute dtype (``w.to(cd)``, as the JAX package's ``astype``), which
        costs nothing where the weights are stored in it (bf16 at full width
        for the VLM, enc-dec, RWKV6 and Zamba2 configs), so the stored
        leaves are served as they are. ``DecoderLM`` casts its f32 layer
        weights once instead."""
        return params

    def _logits(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        """(..., V_pad) f32 logits: an f32 product with the ``lm_head`` (its
        vocab tile, the logits gathered, under a serving mesh step)."""
        return vocab_logits(x, params["lm_head"], self.cfg.padded_vocab)

    # ---- compute ---------------------------------------------------------

    def loss(self, params: Any, batch: dict) -> tuple[torch.Tensor, dict]:
        """Training loss of a batch; returns (scalar loss, metrics)."""
        raise NotImplementedError

    def prefill(self, params: Any, batch: dict, *,
                cache_len: int | None = None) -> tuple[torch.Tensor, Any]:
        """Process the full prompt; returns (last-token logits, cache). Of
        the cache, only self-attention K/V grow with the sequence: they are
        allocated ``cache_len`` long (zeros past the prompt) for decoding in
        place; recurrent states and cross-attention memory keep their size."""
        raise NotImplementedError

    def decode(self, params: Any, cache: Any, batch: dict) -> tuple[torch.Tensor, Any]:
        """One decode step; returns (logits, updated cache)."""
        raise NotImplementedError

    def cache_struct(self, shape: ShapeConfig) -> Any:
        """The decode cache at this shape as ``meta`` tensors."""
        raise NotImplementedError

    # ---- inputs and their axes (the reference's dry-run structs) -----------

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Every model input of this shape as ``meta`` tensors: a token LM's
        (families with other inputs override it)."""
        B, S = shape.global_batch, shape.seq_len
        i32 = dict(dtype=torch.int32, device="meta")
        if shape.kind == "decode":
            return {"tokens": torch.empty((B, 1), **i32), "positions": torch.empty((B,), **i32)}
        return {"tokens": torch.empty((B, S), **i32)}

    def input_axes(self, shape: ShapeConfig) -> dict:
        """Logical axes of each input (parallel to :meth:`input_specs`)."""
        if shape.kind == "decode":
            return {"tokens": ("batch", None), "positions": ("batch",)}
        return {"tokens": ("batch", "seq")}

    def cache_axes(self, shape: ShapeConfig) -> Any:
        """Logical axes of the decode cache: the (L, B, S, KV, hd) K/V."""
        ax = ("layers", "batch", "cache_seq", None, None)
        return {"k": ax, "v": ax}

    # ---- a mesh rank's share of a global batch -------------------------------

    def local_batch(self, batch: dict, rows: tuple[int, int],
                    shard: tuple[int, int] = (0, 1)) -> dict:
        """This rank's inputs of a global ``batch``: block ``rows = (i, n)``
        of the rows, and, with ``shard = (j, m)``, the j-th of m equal
        shards of each input's sequence (dim 1 of every input of two or more
        dims; one-dim inputs, a decode step's positions, keep theirs). A
        family whose sequence is not each input's own dim 1 overrides it
        (the VLM's [patches; text]). Raises ``ValueError``, naming the
        input, where one does not split (meta tensors check a batch's
        shapes)."""
        out = {}
        for k, x in batch.items():
            x = _row_block(k, x, rows)
            if shard[1] > 1 and x.ndim >= 2:
                x = _seq_block(k, x, shard, 0, x.shape[1])
            out[k] = x.contiguous()
        return out


def _row_block(name: str, x: torch.Tensor, rows: tuple[int, int]) -> torch.Tensor:
    i, n = rows
    if x.shape[0] % n:
        raise ValueError(f"input {name!r} {tuple(x.shape)}: {x.shape[0]} rows do not split "
                         f"over {n} ranks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _seq_block(name: str, x: torch.Tensor, shard: tuple[int, int], lo: int,
               length: int) -> torch.Tensor:
    """Shard ``shard = (j, m)`` of a sequence ``length`` long whose
    positions [lo, lo + x.shape[1]) ``x`` holds: its part of that shard
    (possibly empty)."""
    j, m = shard
    if length % m:
        raise ValueError(f"input {name!r} {tuple(x.shape)}: a sequence of {length} positions "
                         f"does not split over {m} ranks")
    s = length // m
    a, b = max(j * s, lo), min((j + 1) * s, lo + x.shape[1])
    return x[:, a - lo:max(a, b) - lo]
