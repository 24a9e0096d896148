"""Attention: GQA naive / blockwise (flash) / decode, plus the KV-cache write.

All functions take Q: (B, Sq, H, hd); K, V: (B, Skv, KV, hd) with
H % KV == 0, as the JAX package's ``models/attention.py``. The tensor's
device picks the implementation, with no switch: :func:`blockwise_attention`
and :func:`decode_attention` are the kernel wrappers of
``kernels/attention/ops.py``, which run the hand-written flash and decode
kernels on CUDA tensors and their plain versions (``kernels/attention/ref.py``)
on CPU tensors. The JAX package's ``decode_kernel_scope`` therefore has no
counterpart. Full-sequence attention on the card (serving prefill, and
every training forward and its remat recompute) goes through the flash
kernel, which computes the same function as the JAX package's pure-JAX
``blockwise_attention``; in training it is differentiable through
``FlashAttentionFn``, whose backward on the card is the hand-written
backward kernels (the JAX package differentiates its blockwise form, or its
explicit flash ``custom_vjp`` on a mesh: the same gradients).

:func:`attention` is the reference's ``attention(impl=...)`` dispatch:
under a mesh step whose "model" axis has more than one rank, the local
sequence shard goes through ``runtime/sharded_attention.py`` (K and V
all-gathered, one flash call at the shard's query offset; or the ring for
prefill), otherwise through the flash wrapper (``naive`` through
:func:`naive_attention`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention.ops import decode_attention  # noqa: F401  (re-export)
from repro_torch.kernels.attention.ops import flash_attention as blockwise_attention  # noqa: F401

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd) grouped by kv head."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Reference attention; materializes the full scores."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = _group(q, KV)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32), k.to(torch.float32)) * scale
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, impl: str = "blockwise",
              causal: bool = True, block_q: int = 512, block_kv: int = 1024,
              with_kv: bool = False):
    """Full-sequence attention by ``impl`` ("blockwise", "naive", "flash",
    "ring"); sequence-parallel under a mesh step with a "model" axis. The
    flash kernel takes its own tiles: the block sizes steer only the
    sharded path's choice, as in the reference. ``with_kv`` returns (out,
    k, v) with the whole sequence's K and V of the local rows: on a
    sequence shard the ones the sharded path gathered (a prefill's cache
    tile is cut from them), else ``k`` and ``v``."""
    from repro_torch.runtime.sharding import model_parallel

    rules = model_parallel()
    if rules is not None:
        from repro_torch.runtime.sharded_attention import sharded_attention

        shard_impl = {"ring": "ring", "flash": "flash"}.get(impl, "allgather")
        return sharded_attention(q, k, v, rules, causal=causal, block_kv=block_kv,
                                 impl=shard_impl, with_kv=with_kv)
    if impl == "naive":
        out = naive_attention(q, k, v, causal=causal)
    elif impl in ("blockwise", "ring", "flash"):
        out = blockwise_attention(q, k, v, causal=causal)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return (out, k, v) if with_kv else out


def update_cache(cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor,
                 start: int = 0) -> torch.Tensor:
    """Write ``new`` (B,1,KV,hd) into ``cache`` (B,S,KV,hd) at per-row
    ``positions``, **in place** (the JAX version returns an updated copy);
    returns ``cache``. As a JAX scatter drops out-of-range updates, a row
    whose position is ``>= S`` keeps its cache unchanged: its index is
    clamped and the old entry written back, so nothing waits on the host.
    ``cache`` may be the tile of a longer cache that starts at global
    position ``start`` (a ``cache_seq`` shard): only rows whose position
    lies in [start, start + S) write."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    pos = positions.to(device=cache.device, dtype=torch.long) - start
    at = torch.clamp(pos, min=0, max=S - 1)
    keep = ((pos >= S) | (pos < 0))[:, None, None]
    cache[rows, at] = torch.where(keep, cache[rows, at], new[:, 0].to(cache.dtype))
    return cache
