"""Attention: GQA naive / blockwise (flash) / decode, plus the KV-cache write.

All functions take Q: (B, Sq, H, hd); K, V: (B, Skv, KV, hd) with
H % KV == 0, as the JAX package's ``models/attention.py``. The tensor's
device picks the implementation, with no switch: :func:`blockwise_attention`
and :func:`decode_attention` are the kernel wrappers of
``kernels/attention/ops.py``, which run the hand-written flash and decode
kernels on CUDA tensors and their plain versions (``kernels/attention/ref.py``)
on CPU tensors. The JAX package's ``decode_kernel_scope`` therefore has no
counterpart. Prefill on the card goes through the flash kernel, which
computes the same function as the JAX package's pure-JAX
``blockwise_attention``. The JAX package's ``attention(impl=...)`` dispatch
and its sequence-parallel routes come with the multi-device slice (ROADMAP
A9).
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


def update_cache(cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B,1,KV,hd) into ``cache`` (B,S,KV,hd) at per-row
    ``positions``, **in place** (the JAX version returns an updated copy);
    returns ``cache``. As a JAX scatter drops out-of-range updates, a row
    whose position is ``>= S`` keeps its cache unchanged: its index is
    clamped and the old entry written back, so nothing waits on the host."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    pos = positions.to(device=cache.device, dtype=torch.long)
    at = torch.clamp(pos, max=S - 1)
    keep = (pos >= S)[:, None, None]
    cache[rows, at] = torch.where(keep, cache[rows, at], new[:, 0].to(cache.dtype))
    return cache
