"""Plain PyTorch versions of the two attention kernels (GQA, f32 inside).

* :func:`flash_attention_plain` — prefill attention as the JAX package's
  ``models/attention.py`` ``blockwise_attention`` computes it: an online
  softmax over KV blocks, f32 accumulation, NEG_INF masking, output in
  v's dtype. It takes any Sq and Skv (the last block may be short).
* :func:`decode_attention_plain` — one-token attention over a cache as
  ``models/attention.py`` ``decode_attention`` computes it without the
  kernel: a dense masked softmax where entries ``<= positions`` are valid.
* :func:`attention_ref` — the oracle of ``kernels/attention/ref.py``, in
  the Pallas kernel's (B, H, S, hd) layout.

The CPU path runs the first two; ``chip_smoke.py`` and the card tests hold
the CUDA kernels against them on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); H % KV == 0."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return out.reshape(B, H, Sq, hd).to(v.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, block_q: int = 512,
                          block_kv: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in v's
    dtype. Causal masks ``q_pos >= k_pos`` with both counted from 0."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    block_q, block_kv = min(block_q, Sq), min(block_kv, Skv)
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd).to(torch.float32) * (1.0 / math.sqrt(hd))
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((B, Sq, KV, G, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, block_q):
        qi = qg[:, q0:q0 + block_q]  # (B, bq, KV, G, hd)
        bq = qi.shape[1]
        qp = torch.arange(q0, q0 + bq, device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, block_kv):
            ki, vi = kf[:, k0:k0 + block_kv], vf[:, k0:k0 + block_kv]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki)
            if causal:
                kp = torch.arange(k0, k0 + ki.shape[1], device=dev)
                s = torch.where(qp[:, None] >= kp[None, :], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vi)
            m = m_new
        out[:, q0:q0 + bq] = (acc / torch.clamp_min(l[..., None], 1e-30)).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, KV, hd); positions: (B,) — the new
    token attends to cache entries ``<= positions`` (all S when
    ``positions >= S``). Output (B, 1, H, hd) in v's dtype."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    valid = torch.arange(S, device=q.device)[None, :] <= positions.to(q.device)[:, None]  # (B, S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(v_cache.dtype)
