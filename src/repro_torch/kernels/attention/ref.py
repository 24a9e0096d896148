"""Plain PyTorch versions of the two attention kernels (GQA, f32 inside).

* :func:`flash_attention_plain` — prefill attention as the JAX package's
  ``models/attention.py`` ``blockwise_attention`` computes it: an online
  softmax over KV blocks, f32 accumulation, NEG_INF masking, output in
  v's dtype. It takes any Sq and Skv (the last block may be short).
  :func:`flash_attention_plain_lse` also returns each row's log-sum-exp,
  the residual of the training forward (``_flash_fwd_core`` of the JAX
  package's ``runtime/sharded_attention.py``).
* :func:`flash_attention_bwd_plain` — that module's ``_flash_bwd``: the
  gradients of q, k and v from the saved output and log-sum-exp.
* :func:`decode_attention_plain` — one-token attention over a cache as
  ``models/attention.py`` ``decode_attention`` computes it without the
  kernel: a dense masked softmax where entries ``<= positions`` are valid;
  on a cache shard from ``start``, with its log-sum-exp for the merge.
* :func:`attention_ref` — the oracle of ``kernels/attention/ref.py``, in
  the Pallas kernel's (B, H, S, hd) layout.

The CPU path runs the first three; ``chip_smoke.py`` and the card tests hold
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


def _flash_plain_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      block_q: int, block_kv: int,
                      q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, KV, G, hd), lse (B, KV, G, Sq)), both in the sums' type:
    f32, or f64 for f64 inputs. Query row i sits at position q_offset + i."""
    sum_dt = torch.promote_types(q.dtype, torch.float32)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    block_q, block_kv = min(block_q, Sq), min(block_kv, Skv)
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd).to(sum_dt) * (1.0 / math.sqrt(hd))
    kf, vf = k.to(sum_dt), v.to(sum_dt)
    out = torch.empty((B, Sq, KV, G, hd), dtype=sum_dt, device=dev)
    lse = torch.empty((B, KV, G, Sq), dtype=sum_dt, device=dev)
    for q0 in range(0, Sq, block_q):
        qi = qg[:, q0:q0 + block_q]  # (B, bq, KV, G, hd)
        bq = qi.shape[1]
        qp = torch.arange(q_offset + q0, q_offset + q0 + bq, device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=sum_dt, device=dev)
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=sum_dt, device=dev)
        l = torch.zeros((B, KV, G, bq), dtype=sum_dt, device=dev)
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
        lse[..., q0:q0 + bq] = m + torch.log(torch.clamp_min(l, 1e-30))
    return out, lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, q_offset: int = 0, block_q: int = 512,
                          block_kv: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in v's
    dtype. Causal masks ``q_pos >= k_pos``, k_pos counted from 0 and q_pos
    from ``q_offset`` (the JAX package's ``q_pos = q_offset + arange(Sq)``
    of ``runtime/sharded_attention.py``)."""
    out, _ = _flash_plain_core(q, k, v, causal, block_q, block_kv, q_offset)
    return out.reshape(q.shape).to(v.dtype)


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, q_offset: int = 0, block_q: int = 512,
                              block_kv: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain` and each row's log-sum-exp of its
    scaled scores, ``m + log(max(l, 1e-30))``, f32 (f64 for f64 inputs) in
    (B, H, Sq) layout (head h = KV head h // G, member h % G)."""
    out, lse = _flash_plain_core(q, k, v, causal, block_q, block_kv, q_offset)
    B, Sq, H, _ = q.shape
    return out.reshape(q.shape).to(v.dtype), lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, q_offset: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's ``_flash_bwd`` written out: q, out, dout (B, Sq, H,
    hd), k, v (B, Skv, KV, hd), lse (B, H, Sq) f32 -> (dq, dk, dv) in the
    dtypes of q, k and v. In f32, with s the scaled scores: delta =
    rowsum(dO O), P = exp(s - lse), dV = P^T dO, dS = P (dP - delta) with
    dP = dO V^T, dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd), dK and dV
    summed over the G query heads of each KV head (f64 inputs: in f64).
    Causal masks as :func:`flash_attention_plain` with ``q_offset``."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    sum_dt = torch.promote_types(q.dtype, torch.float32)
    q32 = q.reshape(B, Sq, KV, G, hd).to(sum_dt)
    do = dout.reshape(B, Sq, KV, G, hd).to(sum_dt).permute(0, 2, 3, 1, 4)  # (B,KV,G,Sq,hd)
    o = out.reshape(B, Sq, KV, G, hd).to(sum_dt).permute(0, 2, 3, 1, 4)
    delta = (do * o).sum(dim=-1)  # (B, KV, G, Sq)
    kf, vf = k.to(sum_dt), v.to(sum_dt)
    s = torch.einsum("bqkgd,bskd->bkgqs", q32 * scale, kf)
    if causal:
        qp = torch.arange(q_offset, q_offset + Sq, device=dev)
        mask = qp[:, None] >= torch.arange(Skv, device=dev)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None].to(sum_dt))
    dv = torch.einsum("bkgqs,bkgqd->bskd", p, do)
    dp = torch.einsum("bkgqd,bskd->bkgqs", do, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q32) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           positions: torch.Tensor, *, start: int = 0, with_lse: bool = False):
    """q: (B, 1, H, hd); caches: (B, S, KV, hd); positions: (B,) — the new
    token attends to cache entries ``<= positions`` (all S when
    ``positions >= S``). Output (B, 1, H, hd) in v's dtype. The cache may
    be the shard of a longer one that starts at global position ``start``:
    entry j is valid where ``start + j <= positions``, and a row with no
    valid entry gives 0. ``with_lse`` also returns each row's log-sum-exp
    of its scaled scores, (B, H) f32, -inf for a row with no valid entry."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    pos = positions.to(q.device).to(torch.int64) - start
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # (B, S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    empty = (pos < 0)[:, None, None, None]  # no valid entry in the shard
    out = torch.where(empty, torch.zeros_like(out), out).reshape(B, 1, H, hd).to(v_cache.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, H)
    return out, torch.where(empty.reshape(B, 1), torch.full_like(lse, -math.inf), lse)
