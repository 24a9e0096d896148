"""Sequence-parallel attention for training and prefill.

Own counterpart of the JAX package's ``runtime/sharded_attention.py``. Each
"model" rank holds S / n_model query rows of the sequence and their K and
V. The reference's baseline schedule, kept here: all-gather K and V over
"model" (stacked: one collective per layer), then attend the local rows to the
whole sequence with the causal mask at the rows' global positions. In the
port that is one call of the flash wrapper with ``q_offset = axis_index
("model") * S_local``: the hand-written flash kernel on the card, forward
and backward (``FlashAttentionFn``), whose causal bounds count from that
offset. The gather's backward reduce-scatters dK and dV to their shards.

The reference's ``local_flash`` (a masked ``lax.scan`` for reverse mode, a
dynamic-bound loop forward) and its ``custom_vjp`` flash are both that one
path here, so ``impl`` "allgather" and "flash" run the same code; "ring"
runs ``runtime/ring_attention.py`` for prefill and "flash" for training (its
rotation loop is forward-only, as in the reference).

:func:`sharded_decode_attention` is the decode step's counterpart over a
``cache_seq``-sharded cache: each rank attends to its tile with the decode
kernel's log-sum-exp and the partials merge once over the cache axes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.ops import decode_attention_lse, flash_attention
from repro_torch.runtime.collectives import all_gather, pmax, psum

IMPLS = ("allgather", "flash", "ring")


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rules, *, causal: bool,
                      block_kv: int = 512, impl: str = "allgather", with_kv: bool = False):
    """q (B_l, S_l, H, hd), k and v (B_l, S_l, KV, hd): this rank's batch
    rows and sequence shard -> (B_l, S_l, H, hd) in v's dtype; with
    ``with_kv``, (out, K, V) with the whole sequence's K and V (B_l, S, KV,
    hd) of the rows, the gathered ones (the ring gathers them for it)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sharded attention impl {impl!r}: {IMPLS}")
    mesh = rules.mesh
    if impl == "ring":
        if rules.kind == "train":  # rotation loop is forward-only
            impl = "flash"
        else:
            from repro_torch.runtime.ring_attention import ring_attention_shmap

            out = ring_attention_shmap(q, k, v, rules, causal=causal, block_kv=block_kv)
            if not with_kv:
                return out
            kv = all_gather(torch.stack([k, v]), mesh, "model", dim=2)
            return out, kv[0], kv[1]
    kv = all_gather(torch.stack([k, v]), mesh, "model", dim=2)  # one collective: (2, B_l, S, KV, hd)
    kg, vg = kv[0], kv[1]
    offset = mesh.axis_index("model") * q.shape[1]
    out = flash_attention(q, kg, vg, causal=causal, q_offset=offset).to(v.dtype)
    return (out, kg, vg) if with_kv else out


@torch.no_grad()
def sharded_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             positions: torch.Tensor, mesh, *, start: int,
                             axes: tuple) -> torch.Tensor:
    """One-token attention over a K/V cache split along its sequence over
    ``axes`` (the "cache_seq" axes): q (B_l, 1, H, hd), this rank's tile
    (B_l, C, KV, hd) of the cache, which starts at global position
    ``start``. The decode kernel runs on the tile with its log-sum-exp
    (-inf and a zero output where the tile holds no valid entry); the
    partials merge over ``axes`` by the log-sum-exp rule, once, in f32 (the
    ring's merge): m = pmax(lse), w = exp(lse - m), out = psum(o w) /
    psum(w), the two sums in one collective. -> (B_l, 1, H, hd) in v's
    dtype."""
    o, lse = decode_attention_lse(q, k_cache, v_cache, positions, start=start)
    m = pmax(lse, mesh, axes)  # (B_l, H): finite, the tile of position 0 holds an entry
    w = torch.exp(lse - m)[:, None, :, None]  # (B_l, 1, H, 1); 0 for an empty tile
    sums = psum(torch.cat([o.to(torch.float32) * w, w], dim=-1), mesh, axes)
    return (sums[..., :-1] / sums[..., -1:]).to(v_cache.dtype)
