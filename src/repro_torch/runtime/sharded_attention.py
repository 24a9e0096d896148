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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.runtime.collectives import all_gather

IMPLS = ("allgather", "flash", "ring")


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rules, *, causal: bool,
                      block_kv: int = 512, impl: str = "allgather") -> torch.Tensor:
    """q (B_l, S_l, H, hd), k and v (B_l, S_l, KV, hd): this rank's batch
    rows and sequence shard -> (B_l, S_l, H, hd) in v's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sharded attention impl {impl!r}: {IMPLS}")
    mesh = rules.mesh
    if impl == "ring":
        if rules.kind == "train":  # rotation loop is forward-only
            impl = "flash"
        else:
            from repro_torch.runtime.ring_attention import ring_attention_shmap

            return ring_attention_shmap(q, k, v, rules, causal=causal, block_kv=block_kv)
    kv = all_gather(torch.stack([k, v]), mesh, "model", dim=2)  # one collective: (2, B_l, S, KV, hd)
    kg, vg = kv[0], kv[1]
    offset = mesh.axis_index("model") * q.shape[1]
    return flash_attention(q, kg, vg, causal=causal, q_offset=offset).to(v.dtype)
