"""Ring attention: sequence-parallel prefill with K/V rotating around the
"model" ranks.

Own counterpart of the JAX package's ``runtime/ring_attention.py``. Each
rank keeps its K/V block; the blocks rotate by ``ppermute`` (one
``batch_isend_irecv`` pair a step), so at step j rank i holds the block of
rank (i - j) mod n. For each block the flash kernel runs once with its
log-sum-exp: a block from an earlier shard without the causal mask, the
rank's own block causal (offset 0: both count from the shard's start), and
a block from a later shard not at all (the reference computes it fully
masked: it adds nothing). The partials merge in f32 by their LSEs, in step
order. Forward only, as in the reference (training takes the all-gather
flash path). Peak memory holds one rotating block instead of the gathered
K/V.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.ops import flash_attention_lse
from repro_torch.runtime.collectives import ppermute


@torch.no_grad()
def ring_attention_shmap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rules, *,
                         causal: bool, block_kv: int = 512) -> torch.Tensor:
    """q (B_l, S_l, H, hd), k and v (B_l, S_l, KV, hd): this rank's shard
    -> (B_l, S_l, H, hd) in v's dtype. ``block_kv`` is the reference's
    argument; the kernel takes its own tiles."""
    mesh = rules.mesh
    n, i = mesh.axis_size("model"), mesh.axis_index("model")
    out = lse = None
    kv = torch.stack([k, v])  # the block that travels: K and V together
    for j in range(n):
        src = (i - j) % n  # shard of origin of the block held now
        if not (causal and src > i):
            o_j, l_j = flash_attention_lse(q, kv[0], kv[1], causal=causal and src == i)
            o_j = o_j.to(torch.float32)
            l_j = l_j.transpose(1, 2)[..., None]  # (B, S_l, H, 1)
            if out is None:
                out, lse = o_j, l_j
            else:
                m = torch.maximum(lse, l_j)
                a, b = torch.exp(lse - m), torch.exp(l_j - m)
                out = (out * a + o_j * b) / (a + b)
                lse = m + torch.log(a + b)
        if j + 1 < n:  # rotate: send the block held to the next rank
            kv = ppermute(kv, mesh, "model", shift=1)
    return out.to(v.dtype)
