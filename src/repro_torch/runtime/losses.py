"""Vocab-parallel embedding and cross-entropy (Megatron-style).

Own copy of the JAX package's ``runtime/losses.py``. The final hidden
states are sequence-sharded on "model" while the output head is
vocab-sharded on "model": full (B, S, V) logits never exist. Each rank
all-gathers the (small) hidden states of its batch rows along the
sequence, computes logits against its vocab slice in sequence chunks, and
the softmax's max and sum run as ``pmax`` and ``psum`` over "model". The
JAX ``shard_map`` bodies run here as each rank's own code on its local
tiles; their backward goes through the collectives' autograd rules
(``runtime/collectives.py``). A serving decode step's tokens are alike on
every "model" rank, not sequence shards: its lookup sums the vocab slices'
hits with a ``psum`` (:func:`vocab_parallel_lookup`).
"""
from __future__ import annotations

import torch

from repro_torch.runtime.collectives import all_gather, pmax, psum, psum_scatter


def vocab_parallel_embed(tokens: torch.Tensor, embed: torch.Tensor, rules) -> torch.Tensor:
    """Embedding lookup with a vocab-sharded table: ``tokens`` (B_l, S_l)
    this rank's tile, ``embed`` (V_pad / n_model, d) its vocab slice ->
    (B_l, S_l, d). The int tokens are all-gathered along the sequence, each
    rank embeds the hits of its slice (zeros elsewhere), and a
    reduce-scatter over "model" sums the slices back to sequence shards."""
    mesh = rules.mesh
    i = mesh.axis_index("model")
    vshard = embed.shape[0]
    tg = all_gather(tokens, mesh, "model", dim=1)  # (B_l, S)
    t_loc = tg - i * vshard
    in_range = (t_loc >= 0) & (t_loc < vshard)
    safe = torch.clamp(t_loc, 0, vshard - 1)
    x = embed[safe]  # (B_l, S, d), only local-vocab hits
    x = torch.where(in_range[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return psum_scatter(x, mesh, "model", dim=1)


def vocab_parallel_cross_entropy(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                                 mask: torch.Tensor, rules, *, chunk: int = 512
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B_l, S_l, D) this rank's sequence tile, ``head`` (V_pad /
    n_model, D) its vocab slice, ``targets`` (B_l, S_l) int, ``mask``
    (B_l, S_l) f32 -> (sum_nll, sum_mask), f32 scalars every rank holds
    alike (summed over the batch axes). Logits run in ``x``'s dtype, cast to
    f32, as the reference; sequence chunks of ``min(chunk, S)`` rounded down
    to a divisor."""
    mesh = rules.mesh
    i = mesh.axis_index("model")
    vshard = head.shape[0]
    xg = all_gather(x, mesh, "model", dim=1)  # (B_l, S, D)
    tg = all_gather(targets, mesh, "model", dim=1)
    mg = all_gather(mask, mesh, "model", dim=1)
    S = xg.shape[1]
    cs = min(chunk, S)
    while S % cs:
        cs -= 1
    hT = head.to(x.dtype).T  # (D, vshard)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, cs):
        xi, ti, mi = xg[:, c0:c0 + cs], tg[:, c0:c0 + cs], mg[:, c0:c0 + cs]
        logits = (xi @ hT).to(torch.float32)  # (B_l, cs, vshard)
        # stabilization constant only: its gradients cancel exactly
        lmax = pmax(logits.detach().amax(dim=-1), mesh, "model")
        sumexp = psum(torch.exp(logits - lmax[..., None]).sum(dim=-1), mesh, "model")
        lse = torch.log(sumexp) + lmax
        t_loc = ti.to(torch.long) - i * vshard
        in_range = (t_loc >= 0) & (t_loc < vshard)
        safe = torch.clamp(t_loc, 0, vshard - 1)
        picked_loc = torch.gather(logits, -1, safe[..., None])[..., 0]
        picked = psum(torch.where(in_range, picked_loc, torch.zeros_like(picked_loc)), mesh,
                      "model")
        tot = tot + ((lse - picked) * mi).sum()
    cnt = mask.to(torch.float32).sum()
    axes = ("model",) + tuple(rules.batch_axes)
    cnt = psum(cnt.detach(), mesh, axes)
    if rules.batch_axes:
        tot = psum(tot, mesh, rules.batch_axes)
    return tot, cnt


def vocab_parallel_lookup(tokens: torch.Tensor, embed: torch.Tensor, rules) -> torch.Tensor:
    """Embedding lookup of tokens that every "model" rank holds alike (a
    decode step's (B_l, 1), not sequence shards) with a vocab-sharded
    table, ``embed`` (V_pad / n_model, d) the rank's slice: each rank
    embeds the hits of its slice (zeros elsewhere), and a ``psum`` over
    "model" adds the one hit of each token to the zeros (exact)."""
    mesh = rules.mesh
    vshard = embed.shape[0]
    t_loc = tokens.to(torch.long) - mesh.axis_index("model") * vshard
    in_range = (t_loc >= 0) & (t_loc < vshard)
    x = embed[torch.clamp(t_loc, 0, vshard - 1)]
    x = torch.where(in_range[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return psum(x, mesh, "model")
