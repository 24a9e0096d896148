"""Mixture-of-Experts layer: top-k routing with grouped dense dispatch.

Own copy of the JAX package's ``models/moe.py``, on one device. Tokens are
cut into (groups, group_size); each expert takes at most ``capacity =
group_size * top_k / n_experts * capacity_factor`` tokens of a group, in
token order, and a token routed past that falls through on the residual
path. The routing is the reference's, step for step: the router product in
the compute dtype, the softmax in f32, top-k as K rounds of first-index
argmax (:func:`~repro_torch.models.common.first_argmax`, whose tie order is
``jnp.argmax``'s, not ``torch.topk``'s), gates renormalised over the chosen
experts, and each token's slot from an f32 cumsum over the group.

The reference dispatches and combines with one-hot einsums over (group,
token, expert, slot); here both are index-based: the chosen (token, expert)
pairs that keep a slot are copied into an (experts, groups, capacity, d)
buffer, and each token sums its K experts' outputs at those slots. A slot
holds at most one token, so the buffer is the reference's dispatch einsum
exactly; the expert products are batched matmuls over the expert axis
(every expert computes all its slots, filled or not, as the reference's
dense dispatch does). The reference's ``constrain`` hint on the expert axis
(expert parallelism) has no counterpart yet (ROADMAP A14), and the family
refuses a mesh step of several ranks (ROADMAP A13): its token groups and
capacity drops depend on how the tokens are grouped.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, first_argmax


def moe_specs(cfg, n_layers: int | None, dtype: torch.dtype) -> dict:
    lead = () if n_layers is None else (n_layers,)
    lax = () if n_layers is None else ("layers",)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "router": ParamSpec(lead + (d, e), torch.float32, init="small", axes=lax + ("embed", None)),
        "w_gate": ParamSpec(lead + (e, d, f), dtype, axes=lax + ("experts", "embed", "mlp")),
        "w_up": ParamSpec(lead + (e, d, f), dtype, axes=lax + ("experts", "embed", "mlp")),
        "w_down": ParamSpec(lead + (e, f, d), dtype, axes=lax + ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs.update(
            shared_gate=ParamSpec(lead + (d, fs), dtype, axes=lax + ("embed", "mlp")),
            shared_up=ParamSpec(lead + (d, fs), dtype, axes=lax + ("embed", "mlp")),
            shared_down=ParamSpec(lead + (fs, d), dtype, axes=lax + ("mlp", "embed")),
        )
    return specs


def moe_capacity(group_size: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    c = int(math.ceil(group_size * top_k / n_experts * capacity_factor))
    return max(c, 4)


def moe_group_size(cfg, n_tokens: int) -> int:
    """The largest divisor of ``n_tokens`` up to ``cfg.moe_group_size``
    (decode windows are small and ragged)."""
    gs = min(cfg.moe_group_size, n_tokens)
    while n_tokens % gs:
        gs -= 1
    return gs


class Routing(NamedTuple):
    """One call's routing, over (G groups, gs tokens, E experts)."""

    probs: torch.Tensor  # (G, gs, E) f32 router softmax
    gates: torch.Tensor  # (G, gs, E) f32, renormalised over the chosen experts
    experts: torch.Tensor  # (G, gs, K) int64, the chosen experts in the order chosen
    keep: torch.Tensor  # (G, gs, E) bool: chosen and within capacity
    slot: torch.Tensor  # (G, gs, E) int64, the token's slot in each expert's buffer
    capacity: int

    def margin(self) -> torch.Tensor:
        """Per token, the K-th chosen router logit less the largest one not
        chosen (log-probabilities: the softmax's shift cancels): a
        perturbation of the logits by less than half of it cannot change
        the set of experts the token goes to."""
        chosen = self.probs.gather(-1, self.experts)
        rest = self.probs.scatter(-1, self.experts, 0.0)
        return torch.log(chosen.amin(-1)) - torch.log(rest.amax(-1))


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg, compute_dtype: torch.dtype) -> Routing:
    """Route ``xt`` (G, gs, d) over ``router`` (d, E), as the reference's
    ``moe_apply`` does before its dispatch."""
    G, gs, _ = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(gs, K, E, cfg.capacity_factor)
    # the router product in the compute dtype, the softmax in f32
    logits = (xt.to(compute_dtype) @ router.to(compute_dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # top-k, one expert at a time
    gates = torch.zeros_like(probs)
    masked = probs
    experts = []
    for _ in range(K):
        idx = first_argmax(masked, dim=-1)  # (G, gs)
        onehot = F.one_hot(idx, E).to(torch.float32)
        gates = gates + onehot * probs
        masked = masked * (1.0 - onehot)
        experts.append(idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # capacity: the position of each token in its expert's buffer
    sel = (gates > 0).to(torch.float32)
    pos = torch.cumsum(sel, dim=1) * sel - 1.0  # -1 where not routed
    keep = (pos >= 0) & (pos < C)
    slot = torch.clamp(pos, 0, C - 1).to(torch.int64)
    return Routing(probs, gates, torch.stack(experts, dim=-1), keep, slot, C)


def moe_dispatch(xt: torch.Tensor, r: Routing, compute_dtype: torch.dtype):
    """The tokens of ``xt`` (G, gs, d) in their experts' buffers: ``xe``
    (E, G, C, d) in the compute dtype, zeros in empty slots — the
    reference's dispatch einsum, transposed to expert-major. Also returns,
    per (group, token, k-th choice), the row of the flattened buffer it went
    to (the extra row E G C where it was dropped) and its combine weight
    (its gate, 0 where dropped)."""
    G, gs, d = xt.shape
    E, C = r.probs.shape[-1], r.capacity
    idx = r.experts
    kept = r.keep.gather(-1, idx)
    # an expert chosen twice (only where probabilities underflow to 0) counts once
    kept = kept & ~(idx[..., :, None] == idx[..., None, :]).tril(-1).any(-1)
    g = torch.arange(G, device=xt.device)[:, None, None]
    row = (idx * G + g) * C + r.slot.gather(-1, idx)
    row = torch.where(kept, row, E * G * C)
    weight = torch.where(kept, r.gates.gather(-1, idx), 0.0)
    buf = torch.zeros((E * G * C + 1, d), dtype=compute_dtype, device=xt.device)
    src = xt.to(compute_dtype)[:, :, None].expand(G, gs, idx.shape[-1], d)
    # kept rows are distinct; the dropped ones all land on the discarded last row
    buf.index_copy_(0, row.reshape(-1), src.reshape(-1, d))
    return buf[:-1].view(E, G, C, d), row, weight


def moe_apply(p: dict, x: torch.Tensor, cfg,
              compute_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN. ``x``: (B, S, d). Returns (y in ``x``'s dtype,
    the Switch load-balance aux loss, an f32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    gs = moe_group_size(cfg, T)
    G = T // gs
    cd = compute_dtype

    xt = x.reshape(G, gs, d)
    r = moe_route(p["router"], xt, cfg, cd)
    xe, row, weight = moe_dispatch(xt, r, cd)
    xe = xe.reshape(E, G * r.capacity, d)
    h = torch.bmm(xe, p["w_gate"].to(cd))
    u = torch.bmm(xe, p["w_up"].to(cd))
    ye = torch.bmm(F.silu(h) * u, p["w_down"].to(cd)).reshape(-1, d)  # (E G C, d)
    # combine: each token's K experts at its slots, weighted by its gates
    # (in the compute dtype, as the reference's combine tensor), summed in
    # f32; a dropped choice reads any row with weight 0
    picked = ye[row.clamp(max=ye.shape[0] - 1).reshape(-1)].view(G, gs, K, d).to(torch.float32)
    w = weight.to(cd).to(torch.float32)
    y = torch.einsum("gsk,gskd->gsd", w, picked).to(cd).reshape(B, S, d)

    if cfg.n_shared_experts:
        xs = x.to(cd)
        hs = F.silu(xs @ p["shared_gate"].to(cd)) * (xs @ p["shared_up"].to(cd))
        y = y + hs @ p["shared_down"].to(cd)

    # Switch-style load balance loss: E * sum_e f_e * p_e
    frac_routed = (r.gates > 0).to(torch.float32).mean(dim=(0, 1))
    mean_prob = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_routed * mean_prob) / K
    return y.to(x.dtype), aux
