"""Mixture-of-Experts layer: top-k routing with grouped dense dispatch.

Own copy of the JAX package's ``models/moe.py``. Tokens are cut into
(groups, group_size), row-major over (B, S); each expert takes at most
``capacity = group_size * top_k / n_experts * capacity_factor`` tokens of a
group, in token order, and a token routed past that falls through on the
residual path. The routing is the reference's, step for step: the router
product in the compute dtype, the softmax in f32, top-k as K rounds of
first-index argmax (:func:`~repro_torch.models.common.first_argmax`, whose
tie order is ``jnp.argmax``'s, not ``torch.topk``'s), gates renormalised
over the chosen experts, and each token's slot from an f32 cumsum over the
group.

The reference dispatches and combines with one-hot einsums over (group,
token, expert, slot); here both are index-based: the chosen (token, expert)
pairs that keep a slot are copied into an (experts, groups, capacity, d)
buffer, and each token sums its K experts' outputs at those slots. A slot
holds at most one token, so the buffer is the reference's dispatch einsum
exactly; the expert products are batched matmuls over the expert axis
(every expert computes all its slots, filled or not, as the reference's
dense dispatch does).

On a mesh step (:class:`TokenLayout`) a rank holds its rows' shard of the
sequence, a slice of the global token list, while the groups, their size
and the capacity are the global list's, as the reference's GSPMD program
groups them. A group may span ranks (its size above the sequence shard, or
a decode step's few rows in one group across the batch axes): a token's slot
is then its rank's cumsum plus the per-expert counts of the group's earlier
tokens on other ranks, exchanged as (sub-blocks, experts) counts over the
axes the groups span, never the tokens, and the load-balance loss takes the
global means by ``psum`` over the token axes.

Expert parallelism (the reference's ``constrain`` of the dispatch and
return buffers to ("moe_groups", "experts"), which GSPMD lowers to an
all-to-all): where the "model" axis splits the expert count, the expert
leaves stay each rank's "model" tile of E / n_model experts
(``runtime/sharding.py`` ``model_tile``; a layer gathers them over their
ZeRO axes only, ``models/common.py`` ``ShardedLayer``; the serving steps
keep them as tiles) and the rank computes only those experts. In train and
prefill steps, whose "model" ranks hold different sequence shards, an
all-to-all over "model" carries each expert block of every rank's buffers
to the block's owner, which sums the partial buffers of a group that spans
several ranks (disjoint filled slots: the sum is exact) and computes each
group once; the inverse all-to-all returns the outputs for the combine. In
a decode step every "model" rank holds the same tokens: nothing moves, each
rank computes its experts' block of its own buffers and combines only their
outputs, and a ``psum`` over "model" completes each token (a decode group
that spans the batch axes is still computed on each of its ranks, holding
only that rank's tokens); the shared experts' row-parallel down product
(tensor-parallel serving) rides in the same ``psum``. Where the
"model" axis does not divide the expert count the experts are gathered
whole, as any layer's leaves, and every rank computes all of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamSpec,
    column_product,
    first_argmax,
    row_parallel,
    row_product,
)


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


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg, compute_dtype: torch.dtype, *,
              group_size: int | None = None, prefix=None) -> Routing:
    """Route ``xt`` (G, gs, d) over ``router`` (d, E), as the reference's
    ``moe_apply`` does before its dispatch. On a mesh (:func:`moe_apply`)
    the rows of ``xt`` are sub-blocks of the global groups of
    ``group_size`` tokens, which sets the capacity, and ``prefix`` maps
    their per-expert counts (G, E) to those of the tokens before each
    sub-block in its group, wherever they are held."""
    G, gs, _ = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(group_size or gs, K, E, cfg.capacity_factor)
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
    count = torch.cumsum(sel, dim=1)
    if prefix is not None:
        count = count + prefix(count[:, -1])[:, None, :]
    pos = count * sel - 1.0  # -1 where not routed
    keep = (pos >= 0) & (pos < C)
    slot = torch.clamp(pos, 0, C - 1).to(torch.int64)
    return Routing(probs, gates, torch.stack(experts, dim=-1), keep, slot, C)


def moe_dispatch(xt: torch.Tensor, r: Routing, compute_dtype: torch.dtype,
                 groups: torch.Tensor | None = None, n_groups: int | None = None):
    """The tokens of ``xt`` (G, gs, d) in their experts' buffers: ``xe``
    (E, G, C, d) in the compute dtype, zeros in empty slots — the
    reference's dispatch einsum, transposed to expert-major. Also returns,
    per (group, token, k-th choice), the row of the flattened buffer it went
    to (the extra row E G C where it was dropped) and its combine weight
    (its gate, 0 where dropped). On a mesh the rows of ``xt`` are
    sub-blocks, ``groups`` (G,) the buffer group each fills (of
    ``n_groups``)."""
    G, gs, d = xt.shape
    E, C = r.probs.shape[-1], r.capacity
    Gb = G if n_groups is None else n_groups
    idx = r.experts
    kept = r.keep.gather(-1, idx)
    # an expert chosen twice (only where probabilities underflow to 0) counts once
    kept = kept & ~(idx[..., :, None] == idx[..., None, :]).tril(-1).any(-1)
    g = (torch.arange(G, device=xt.device) if groups is None else groups)[:, None, None]
    row = (idx * Gb + g) * C + r.slot.gather(-1, idx)
    row = torch.where(kept, row, E * Gb * C)
    weight = torch.where(kept, r.gates.gather(-1, idx), 0.0)
    buf = torch.zeros((E * Gb * C + 1, d), dtype=compute_dtype, device=xt.device)
    src = xt.to(compute_dtype)[:, :, None].expand(G, gs, idx.shape[-1], d)
    # kept rows are distinct; the dropped ones all land on the discarded last row
    buf.index_copy_(0, row.reshape(-1), src.reshape(-1, d))
    return buf[:-1].view(E, Gb, C, d), row, weight


@dataclass(frozen=True)
class TokenLayout:
    """Where a mesh rank's (B_l, S_l) tokens lie in the global token list,
    row-major over (B, S) = (B_l n_rows, S_l n_seq): the rank holds row
    block ``row_i`` (over ``row_axes``) and sequence shard ``seq_i`` (over
    "model" where the sequence is sharded; a decode step's one token is
    not)."""

    mesh: Any
    row_axes: tuple
    row_i: int
    n_rows: int
    seq_i: int
    n_seq: int

    def axes(self) -> tuple:
        """The mesh axes over which the ranks hold different tokens."""
        return tuple(a for a in self.mesh.axis_names
                     if a in self.row_axes or (a == "model" and self.n_seq > 1))

    def plan(self, B: int, S: int, gs: int):
        """For groups of ``gs`` tokens and the rank's (B, S) tokens cut in
        sub-blocks of h = gcd(S, gs) (each inside one group and one rank's
        part): (h, each sub-block's buffer group (tensor), the number of
        buffer groups, the ``prefix`` of :func:`moe_route`, or None where
        every sub-block is a whole group)."""
        h = math.gcd(S, gs)

        def subs(row_i: int, seq_i: int) -> list:
            return self._subs(B, S, h, row_i, seq_i)

        mine = subs(self.row_i, self.seq_i)
        grp = [u * h // gs for u in mine]
        first = sorted(set(grp))
        local = {g: i for i, g in enumerate(first)}
        dev = self.mesh.device
        groups = torch.tensor([local[g] for g in grp], dtype=torch.int64, device=dev)
        if h == gs:
            return h, groups, len(first), None
        # the axes a group spans: the sequence shards where a shard is not
        # whole groups, the row blocks where a block is not
        axes = tuple(a for a in self.mesh.axis_names
                     if (a == "model" and self.n_seq > 1 and S % gs)
                     or (a in self.row_axes and self.n_rows > 1 and (B * S * self.n_seq) % gs))
        if axes:
            _, ranks = self.mesh.group(axes)
            held = []
            for rank in ranks:
                c = self.mesh.coords(rank)
                row_i = self.row_i if not set(axes) & set(self.row_axes) else _index(
                    self.mesh, self.row_axes, c)
                seq_i = c["model"] if "model" in axes else self.seq_i
                held += subs(row_i, seq_i)
        else:
            held = mine
        before = torch.tensor([[held[j] * h // gs == g and held[j] < u for j in range(len(held))]
                               for u, g in zip(mine, grp)], dtype=torch.float32, device=dev)

        def prefix(counts: torch.Tensor) -> torch.Tensor:
            """(n_sub, E) counts of the rank's sub-blocks -> the counts of
            the tokens before each in its group."""
            every = group_counts(counts, self.mesh, axes)  # (len(held), E)
            return (before[:, :, None] * every[None]).sum(1)

        return h, groups, len(first), prefix

    def _subs(self, B: int, S: int, h: int, row_i: int, seq_i: int) -> list:
        """The global sub-block indices (h tokens each) of a rank's part,
        in its order."""
        per = S // h  # sub-blocks a row
        return [((row_i * B + b) * self.n_seq + seq_i) * per + j
                for b in range(B) for j in range(per)]

    def model_groups(self, B: int, S: int, gs: int) -> list:
        """The buffer groups (global indices, ascending: the order of
        :meth:`plan`'s buffer) of each "model" rank of the rank's row
        block, in "model" order."""
        h = math.gcd(S, gs)
        return [sorted({u * h // gs for u in self._subs(B, S, h, self.row_i, i)})
                for i in range(self.n_seq)]


def _index(mesh, axes: tuple, coords: dict) -> int:
    """A rank's index (row-major) along ``axes`` from its coordinates."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def group_counts(counts: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Every rank's sub-block counts along ``axes`` (the ranks' order),
    stacked: (ranks x n_sub, E); this rank's own where ``axes`` is empty."""
    if not axes:
        return counts
    from repro_torch.runtime.collectives import all_gather_stack

    return all_gather_stack(counts, mesh, axes).reshape(-1, counts.shape[-1])


def token_layout(B: int, S: int) -> TokenLayout | None:
    """The rank's :class:`TokenLayout` under a mesh step that splits the
    tokens over ranks; None on one device (or where every rank holds every
    token)."""
    from repro_torch.runtime.sharding import current_rules, model_parallel

    rules = current_rules()
    if rules is None:
        return None
    mesh = rules.mesh
    row_axes = tuple(a for a in rules.batch_axes if mesh.shape[a] > 1)
    n_rows = mesh.axis_size(row_axes) if row_axes else 1
    n_seq = rules.n_model if model_parallel() is not None else 1
    if n_rows == 1 and n_seq == 1:
        return None
    return TokenLayout(mesh, row_axes, mesh.axis_index(row_axes) if row_axes else 0, n_rows,
                       mesh.axis_index("model") if n_seq > 1 else 0, n_seq)


def _experts(p: dict, xe: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The experts of ``p`` (E', d, f) on their buffers ``xe`` (E', G, C, d):
    every slot, filled or not, as the reference's dense dispatch."""
    n, G, C, d = xe.shape
    xe = xe.reshape(n, G * C, d)
    h = torch.bmm(xe, p["w_gate"].to(cd))
    u = torch.bmm(xe, p["w_up"].to(cd))
    return torch.bmm(F.silu(h) * u, p["w_down"].to(cd)).view(n, G, C, d)


def _expert_mesh(p: dict, n_experts: int):
    """The mesh whose "model" ranks split the experts where ``p`` holds the
    rank's tile of them (expert parallelism), else None."""
    held = p["w_gate"].shape[0]
    if held == n_experts:
        return None
    from repro_torch.runtime.sharding import current_rules

    rules = current_rules()
    if rules is None or rules.n_model * held != n_experts:
        raise ValueError(f"{held} of {n_experts} experts outside a mesh step whose \"model\" "
                         f"axis splits them")
    return rules.mesh


def _owner_buffers(recv: torch.Tensor, pos: torch.Tensor, n_groups: int) -> torch.Tensor:
    """An owner's buffers (El, n_groups, C, d) from the partial buffers
    ``recv`` (El, senders x Gm, C, d) of its experts, each sender's g-th
    group at ``pos`` (padding at ``n_groups``, discarded): a group that
    several senders hold is the sum of their partials, exact as their
    filled slots are disjoint."""
    El, _, C, d = recv.shape
    return recv.new_zeros((El, n_groups + 1, C, d)).index_add(1, pos, recv)[:, :-1]


def _exchange(p: dict, xe: torch.Tensor, cd: torch.dtype, mesh, peers: list) -> torch.Tensor:
    """Expert parallelism where the "model" ranks hold different tokens
    (train and prefill): the outputs (E, G, C, d) of the rank's buffers
    ``xe``, of which it computes only its experts' block, for every "model"
    rank of its row block. ``peers`` lists each such rank's buffer groups
    (:meth:`TokenLayout.model_groups`). An all-to-all over "model" sends
    expert block j of every rank's buffers (padded to the most groups a
    rank holds) to rank j, which sums the partial buffers of a group held
    by several ranks (their filled slots are disjoint: the sum is exact),
    computes each group once, and returns each rank its groups' outputs by
    the inverse all-to-all."""
    from repro_torch.runtime.collectives import all_to_all

    E, G, C, d = xe.shape
    n = len(peers)
    El, Gm = E // n, max(len(g) for g in peers)
    union = sorted(set().union(*peers))
    at = {g: u for u, g in enumerate(union)}
    # each sender's groups in the union's order; padding goes to an extra last row
    pos = torch.tensor([[at[g] for g in gr] + [len(union)] * (Gm - len(gr)) for gr in peers],
                       dtype=torch.int64, device=xe.device).reshape(-1)
    send = F.pad(xe, (0, 0, 0, 0, 0, Gm - G))  # (E, Gm, C, d)
    recv = all_to_all(send, mesh, "model", dim=0).view(n, El, Gm, C, d)  # by sender
    buf = _owner_buffers(recv.transpose(0, 1).reshape(El, n * Gm, C, d), pos, len(union))
    ye = _experts(p, buf, cd)  # (El, groups, C, d): each group once
    ye = torch.cat([ye, ye.new_zeros((El, 1, C, d))], dim=1)
    back = ye[:, pos].view(El, n, Gm, C, d).transpose(0, 1).reshape(E, Gm, C, d)
    return all_to_all(back, mesh, "model", dim=0)[:, :G]


def moe_apply(p: dict, x: torch.Tensor, cfg,
              compute_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN. ``x``: (B, S, d), on a mesh step the rank's rows
    and sequence shard. Returns (y in ``x``'s dtype, the Switch
    load-balance aux loss, an f32 scalar of the global token list). Where
    ``p``'s experts are the rank's "model" tile of them (expert
    parallelism), it computes only those: the tokens of train and prefill
    steps move to their experts' rank (:func:`_exchange`); a decode step's,
    alike on every "model" rank, stay, and each rank combines its experts'
    outputs, summed over "model"."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cd = compute_dtype
    layout = token_layout(B, S)
    if layout is None:
        T = B * S
        gs = moe_group_size(cfg, T)
        xt = x.reshape(T // gs, gs, d)
        r = moe_route(p["router"], xt, cfg, cd)
        groups, G = None, T // gs
    else:
        T = B * S * layout.n_rows * layout.n_seq
        gs = moe_group_size(cfg, T)
        hb, groups, G, prefix = layout.plan(B, S, gs)
        xt = x.reshape(B * S // hb, hb, d)
        r = moe_route(p["router"], xt, cfg, cd, group_size=gs, prefix=prefix)
    xe, row, weight = moe_dispatch(xt, r, cd, groups, G)
    mesh, partial = _expert_mesh(p, E), False
    if mesh is None:
        ye = _experts(p, xe, cd)
    elif layout is not None and layout.n_seq > 1:
        ye = _exchange(p, xe, cd, mesh, layout.model_groups(B, S, gs))
    else:  # the same tokens on every "model" rank: its experts' block only
        El, lo = p["w_gate"].shape[0], mesh.axis_index("model")
        ye = _experts(p, xe[lo * El:(lo + 1) * El], cd)
        # the flattened buffer's rows of this rank's experts, and the rest
        span = El * G * r.capacity
        own = (row >= lo * span) & (row < (lo + 1) * span)
        row = torch.where(own, row - lo * span, 0)
        weight = torch.where(own, weight, 0.0)
        partial = True
    ye = ye.reshape(-1, d)
    # combine: each token's K experts at its slots, weighted by its gates
    # (in the compute dtype, as the reference's combine tensor), summed in
    # f32; a dropped choice (or one of another rank's experts) reads any row
    # with weight 0
    picked = ye[row.clamp(max=ye.shape[0] - 1).reshape(-1)].view(*xt.shape[:2], K, d)
    w = weight.to(cd).to(torch.float32)
    y = torch.einsum("gsk,gskd->gsd", w, picked.to(torch.float32)).reshape(B, S, d)
    # sums over "model", f32, in one psum: every rank's experts' share of
    # each token, and the shared experts' row-parallel down product (each
    # cast to the compute dtype after its sum, before they are added, as
    # the reference rounds the combine and the product)
    sums, shared = [y] if partial else [], None
    if cfg.n_shared_experts:
        hs = F.silu(column_product(p, "shared_gate", x, cd, gather=False)) \
            * column_product(p, "shared_up", x, cd, gather=False)
        if row_parallel(p, "shared_down"):
            sums.append(row_product(p, "shared_down", hs, cd, reduce=False))
        else:
            shared = hs @ p["shared_down"].to(cd)
    if sums:
        from repro_torch.runtime.collectives import psum

        sums = list(psum(torch.stack(sums), mesh if partial else p.mesh, "model"))
        y = sums.pop(0) if partial else y
        shared = sums.pop(0).to(cd) if sums else shared
    y = y.to(cd)
    if shared is not None:
        y = y + shared

    # Switch-style load balance loss: E * sum_e f_e * p_e, of global means
    routed = (r.gates > 0).to(torch.float32)
    if layout is None:
        frac_routed, mean_prob = routed.mean(dim=(0, 1)), r.probs.mean(dim=(0, 1))
    else:
        from repro_torch.runtime.collectives import psum

        sums = psum(torch.cat([routed.sum(dim=(0, 1)), r.probs.sum(dim=(0, 1))]),
                    layout.mesh, layout.axes()) / T
        frac_routed, mean_prob = sums[:E], sums[E:]
    aux = E * torch.sum(frac_routed * mean_prob) / K
    return y.to(x.dtype), aux
