"""Shared model building blocks: param specs, norms, RoPE, embeddings.

Parameters are plain nested dicts of tensors. Every leaf is declared
through a :class:`ParamSpec`; the same spec tree serves real initialization
(from a ``torch.Generator``, on the generator's device) and allocation-free
``meta`` tensors (:func:`spec_struct`), the counterpart of the JAX
package's ``ShapeDtypeStruct`` trees. Each spec carries the JAX spec's
*logical axis names* (``axes``), which ``runtime/sharding.py`` maps onto a
mesh.

Under a mesh step (``runtime/sharding.py`` ``activation_rules``) every
rank runs these on its local rows and, with a "model" axis of more than
one rank, its shard of the sequence; the pieces that mix positions or the
vocabulary then take their shard's context, where the JAX package's GSPMD
sees whole arrays: :func:`layer_params` all-gathers a layer's sharded
leaves (an expert leaf only over its ZeRO axes: expert parallelism; in a
serving decode step every "model" tile of a weight stays a tile, and
:func:`column_products` / :func:`row_product` run the tensor-parallel
products on it),
:func:`seq_positions` offsets RoPE positions by the shard's start,
:func:`shift_targets` takes the next shard's first token, and
:func:`embed_lookup` / :func:`chunked_cross_entropy` run the vocab-parallel
forms of ``runtime/losses.py`` (the reference's wiring), or sum the local
loss over the batch axes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # "fan_in" | "normal" | "zeros" | "ones" | "small"
    axes: tuple = ()  # logical axis name per dim (None = replicated dim)

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ParamSpec {self.shape} needs one axis name per dim, got {self.axes}")

    def struct(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def initialize(self, generator: torch.Generator) -> torch.Tensor:
        """Draw on the generator's device: normal 0.02 for ``normal``, 1e-3
        for ``small``, 1/sqrt(fan_in) for ``fan_in`` (fan_in = the
        second-to-last dim), zeros for biases, ones for norms; drawn in f32,
        stored in ``dtype``."""
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "normal":
            std = 0.02
        elif self.init == "small":
            std = 1e-3
        else:  # fan_in
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(self.dtype)


SpecTree = Any  # nested dict[str, ParamSpec]


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict, keys in sorted order
    (the order JAX flattens dicts in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


class ShardedLayer(dict):
    """One layer's params under a mesh step (or a serving step's unstacked
    leaves): the rank's tiles of the leaves registered as sharded (and the
    rest whole), with their specs (``specs``). :meth:`gather` all-gathers
    the tiles to the full layer (``runtime/sharding.py`` ``unshard_many``),
    but for the leaves of ``tiles`` ({name: ``model_tile``'s (kept,
    gathered) specs}), which stay the rank's "model" tile and gather only
    over their other axes (ZeRO's), in a collective of their own: the
    experts (expert parallelism, ``models/moe.py``), and in a serving
    decode step every tensor-parallel product's weight. ``remat_apply``
    calls it inside the layer's checkpoint, so the gathered weights live
    while the layer runs and its backward's recompute gathers them again."""

    def __init__(self, leaves: dict, specs: dict, mesh, tiles: dict | None = None):
        super().__init__(leaves)
        self.specs, self.mesh, self.tiles = specs, mesh, tiles or {}

    def gather(self) -> dict:
        """The layer as it runs: a dict, or :class:`ModelTiles` where some
        leaves stay "model" tiles."""
        from repro_torch.runtime.sharding import spec_axes, unshard_many

        out = dict(self)
        whole = [k for k in self.specs if k not in self.tiles]
        kept = [k for k in self.specs if k in self.tiles and spec_axes(self.tiles[k][1])]
        for keys, specs in ((whole, [self.specs[k] for k in whole]),
                            (kept, [self.tiles[k][1] for k in kept])):
            if keys:
                out.update(zip(keys, unshard_many([self[k] for k in keys], specs, self.mesh)))
        if not self.tiles:
            return out
        return ModelTiles(out, {k: t[0] for k, t in self.tiles.items()}, self.mesh)


class ModelTiles(dict):
    """Params of which the leaves named in ``tiles`` are the rank's "model"
    tiles, each with the spec of that tile ({name: spec}, e.g. ``P(None,
    "model")``: the output dim of a weight). :func:`column_products` and
    :func:`row_product` multiply by them tensor-parallel; everything else
    reads the leaves as plain tensors."""

    def __init__(self, leaves: dict, tiles: dict, mesh):
        super().__init__(leaves)
        self.tiles, self.mesh = tiles, mesh


def layer_params(stack: dict, i: int) -> dict:
    """Layer ``i``'s params from a dict of leaves stacked along a leading
    layer axis (the JAX package scans over that axis). Under a mesh step
    whose tiles of the stack are sharded: a :class:`ShardedLayer` of their
    slices, gathered where the layer runs (its gradient reduce-scatters
    back to the rank's tiles); a serving step, which takes no gradient,
    gathers them here. The leaves registered as "model" tiles stay tiles
    (the experts; in a serving decode step the product weights too)."""
    from repro_torch.runtime.sharding import current_rules

    rules = current_rules()
    out = {k: v[i] for k, v in stack.items()}
    reg = {} if rules is None else {
        k: rules.stacked[id(v)] for k, v in stack.items() if id(v) in rules.stacked}
    if not reg:
        return out
    layer = ShardedLayer(out, {k: spec for k, (spec, _) in reg.items()}, rules.mesh,
                         {k: t for k, (_, t) in reg.items() if t})
    return layer if rules.kind == "train" else layer.gather()


# ---------------------------------------------------------------------------
# tensor-parallel products (a serving decode step's "model" tiles)
# ---------------------------------------------------------------------------


def _split_dim(p: dict, name: str) -> int | None:
    """The dim of ``p[name]`` that "model" splits where ``p`` holds it as
    the rank's tile (0: the input dim, 1: the output dim), else None."""
    spec = getattr(p, "tiles", {}).get(name)
    return None if spec is None else len(spec) - 1


def row_parallel(p: dict, name: str) -> bool:
    """Whether ``p[name]`` is the rank's tile of its input dim."""
    return _split_dim(p, name) == 0


def column_products(p: dict, pairs: list, cd: torch.dtype, *, gather: bool = True) -> list:
    """``[x @ p[name] for name, x in pairs]`` in the compute dtype ``cd``.
    Where ``p[name]`` is the rank's tile of its output dim (column-parallel),
    the product is the rank's slice of the output: all-gathered over
    "model" along the last dim (one collective for every such product of
    the call: the narrow activations, never a weight), or with ``gather``
    False left as the slice (the next product is row-parallel)."""
    outs = [x.to(cd) @ p[name].to(cd) for name, x in pairs]
    cols = [i for i, (name, _) in enumerate(pairs) if _split_dim(p, name) == 1]
    if gather and cols:
        g = _gathered_slices(torch.cat([outs[i] for i in cols], dim=-1), p.mesh)
        off = 0
        for i in cols:
            w = outs[i].shape[-1]
            outs[i] = g[..., off:off + w].reshape(*outs[i].shape[:-1], -1)
            off += w
    return outs


def _gathered_slices(x: torch.Tensor, mesh) -> torch.Tensor:
    """(..., w) -> (..., n_model, w): every "model" rank's ``x``, in rank
    order (the tiles of an output dim side by side)."""
    from repro_torch.runtime.collectives import all_gather_stack

    return all_gather_stack(x, mesh, "model").movedim(0, -2)


def _rank_slice(x: torch.Tensor, width: int, mesh) -> torch.Tensor:
    """The rank's slice of ``x``'s last dim, ``width`` wide: the part of a
    whole input that its "model" tile of an input dim multiplies."""
    j = mesh.axis_index("model")
    return x[..., j * width:(j + 1) * width]


def column_product(p: dict, name: str, x: torch.Tensor, cd: torch.dtype, *,
                   gather: bool = True) -> torch.Tensor:
    """One :func:`column_products` product."""
    return column_products(p, [(name, x)], cd, gather=gather)[0]


def row_product(p: dict, name: str, x: torch.Tensor, cd: torch.dtype, *,
                reduce: bool = True) -> torch.Tensor:
    """``x @ p[name]`` in the compute dtype ``cd``. Where ``p[name]`` is the
    rank's tile of its input dim (row-parallel): the rank's slice of ``x``'s
    last dim (``x`` whole, or already that slice: a column-parallel output
    left ungathered), the local product in f32 (the compute dtype's values,
    accumulated in f32), summed over "model" and cast once, so a bf16 step
    rounds once as the one-device product does; with ``reduce`` False the
    f32 partial product, for a caller that folds it into a sum of its own."""
    w = p[name]
    if not row_parallel(p, name):
        return x.to(cd) @ w.to(cd)
    if x.shape[-1] != w.shape[0]:
        x = _rank_slice(x, w.shape[0], p.mesh)
    part = x.to(cd).to(torch.float32) @ w.to(cd).to(torch.float32)
    if not reduce:
        return part
    from repro_torch.runtime.collectives import psum

    return psum(part, p.mesh, "model").to(cd)


def spec_struct(specs: SpecTree) -> Any:
    return tree_map(lambda s: s.struct(), specs)


def spec_axes(specs: SpecTree) -> Any:
    return tree_map(lambda s: s.axes, specs)


def init_params(specs: SpecTree, generator: torch.Generator) -> Any:
    return tree_map(lambda s: s.initialize(generator), specs)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def group_norm(x: torch.Tensor, n_groups: int, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim split into ``n_groups`` (the RWKV6 WKV
    output), in f32, returned in ``x``'s dtype."""
    dt = x.dtype
    *lead, d = x.shape
    g = x.to(torch.float32).reshape(*lead, n_groups, d // n_groups)
    mu = g.mean(dim=-1, keepdim=True)
    var = ((g - mu) ** 2).mean(dim=-1, keepdim=True)
    g = (g - mu) * torch.rsqrt(var + eps)
    x = g.reshape(*lead, d)
    return (x * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the largest value along ``dim``, the first one on ties (as
    ``jnp.argmax``), spelled out so no device's tie rule is relied on."""
    top = x.max(dim=dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.ndim
    shape[dim] = -1
    idx = idx.view(shape).expand_as(x)
    return torch.where(x == top, idx, x.shape[dim]).min(dim=dim).values


# ---------------------------------------------------------------------------
# rotary position embeddings (GPT-NeoX half-rotation convention)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rope_pct: float = 1.0,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Inverse frequencies for the rotated fraction of the head dim."""
    rot = int(head_dim * rope_pct) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """``x``: (..., seq, heads, head_dim); ``positions``: broadcastable
    (..., seq). Angles and the rotation in f32, returned in ``x``'s dtype."""
    dt = x.dtype
    hd = x.shape[-1]
    rot = int(hd * rope_pct) // 2 * 2
    inv = rope_frequencies(hd, theta, rope_pct, x.device)  # (rot/2,)
    ang = positions[..., :, None, None].to(torch.float32) * inv  # (..., seq, 1, rot/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr, xp = x[..., :rot].to(torch.float32), x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)
    return torch.cat([rotated, xp], dim=-1) if rot < hd else rotated


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows for ``tokens`` (any shape of int ids); vocab-parallel
    (``runtime/losses.py``) under a mesh step with a "model" axis, where
    ``embed`` is the rank's vocab slice (or, where "model" does not divide
    the vocab, the whole table: the first rank's slice then holds every
    token): the sequence-sharded form in train and prefill steps, the
    ``psum`` form in a decode step, whose tokens every "model" rank holds
    alike."""
    from repro_torch.runtime.sharding import current_rules

    rules = current_rules()
    if rules is not None and rules.n_model > 1 and tokens.ndim == 2:
        from repro_torch.runtime.losses import vocab_parallel_embed, vocab_parallel_lookup

        if rules.kind == "decode":
            return vocab_parallel_lookup(tokens, embed, rules)
        return vocab_parallel_embed(tokens, embed, rules)
    return embed[tokens]


def vocab_logits(x: torch.Tensor, head: torch.Tensor, vocab: int) -> torch.Tensor:
    """(..., ``vocab``) f32 logits: an f32 product with the head (d, V).
    Under a serving mesh step the head is the rank's vocab tile (d, V /
    n_model): the tile's logits, all-gathered over "model"."""
    logits = x.to(torch.float32) @ head.to(torch.float32)
    if head.shape[-1] == vocab:
        return logits
    from repro_torch.runtime.collectives import all_gather
    from repro_torch.runtime.sharding import current_rules

    return all_gather(logits, current_rules().mesh, "model", dim=-1)


def cache_segment(length: int, axes_of: int | None = None) -> tuple[int, int, tuple]:
    """(start, size, axes) of this rank's segment of a K/V cache ``length``
    long: its tile along the sequence under a serving mesh step (the
    "cache_seq" axes of the rules, ``axes``; with ``axes_of``, those of a
    cache that long: an enc-dec memory tiles as its self-attention cache),
    the whole cache otherwise (``(0, length, ())``)."""
    from repro_torch.runtime.sharding import current_rules

    rules = current_rules()
    if rules is None or rules.kind == "train":
        return 0, length, ()
    axes = rules.cache_seq_axes(length if axes_of is None else axes_of)
    if not axes:
        return 0, length, ()
    n = rules.mesh.axis_size(axes)
    if length % n:
        raise ValueError(f"a cache of {length} positions does not split over {axes} ({n})")
    size = length // n
    return rules.mesh.axis_index(axes) * size, size, axes


def decode_segment() -> tuple[int, tuple]:
    """(start, axes) of this rank's K/V cache tile in a decode step: under
    a mesh step the global cache length is the rules' ``cache_len``."""
    from repro_torch.runtime.sharding import current_rules

    rules = current_rules()
    if rules is None or rules.cache_len is None:
        return 0, ()
    start, _, axes = cache_segment(rules.cache_len)
    return start, axes


def write_prompt_cache(cache: torch.Tensor, kv: torch.Tensor, start: int) -> None:
    """Write the prompt's K or V ``kv`` (B, S, KV, hd), the whole sequence,
    into a cache tile (B, C, KV, hd) that starts at global position
    ``start``: the positions of [start, start + C) the prompt holds."""
    n = max(0, min(cache.shape[1], kv.shape[1] - start))
    if n:
        cache[:, :n] = kv[:, start:start + n]


def last_shard(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the last "model" rank holds it, on every rank, under a mesh
    step that shards the sequence (a prompt's last row, a recurrent state
    after the last shard); ``x`` as is otherwise."""
    from repro_torch.runtime.sharding import model_parallel

    rules = model_parallel()
    if rules is None:
        return x
    from repro_torch.runtime.collectives import psum

    last = rules.mesh.axis_index("model") == rules.n_model - 1
    return psum(x * (1.0 if last else 0.0), rules.mesh, "model")


def prev_row(x: torch.Tensor) -> torch.Tensor:
    """(B, d): the row before a (B, T, d) sequence's first one. Zeros; on a
    sequence shard of a mesh step, the previous shard's last row (by
    ``ppermute``, zeros on the first shard): the token shift's state."""
    from repro_torch.runtime.sharding import model_parallel

    rules = model_parallel()
    if rules is None:
        return torch.zeros_like(x[:, 0])
    from repro_torch.runtime.collectives import ppermute

    halo = ppermute(x[:, -1].contiguous(), rules.mesh, "model", shift=1)
    return halo * (0.0 if rules.mesh.axis_index("model") == 0 else 1.0)


def seq_shards() -> int:
    """How many shards the sequence is cut into: the "model" ranks under a
    mesh step that shards it, else 1."""
    from repro_torch.runtime.sharding import model_parallel

    rules = model_parallel()
    return 1 if rules is None else rules.n_model


def seq_positions(B: int, S: int, device) -> torch.Tensor:
    """(B, S) positions of a batch's local rows: 0..S-1, offset by the
    shard's start under a mesh step that shards the sequence."""
    from repro_torch.runtime.sharding import model_parallel

    rules = model_parallel()
    start = 0 if rules is None else rules.mesh.axis_index("model") * S
    return torch.arange(start, start + S, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def chunked_cross_entropy(x: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, *, vocab_size: int,
                          chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE without materializing full (B, S, V) logits.

    ``x``: (B, S, D) final hidden states; ``embedding``: (V_pad, D) output
    head; ``targets``: (B, S) int; ``mask``: (B, S) {0, 1}. Loops over
    sequence chunks (the largest divisor of S up to ``chunk``), so the
    logits of one chunk, (B, chunk, V_pad), are the most held at once. As
    the JAX package, the product runs in ``x``'s dtype (the compute dtype:
    ``x @ emb.T.astype(x.dtype)``) and is cast to f32 after it; the serving
    logits are an f32 product instead. Returns (sum_loss, sum_mask), f32.

    Under a mesh step: the vocab-parallel form (``runtime/losses.py``) with
    a "model" axis, as the reference; otherwise the local rows' sums,
    summed over the batch axes, so every rank holds the global pair.
    """
    from repro_torch.runtime.sharding import current_rules

    rules = current_rules()
    if rules is not None and rules.n_model > 1:
        from repro_torch.runtime.losses import vocab_parallel_cross_entropy

        return vocab_parallel_cross_entropy(x, embedding, targets, mask.to(torch.float32), rules,
                                            chunk=chunk)
    B, S, D = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    emb = embedding.T.to(x.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xc, tc, mc = x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        logits = (xc @ emb).to(torch.float32)  # (B, c, V_pad)
        # padded vocab entries never appear as targets; the logsumexp over
        # the padded tail is harmless (their logits train toward -inf)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tc[..., None].to(torch.long))[..., 0]
        nll = (lse - picked) * mc
        tot = tot + nll.sum()
        cnt = cnt + mc.sum()
    if rules is not None and rules.batch_axes:
        from repro_torch.runtime.collectives import psum

        tot = psum(tot, rules.mesh, rules.batch_axes)
        cnt = psum(cnt.detach(), rules.mesh, rules.batch_axes)
    return tot, cnt


def shift_targets(tokens: torch.Tensor,
                  mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard LM shift: predict token t+1 at position t. Returns the
    targets (the last one 0) and an f32 mask that drops the last position.
    On a sequence shard of a mesh step, a shard's last target is the next
    shard's first token, and only the last shard drops its last position."""
    from repro_torch.runtime.sharding import model_parallel

    rules = model_parallel()
    last = torch.zeros_like(tokens[:, :1])
    drop_last = True
    if rules is not None:
        from repro_torch.runtime.collectives import ppermute

        last = ppermute(tokens[:, :1].contiguous(), rules.mesh, "model", shift=-1)
        drop_last = rules.mesh.axis_index("model") == rules.n_model - 1
    targets = torch.cat([tokens[:, 1:], last], dim=1)
    m = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    if mask is not None:
        m = m * mask.to(torch.float32)
    if drop_last:
        m[:, -1] = 0.0
    return targets, m
