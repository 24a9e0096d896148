"""Decoder-only transformer LM: the dense, MoE and VLM (stub frontend)
families. The attention block is shared with the enc-dec and hybrid
families (``models/encdec.py``, ``models/zamba.py``).

Layers are stacked along a leading "layers" axis, as in the JAX package;
its ``lax.scan`` over that axis becomes a Python loop here. The residual
stream is in the compute dtype (bf16 at full width: the embedding is cast
to it, and ``x + a`` / ``x + m`` add in it); norms run in f32; the logits
are an f32 product with the f32 head. PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` keeps that product in
full f32 on the card; the port never changes the flag.

Training (:meth:`DecoderLM.loss`) runs on the stored (f32) master weights,
each cast to the compute dtype inside its product as the JAX package does,
so the gradients reach the f32 leaves; ``cfg.remat`` wraps each layer in
``torch.utils.checkpoint`` ("full": everything recomputed in the backward,
"dots": the matmul outputs kept, through selective activation
checkpointing) as the JAX package's ``jax.checkpoint`` policies do. The
loss's logits run in the compute dtype (``chunked_cross_entropy``), as the
JAX package's do. A MoE layer's FFN is ``models/moe.py``'s ``moe_apply``;
its load-balance loss enters the training loss as the JAX package adds it.
A VLM (``cfg.frontend == "vision"``) prepends ``batch["patch_embeds"] @
vision_proj`` to the token embeddings: the anyres vision tower is a stub,
as in the JAX package, and positions, the cache and ``last_pos`` count the
patches. On a mesh step a rank's sequence shard is a slice of the whole
[patches; text] sequence (:meth:`DecoderLM.local_batch`): a rank may hold
only patches, and the loss's targets shift over the whole sequence with
the patch positions masked, so the loss is the global token sum over the
global count as on one device; a MoE layer groups the global token list
(``models/moe.py``).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn, moe
from repro_torch.models.base import BaseModel, _row_block, _seq_block
from repro_torch.models.common import (
    ParamSpec,
    ShardedLayer,
    apply_rope,
    cache_segment,
    chunked_cross_entropy,
    column_product,
    decode_segment,
    embed_lookup,
    last_shard,
    layer_params,
    rms_norm,
    row_product,
    seq_positions,
    seq_shards,
    shift_targets,
    tree_leaves,
    vocab_logits,
    write_prompt_cache,
)

#: the ops whose outputs ``remat="dots"`` keeps (``checkpoint_dots``)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default]


def remat_apply(remat: str, fn, *args):
    """``fn(*args)`` under ``cfg.remat``'s policy: "none" runs it as is,
    "full" recomputes everything in the backward, "dots" keeps the matmul
    outputs (selective activation checkpointing), as the JAX package's
    ``jax.checkpoint`` policies. Where no gradient is taken (no argument
    requires one, or grad mode is off: serving), every policy runs ``fn``
    as is, as ``jax.checkpoint`` does outside differentiation; the first
    ``checkpoint`` call of a process imports ``torch._dynamo`` (seconds).
    A :class:`~repro_torch.models.common.ShardedLayer` argument (a mesh
    step's layer tiles) is gathered inside ``fn``: under "full" the layer's
    full weights are freed after its forward and gathered again for its
    backward."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    if any(isinstance(a, ShardedLayer) for a in args):  # a mesh step: gather in the layer
        inner = fn
        fn = lambda *a: inner(*(x.gather() if isinstance(x, ShardedLayer) else x  # noqa: E731
                                for x in a))
    needs_grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for a in args for t in tree_leaves(a))
    if remat == "none" or not needs_grad:
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _DOTS))


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def attn_block_specs(cfg: ArchConfig, n_layers: int | None, dtype: torch.dtype,
                     d_in: int | None = None) -> dict:
    """The attention block's params; ``d_in`` is its input width (Zamba's
    shared block reads ``concat(x, x0)``, 2 d wide), the model width by
    default. The output is d_model wide either way."""
    d = d_in or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lead = () if n_layers is None else (n_layers,)
    lax_ = () if n_layers is None else ("layers",)
    specs = {
        "wqkv": ParamSpec(lead + (d, (H + 2 * KV) * hd), dtype, axes=lax_ + ("embed", "qkv")),
        "wo": ParamSpec(lead + (H * hd, cfg.d_model), dtype, axes=lax_ + ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(lead + (hd,), torch.float32, init="ones", axes=lax_ + (None,))
        specs["k_norm"] = ParamSpec(lead + (hd,), torch.float32, init="ones", axes=lax_ + (None,))
    return specs


def _split_qkv(cfg: ArchConfig, qkv: torch.Tensor):
    B, S = qkv.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    return q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)


def _qk_norm(cfg: ArchConfig, p: dict, q: torch.Tensor, k: torch.Tensor):
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def attn_block_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *, positions: torch.Tensor,
                     compute_dtype: torch.dtype, causal: bool = True):
    """Full-sequence attention (prefill). Returns (out, (k, v)), k and v the
    whole sequence's of the local rows (on a sequence shard, the ones the
    sharded attention gathered)."""
    cd = compute_dtype
    qkv = x.to(cd) @ p["wqkv"].to(cd)
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, p, q, k)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    out, k, v = attn_lib.attention(q, k, v, impl=cfg.attention_impl, causal=causal,
                                   block_q=cfg.attention_block_q,
                                   block_kv=cfg.attention_block_kv, with_kv=True)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"].to(cd), (k, v)


def attn_block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, *, positions: torch.Tensor,
                      compute_dtype: torch.dtype):
    """Single-token attention against the cache, ``x``: (B,1,d). Writes the
    new K/V entry into the caches in place; returns (out, (k_cache, v_cache)).
    Under a serving mesh step the caches are the rank's ``cache_seq`` tiles:
    only the rank whose tile holds a row's position writes its entry, and
    the tiles' partial attentions merge over the cache axes
    (``runtime/sharded_attention.py`` ``sharded_decode_attention``). With
    ``p``'s weights the rank's "model" tiles (tensor-parallel serving) the
    QKV product is column-parallel, its tiles of the fused [q | k | v]
    columns all-gathered before the split, so the heads and the cache are
    whole on every "model" rank, and the output product row-parallel."""
    cd = compute_dtype
    qkv = column_product(p, "wqkv", x, cd)
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, p, q, k)
    pos = positions[:, None]  # (B, 1)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_pct)
    start, axes = decode_segment()
    attn_lib.update_cache(k_cache, k, positions, start)
    attn_lib.update_cache(v_cache, v, positions, start)
    if axes:
        from repro_torch.runtime.sharded_attention import sharded_decode_attention
        from repro_torch.runtime.sharding import current_rules

        out = sharded_decode_attention(q, k_cache, v_cache, positions, current_rules().mesh,
                                       start=start, axes=axes)
    else:
        out = attn_lib.decode_attention(q, k_cache, v_cache, positions=positions)
    return row_product(p, "wo", out.reshape(x.shape[0], 1, -1), cd), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# decoder-only LM
# ---------------------------------------------------------------------------


def _behind(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T) -> (B, n + T): ``x`` behind n zeros (a VLM shard's patch
    positions)."""
    if not n:
        return x
    return torch.cat([x.new_zeros((x.shape[0], n)), x], dim=1)


class DecoderLM(BaseModel):
    """Dense / MoE / VLM decoder-only language model."""

    SUPPORTS_PAGED = True

    #: layer weights the model multiplies in the compute dtype (a MoE
    #: layer's experts share the dense names; its router is multiplied in the
    #: compute dtype too, but is kept f32 as stored, as the reference keeps it)
    MATMUL_WEIGHTS = ("wqkv", "wo", "w_up", "w_gate", "w_down", "shared_gate", "shared_up",
                      "shared_down")

    @property
    def is_moe(self) -> bool:
        return bool(self.cfg.n_experts)

    @property
    def is_vlm(self) -> bool:
        return self.cfg.frontend == "vision"

    # ---- specs -----------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        L, d, dt = cfg.n_layers, cfg.d_model, self.param_dtype
        layers: dict[str, Any] = {
            "attn_norm": ParamSpec((L, d), torch.float32, init="ones", axes=("layers", "embed")),
            "mlp_norm": ParamSpec((L, d), torch.float32, init="ones", axes=("layers", "embed")),
            **attn_block_specs(cfg, L, dt),
        }
        if self.is_moe:
            layers.update(moe.moe_specs(cfg, L, dt))
        else:
            layers.update(ffn.mlp_specs(d, cfg.d_ff, L, dt, gated=cfg.gated_mlp))
        specs = {
            "embed": ParamSpec((cfg.padded_vocab, d), dt, init="normal", axes=("vocab", "embed")),
            "final_norm": ParamSpec((d,), torch.float32, init="ones", axes=("embed",)),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((d, cfg.padded_vocab), dt, axes=("embed", "vocab"))
        if self.is_vlm:
            specs["vision_proj"] = ParamSpec((d, d), dt, axes=("embed", None))
        return specs

    def expert_param_count(self) -> int:
        if not self.is_moe:
            return 0
        cfg = self.cfg
        return cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff

    def compute_params(self, params: dict) -> dict:
        """``params`` with the layer matmul weights cast to the compute
        dtype, once, for serving. The JAX package casts them inside every
        product (``x.astype(cd) @ w.astype(cd)``); eagerly that would re-cast
        the f32 weights on every layer of every step, and casting at load
        gives the same values. Norms, the embedding and the head stay as
        stored (f32 at full width). Training does not use it: its gradients
        must reach the stored leaves."""
        cd = self.compute_dtype
        layers = {k: (v.to(cd) if k in self.MATMUL_WEIGHTS else v)
                  for k, v in params["layers"].items()}
        return {**params, "layers": layers}

    def _head(self, params: dict) -> torch.Tensor:
        """(V_pad, d) output projection."""
        if self.cfg.tie_embeddings:
            return params["embed"]
        return params["lm_head"].T

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return vocab_logits(x, self._head(params).T, self.cfg.padded_vocab)

    # ---- forward ---------------------------------------------------------

    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """(B, S, d) in the compute dtype: the token embeddings, behind the
        projected patch embeddings (B, n_patches, d) for a VLM. On a
        sequence shard of a mesh step (:meth:`local_batch`) a VLM's shard is
        its patches then its text positions, either possibly empty: the
        tokens are embedded behind as many placeholders as it holds patches
        (every "model" rank embeds S_l positions, as the vocab-parallel
        lookup gathers them), and the patches take the placeholders' rows."""
        cd = self.compute_dtype
        tokens = batch["tokens"]
        if not self.is_vlm:
            return embed_lookup(params["embed"], tokens).to(cd)
        patches = batch["patch_embeds"].to(cd) @ params["vision_proj"].to(cd)
        n_p = patches.shape[1] if seq_shards() > 1 else 0
        x = embed_lookup(params["embed"], _behind(tokens, n_p)).to(cd)
        return torch.cat([patches, x[:, n_p:]], dim=1)

    def _ffn(self, lp: dict, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The layer's FFN: (out, the MoE aux loss or None)."""
        if self.is_moe:
            return moe.moe_apply(lp, h, self.cfg, self.compute_dtype)
        return ffn.mlp_apply(lp, h, self.compute_dtype), None

    def _layer_apply(self, lp: dict, x: torch.Tensor, positions: torch.Tensor):
        """One layer: (new residual stream, (k, v) of its attention, the MoE
        aux loss or None)."""
        cfg, cd = self.cfg, self.compute_dtype
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        a, kv = attn_block_apply(cfg, lp, h, positions=positions, compute_dtype=cd)
        x = x + a
        m, aux = self._ffn(lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
        return x + m, kv, aux

    def _train_layer(self, x: torch.Tensor, lp: dict, positions: torch.Tensor):
        """One layer of the training forward, under ``cfg.remat``: (new
        residual stream, the MoE aux loss or None)."""
        fn = lambda x, lp: self._layer_apply(lp, x, positions)[::2]  # noqa: E731  (x, aux)
        return remat_apply(self.cfg.remat, fn, x, lp)

    def _forward(self, params: dict, batch: dict, cache_len: int | None = None):
        """Hidden states after the final norm, (B, S, d), and the prompt's
        cache {"k", "v"} (L, B, cache_len or S, KV, hd) in the compute
        dtype; positions past S are zeros. S counts a VLM's patches. Under
        a serving mesh step, S is the rank's sequence shard and the cache
        the rank's tile of the whole prompt's (``cache_segment``), cut from
        the K/V the sharded attention gathered."""
        cfg, cd = self.cfg, self.compute_dtype
        x = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        dev = x.device
        positions = seq_positions(B, S, dev)
        whole = S * seq_shards()
        if cache_len is not None and cache_len < whole:
            raise ValueError(f"cache_len {cache_len} is shorter than the prompt's {whole} "
                             f"positions")
        start, size, _ = cache_segment(cache_len or whole)
        shape = (cfg.n_layers, B, size, cfg.n_kv_heads, cfg.resolved_head_dim)
        alloc = torch.zeros if cache_len else torch.empty
        cache = {"k": alloc(shape, dtype=cd, device=dev), "v": alloc(shape, dtype=cd, device=dev)}
        for i in range(cfg.n_layers):
            x, (k, v), _ = self._layer_apply(layer_params(params["layers"], i), x, positions)
            write_prompt_cache(cache["k"][i], k, start)
            write_prompt_cache(cache["v"][i], v, start)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), cache

    # ---- public API ------------------------------------------------------

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy of ``batch["tokens"]`` (B, S) (and
        ``batch["mask"]`` where given) -> (loss, {"ce_loss", "tokens"}), f32
        scalars; a MoE model adds 0.01 times its aux loss (the layers' mean,
        also returned as "aux_loss"); a VLM's hidden states of its text
        start after its patches. ``params`` are the stored leaves (not
        ``compute_params``); the layer loop is a Python loop over the
        stacked (L, ...) leaves."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed_inputs(params, batch)
        B, S, _ = x.shape
        positions = seq_positions(B, S, tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(cfg.n_layers):
            x, layer_aux = self._train_layer(x, layer_params(params["layers"], i), positions)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        mask = batch.get("mask")
        if self.is_vlm and seq_shards() > 1:
            # a shard of [patches; text]: the targets shift over the whole
            # sequence and the patch positions (and the last) predict nothing
            n_p = S - tokens.shape[1]
            mask = _behind(torch.ones_like(tokens, dtype=torch.float32) if mask is None
                           else mask.to(torch.float32), n_p)
            tokens = _behind(tokens, n_p)
        elif self.is_vlm:  # text hidden states start at the patch offset
            x = x[:, S - tokens.shape[1]:]
        targets, mask = shift_targets(tokens, mask)
        tot, cnt = chunked_cross_entropy(x, self._head(params), targets, mask,
                                         vocab_size=cfg.vocab_size)
        loss = tot / torch.clamp(cnt, min=1.0)
        metrics = {"ce_loss": loss, "tokens": cnt}
        if self.is_moe:
            aux = aux / cfg.n_layers
            metrics["aux_loss"] = aux
            loss = loss + 0.01 * aux
        return loss, metrics

    def prefill(self, params: dict, batch: dict, *, cache_len: int | None = None):
        """``batch["tokens"]`` (B, T) (and a VLM's ``patch_embeds`` (B, P,
        d), S = P + T positions) -> (logits (B, 1, V_pad) f32 of the last
        position — of ``batch["last_pos"]`` when given, for prompts
        right-padded to a bucket — and the cache). ``cache_len`` allocates
        the cache that long (zeros past S; it counts a VLM's patches), for
        decoding in place. Under a serving mesh step (``runtime/steps.py``
        ``build_prefill_step``) the batch is the rank's rows and sequence
        shard, the logits its rows' and the cache its tile."""
        last = batch.get("last_pos")
        if last is not None and seq_shards() > 1:
            raise NotImplementedError("prefill with last_pos (the paged steps) does not run on "
                                      "a sequence-sharded mesh")
        x, cache = self._forward(params, batch, cache_len)
        if last is None:
            xs = last_shard(x[:, -1:])  # the last position: the last "model" rank's
        else:
            xs = x[torch.arange(x.shape[0], device=x.device), last.to(torch.long)][:, None]
        return self._logits(params, xs), cache

    def decode(self, params: dict, cache: dict, batch: dict):
        """One step: ``tokens`` (B, 1), ``positions`` (B,) write index per
        row. Writes the new entries into ``cache`` in place (the JAX version
        returns a new cache); returns (logits (B, 1, V_pad) f32, cache).
        Under a serving mesh step the rows are the rank's and the cache its
        ``cache_seq`` tile (``attn_block_decode``)."""
        cfg, cd = self.cfg, self.compute_dtype
        tokens, positions = batch["tokens"], batch["positions"]
        x = embed_lookup(params["embed"], tokens).to(cd)  # (B, 1, d)
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            a, _ = attn_block_decode(cfg, lp, h, cache["k"][i], cache["v"][i],
                                     positions=positions, compute_dtype=cd)
            x = x + a
            x = x + self._ffn(lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))[0]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def local_batch(self, batch: dict, rows: tuple[int, int],
                    shard: tuple[int, int] = (0, 1)) -> dict:
        """A VLM's sequence is [patches; text], S = P + T: the rank's shard
        is a slice of that concatenation, so its ``patch_embeds`` are the
        patches inside the shard and its ``tokens`` (and ``mask``) the text
        positions inside it, either possibly empty. Other models: the
        base's."""
        if not (self.is_vlm and "patch_embeds" in batch and shard[1] > 1):
            return super().local_batch(batch, rows, shard)
        P = batch["patch_embeds"].shape[1]
        S = P + batch["tokens"].shape[1]
        out = {}
        for k, x in batch.items():
            x = _row_block(k, x, rows)
            if x.ndim >= 2:  # the patches hold positions [0, P), the text [P, S)
                x = _seq_block(k, x, shard, 0 if k == "patch_embeds" else P, S)
            out[k] = x.contiguous()
        return out

    def input_specs(self, shape: ShapeConfig) -> dict:
        specs = super().input_specs(shape)
        if self.is_vlm and shape.kind != "decode":
            B, S, P = shape.global_batch, shape.seq_len, self.cfg.n_patches
            specs = {"tokens": torch.empty((B, S - P), dtype=torch.int32, device="meta"),
                     "patch_embeds": torch.empty((B, P, self.cfg.d_model), dtype=torch.bfloat16,
                                                 device="meta")}
        return specs

    def input_axes(self, shape: ShapeConfig) -> dict:
        axes = super().input_axes(shape)
        if self.is_vlm and shape.kind != "decode":
            axes["patch_embeds"] = ("batch", "seq", None)
        return axes

    def cache_struct(self, shape: ShapeConfig) -> dict:
        """The decode cache of the JAX package's dry-run shapes, bf16, as
        ``meta`` tensors. (The serving path sizes its pools from the
        compute dtype instead: that is what prefill writes.)"""
        cfg = self.cfg
        kv = torch.empty((cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv_heads,
                          cfg.resolved_head_dim), dtype=torch.bfloat16, device="meta")
        return {"k": kv, "v": kv}
