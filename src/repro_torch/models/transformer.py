"""Decoder-only transformer LM, dense family.

Layers are stacked along a leading "layers" axis, as in the JAX package;
its ``lax.scan`` over that axis becomes a Python loop here. The residual
stream is in the compute dtype (bf16 at full width: the embedding is cast
to it, and ``x + a`` / ``x + m`` add in it); norms run in f32; the logits
are an f32 product with the f32 head. PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` keeps that product in
full f32 on the card; the port never changes the flag.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn
from repro_torch.models.base import BaseModel
from repro_torch.models.common import ParamSpec, apply_rope, embed_lookup, rms_norm

# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def attn_block_specs(cfg: ArchConfig, n_layers: int | None, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lead = () if n_layers is None else (n_layers,)
    specs = {
        "wqkv": ParamSpec(lead + (d, (H + 2 * KV) * hd), dtype),
        "wo": ParamSpec(lead + (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(lead + (hd,), torch.float32, init="ones")
        specs["k_norm"] = ParamSpec(lead + (hd,), torch.float32, init="ones")
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
    """Full-sequence attention (prefill). Returns (out, (k, v))."""
    cd = compute_dtype
    qkv = x.to(cd) @ p["wqkv"].to(cd)
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, p, q, k)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    out = attn_lib.blockwise_attention(q, k, v, causal=causal)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"].to(cd), (k, v)


def attn_block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, *, positions: torch.Tensor,
                      compute_dtype: torch.dtype):
    """Single-token attention against the cache, ``x``: (B,1,d). Writes the
    new K/V entry into the caches in place; returns (out, (k_cache, v_cache))."""
    cd = compute_dtype
    qkv = x.to(cd) @ p["wqkv"].to(cd)
    q, k, v = _split_qkv(cfg, qkv)
    q, k = _qk_norm(cfg, p, q, k)
    pos = positions[:, None]  # (B, 1)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_pct)
    attn_lib.update_cache(k_cache, k, positions)
    attn_lib.update_cache(v_cache, v, positions)
    out = attn_lib.decode_attention(q, k_cache, v_cache, positions=positions)
    return out.reshape(x.shape[0], 1, -1) @ p["wo"].to(cd), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# decoder-only LM
# ---------------------------------------------------------------------------


class DecoderLM(BaseModel):
    """Dense decoder-only language model."""

    SUPPORTS_PAGED = True

    #: layer weights the model multiplies in the compute dtype
    MATMUL_WEIGHTS = ("wqkv", "wo", "w_up", "w_gate", "w_down")

    # ---- specs -----------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        L, d, dt = cfg.n_layers, cfg.d_model, self.param_dtype
        layers: dict[str, Any] = {
            "attn_norm": ParamSpec((L, d), torch.float32, init="ones"),
            "mlp_norm": ParamSpec((L, d), torch.float32, init="ones"),
            **attn_block_specs(cfg, L, dt),
            **ffn.mlp_specs(d, cfg.d_ff, L, dt, gated=cfg.gated_mlp),
        }
        specs = {
            "embed": ParamSpec((cfg.padded_vocab, d), dt, init="normal"),
            "final_norm": ParamSpec((d,), torch.float32, init="ones"),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((d, cfg.padded_vocab), dt)
        return specs

    def compute_params(self, params: dict) -> dict:
        """``params`` with the layer matmul weights cast to the compute
        dtype, once. The JAX package casts them inside every product
        (``x.astype(cd) @ w.astype(cd)``); eagerly that would re-cast the
        f32 weights on every layer of every step, and casting at load gives
        the same values. Norms, the embedding and the head stay as stored
        (f32 at full width)."""
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
        return x.to(torch.float32) @ self._head(params).T.to(torch.float32)

    @staticmethod
    def _layer(params: dict, i: int) -> dict:
        return {k: v[i] for k, v in params["layers"].items()}

    # ---- forward ---------------------------------------------------------

    def _forward(self, params: dict, tokens: torch.Tensor, cache_len: int | None = None):
        """Hidden states after the final norm, (B, S, d), and the prompt's
        cache {"k", "v"} (L, B, cache_len or S, KV, hd) in the compute
        dtype; positions past S are zeros."""
        cfg, cd = self.cfg, self.compute_dtype
        B, S = tokens.shape
        dev = tokens.device
        x = embed_lookup(params["embed"], tokens).to(cd)
        positions = torch.arange(S, device=dev).expand(B, S)
        shape = (cfg.n_layers, B, cache_len or S, cfg.n_kv_heads, cfg.resolved_head_dim)
        alloc = torch.zeros if cache_len else torch.empty
        cache = {"k": alloc(shape, dtype=cd, device=dev), "v": alloc(shape, dtype=cd, device=dev)}
        for i in range(cfg.n_layers):
            lp = self._layer(params, i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            a, (k, v) = attn_block_apply(cfg, lp, h, positions=positions, compute_dtype=cd)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            x = x + a
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + ffn.mlp_apply(lp, h, cd)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), cache

    # ---- public API ------------------------------------------------------

    def prefill(self, params: dict, batch: dict, *, cache_len: int | None = None):
        """``batch["tokens"]`` (B, S) -> (logits (B, 1, V_pad) f32 of the
        last token — of ``batch["last_pos"]`` when given, for prompts
        right-padded to a bucket — and the cache). ``cache_len`` allocates
        the cache that long (zeros past S), for decoding in place."""
        tokens = batch["tokens"]
        x, cache = self._forward(params, tokens, cache_len)
        last = batch.get("last_pos")
        if last is None:
            xs = x[:, -1:]
        else:
            xs = x[torch.arange(x.shape[0], device=x.device), last.to(torch.long)][:, None]
        return self._logits(params, xs), cache

    def decode(self, params: dict, cache: dict, batch: dict):
        """One step: ``tokens`` (B, 1), ``positions`` (B,) write index per
        row. Writes the new entries into ``cache`` in place (the JAX version
        returns a new cache); returns (logits (B, 1, V_pad) f32, cache)."""
        cfg, cd = self.cfg, self.compute_dtype
        tokens, positions = batch["tokens"], batch["positions"]
        x = embed_lookup(params["embed"], tokens).to(cd)  # (B, 1, d)
        for i in range(cfg.n_layers):
            lp = self._layer(params, i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            a, _ = attn_block_decode(cfg, lp, h, cache["k"][i], cache["v"][i],
                                     positions=positions, compute_dtype=cd)
            x = x + a
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + ffn.mlp_apply(lp, h, cd)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def cache_struct(self, shape: ShapeConfig) -> dict:
        """The decode cache of the JAX package's dry-run shapes, bf16, as
        ``meta`` tensors. (The serving path sizes its pools from the
        compute dtype instead: that is what prefill writes.)"""
        cfg = self.cfg
        kv = torch.empty((cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv_heads,
                          cfg.resolved_head_dim), dtype=torch.bfloat16, device="meta")
        return {"k": kv, "v": kv}
