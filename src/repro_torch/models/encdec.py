"""Encoder-decoder transformer (the seamless-m4t backbone).

Own copy of the JAX package's ``models/encdec.py``. The speech frontend is
a stub: the encoder takes precomputed frame embeddings (B, S_enc, d)
through ``frame_proj``, then non-causal self-attention layers. The decoder
is a causal transformer with cross-attention into the encoder memory after
its self-attention; decode carries a self-attention KV cache, written in
place, and the static cross-attention cache (``k_mem``/``v_mem``) computed
once at prefill.

Attention follows the reference's dispatch: self-attention and the
prefill's cross-attention (S > 1) go through the flash wrapper
(``blockwise_attention``; non-causal, Sq != Skv for the cross-attention),
the one-token decode's cross-attention through the plain
:func:`~repro_torch.models.attention.naive_attention`, as the reference
runs it (``impl="naive"``). The layer loops are Python loops over the
stacked (L, ...) leaves.

On a mesh step the frames and the tokens are each sharded over "model"
(``BaseModel.local_batch``): the encoder's self-attention is the sharded
attention, non-causal; a decoder layer gathers the memory's K/V over
"model" once and attends its token shard to the whole memory. The prefill
writes the memory's K/V as tiles over the self-attention cache's
"cache_seq" axes, cut from the gathered memory as the self-attention
cache is; a decode step's cross-attention over such a tile is the decode
kernel with every row at the memory's last position, its partials merged
over those axes (``runtime/sharded_attention.py``
``sharded_decode_attention``), where one device runs the plain attention.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.base import BaseModel
from repro_torch.models.common import (
    ParamSpec,
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
    write_prompt_cache,
)
from repro_torch.models.ffn import mlp_apply, mlp_specs
from repro_torch.runtime.sharding import current_rules, model_parallel
from repro_torch.models.transformer import (
    attn_block_apply,
    attn_block_decode,
    attn_block_specs,
    remat_apply,
)


def _cross_attn_specs(cfg: ArchConfig, L: int, dtype: torch.dtype) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "xattn_norm": ParamSpec((L, d), torch.float32, init="ones", axes=("layers", "embed")),
        "wq_x": ParamSpec((L, d, H * hd), dtype, axes=("layers", "embed", "heads")),
        "wkv_x": ParamSpec((L, d, 2 * KV * hd), dtype, axes=("layers", "embed", "kv")),
        "wo_x": ParamSpec((L, H * hd, d), dtype, axes=("layers", "heads", "embed")),
    }


class EncDecLM(BaseModel):
    def param_specs(self) -> dict:
        cfg = self.cfg
        d, dt = cfg.d_model, self.param_dtype
        Le, Ld = cfg.n_enc_layers, cfg.n_layers
        enc_layers = {
            "attn_norm": ParamSpec((Le, d), torch.float32, init="ones", axes=("layers", "embed")),
            "mlp_norm": ParamSpec((Le, d), torch.float32, init="ones", axes=("layers", "embed")),
            **attn_block_specs(cfg, Le, dt),
            **mlp_specs(d, cfg.d_ff, Le, dt),
        }
        dec_layers = {
            "attn_norm": ParamSpec((Ld, d), torch.float32, init="ones", axes=("layers", "embed")),
            "mlp_norm": ParamSpec((Ld, d), torch.float32, init="ones", axes=("layers", "embed")),
            **attn_block_specs(cfg, Ld, dt),
            **_cross_attn_specs(cfg, Ld, dt),
            **mlp_specs(d, cfg.d_ff, Ld, dt),
        }
        return {
            "embed": ParamSpec((cfg.padded_vocab, d), dt, init="normal", axes=("vocab", "embed")),
            "frame_proj": ParamSpec((d, d), dt, axes=("embed", None)),
            "enc_final_norm": ParamSpec((d,), torch.float32, init="ones", axes=("embed",)),
            "final_norm": ParamSpec((d,), torch.float32, init="ones", axes=("embed",)),
            "lm_head": ParamSpec((d, cfg.padded_vocab), dt, axes=("embed", "vocab")),
            "encoder": enc_layers,
            "decoder": dec_layers,
        }

    # ---- encoder -----------------------------------------------------------

    def _encode(self, params: dict, frame_embeds: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.cfg, self.compute_dtype
        x = frame_embeds.to(cd) @ params["frame_proj"].to(cd)
        B, S, _ = x.shape
        positions = seq_positions(B, S, x.device)

        def layer(x, lp):
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            a, _ = attn_block_apply(cfg, lp, h, positions=positions, compute_dtype=cd,
                                    causal=False)
            x = x + a
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            return x + mlp_apply(lp, h, cd)

        # the reference remats the encoder layers fully under any remat policy
        remat = "none" if cfg.remat == "none" else "full"
        for i in range(cfg.n_enc_layers):
            x = remat_apply(remat, layer, x, layer_params(params["encoder"], i))
        return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    # ---- decoder -----------------------------------------------------------

    def _cross_kv(self, lp: dict, memory: torch.Tensor):
        """The memory's cross-attention K and V (B, S_enc, KV, hd); on a
        sequence shard of a mesh step, the whole memory's, gathered over
        "model" (one collective a layer; its backward reduce-scatters)."""
        cfg, cd = self.cfg, self.compute_dtype
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        kv = memory.to(cd) @ lp["wkv_x"].to(cd)
        B, S = memory.shape[:2]
        k, v = torch.chunk(kv, 2, dim=-1)
        k, v = k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)
        rules = model_parallel()
        if rules is None:
            return k, v
        from repro_torch.runtime.collectives import all_gather

        kv = all_gather(torch.stack([k, v]), rules.mesh, "model", dim=2)
        return kv[0], kv[1]

    def _cross_attend(self, lp: dict, x: torch.Tensor, k_mem: torch.Tensor,
                      v_mem: torch.Tensor) -> torch.Tensor:
        """``x``'s queries against the memory's K/V: the whole memory's, or
        under a decode mesh step the rank's tile of it (``k_mem`` (B, C,
        KV, hd) over the self-attention cache's "cache_seq" axes), whose
        partial attentions merge over those axes."""
        cfg, cd = self.cfg, self.compute_dtype
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        B, S = x.shape[:2]
        q = column_product(lp, "wq_x", x, cd).reshape(B, S, H, hd)
        rules = current_rules()
        axes = decode_segment()[1] if rules is not None and rules.kind == "decode" else ()
        if S > 1:
            out = attn_lib.blockwise_attention(q, k_mem, v_mem, causal=False)
        elif axes:
            from repro_torch.runtime.sharded_attention import sharded_decode_attention

            mesh = rules.mesh
            C = k_mem.shape[1]
            last = torch.full((B,), C * mesh.axis_size(axes) - 1, dtype=torch.int32,
                              device=q.device)  # every row sees the whole memory
            out = sharded_decode_attention(q, k_mem, v_mem, last, mesh,
                                           start=mesh.axis_index(axes) * C, axes=axes)
        else:
            out = attn_lib.naive_attention(q, k_mem, v_mem, causal=False)
        return row_product(lp, "wo_x", out.reshape(B, S, H * hd), cd)

    def _decoder_layer(self, lp: dict, x: torch.Tensor, memory: torch.Tensor,
                       positions: torch.Tensor):
        """One decoder layer over the whole sequence: (x, (k, v), (k_mem, v_mem))."""
        cfg, cd = self.cfg, self.compute_dtype
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        a, kv = attn_block_apply(cfg, lp, h, positions=positions, compute_dtype=cd)
        x = x + a
        h = rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
        k_mem, v_mem = self._cross_kv(lp, memory)
        x = x + self._cross_attend(lp, h, k_mem, v_mem)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + mlp_apply(lp, h, cd), kv, (k_mem, v_mem)

    def _embed_tokens(self, params: dict, tokens: torch.Tensor):
        x = embed_lookup(params["embed"], tokens).to(self.compute_dtype)
        B, S = tokens.shape
        return x, seq_positions(B, S, tokens.device)

    # ---- public API ----------------------------------------------------------

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy of ``batch["tokens"]`` (B, S) given
        ``batch["frame_embeds"]`` (B, S_enc, d) -> (loss, {"ce_loss",
        "tokens"}), f32 scalars. On a mesh step the frames and tokens are
        the rank's rows and shards (each over "model")."""
        cfg = self.cfg
        memory = self._encode(params, batch["frame_embeds"])
        tokens = batch["tokens"]
        x, positions = self._embed_tokens(params, tokens)
        remat = "none" if cfg.remat == "none" else "full"
        fn = lambda x, lp: self._decoder_layer(lp, x, memory, positions)[0]  # noqa: E731
        for i in range(cfg.n_layers):
            x = remat_apply(remat, fn, x, layer_params(params["decoder"], i))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        targets, mask = shift_targets(tokens, batch.get("mask"))
        tot, cnt = chunked_cross_entropy(x, params["lm_head"].T, targets, mask,
                                         vocab_size=cfg.vocab_size)
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss, {"ce_loss": loss, "tokens": cnt}

    def prefill(self, params: dict, batch: dict, *, cache_len: int | None = None):
        """``batch["frame_embeds"]`` (B, S_enc, d) and ``batch["tokens"]``
        (B, S) -> (logits (B, 1, V_pad) f32 of the last token, cache
        {"k", "v"} (L, B, cache_len or S, KV, hd), zeros past S, and
        {"k_mem", "v_mem"} (L, B, S_enc, KV, hd), all in the compute dtype).
        Under a serving mesh step the frames and tokens are the rank's rows
        and shards, the logits its rows', and every cache leaf its tile over
        the self-attention cache's "cache_seq" axes (the memory's too),
        cut from the gathered K/V."""
        cfg, cd = self.cfg, self.compute_dtype
        memory = self._encode(params, batch["frame_embeds"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        whole = S * seq_shards()
        if cache_len is not None and cache_len < whole:
            raise ValueError(f"cache_len {cache_len} is shorter than the prompt's {whole} tokens")
        x, positions = self._embed_tokens(params, tokens)
        dev, KV, hd = x.device, cfg.n_kv_heads, cfg.resolved_head_dim
        start, size, _ = cache_segment(cache_len or whole)
        m_start, m_size, _ = cache_segment(memory.shape[1] * seq_shards(),
                                           axes_of=cache_len or whole)
        alloc = torch.zeros if cache_len else torch.empty
        shape = (cfg.n_layers, B, size, KV, hd)
        mem_shape = (cfg.n_layers, B, m_size, KV, hd)
        cache = {"k": alloc(shape, dtype=cd, device=dev), "v": alloc(shape, dtype=cd, device=dev),
                 "k_mem": torch.empty(mem_shape, dtype=cd, device=dev),
                 "v_mem": torch.empty(mem_shape, dtype=cd, device=dev)}
        for i in range(cfg.n_layers):
            x, (k, v), (k_mem, v_mem) = self._decoder_layer(
                layer_params(params["decoder"], i), x, memory, positions)
            write_prompt_cache(cache["k"][i], k, start)
            write_prompt_cache(cache["v"][i], v, start)
            write_prompt_cache(cache["k_mem"][i], k_mem, m_start)
            write_prompt_cache(cache["v_mem"][i], v_mem, m_start)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, last_shard(x[:, -1:])), cache

    def decode(self, params: dict, cache: dict, batch: dict):
        """One step: ``tokens`` (B, 1), ``positions`` (B,) write index per
        row. Writes the new self-attention entries into ``cache`` in place
        and reads the cross-attention memory; returns (logits (B, 1, V_pad)
        f32, cache). Under a serving mesh step the rows are the rank's and
        every cache leaf its tile."""
        cfg, cd = self.cfg, self.compute_dtype
        positions = batch["positions"]
        x = embed_lookup(params["embed"], batch["tokens"]).to(cd)
        for i in range(cfg.n_layers):
            lp = layer_params(params["decoder"], i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            a, _ = attn_block_decode(cfg, lp, h, cache["k"][i], cache["v"][i],
                                     positions=positions, compute_dtype=cd)
            x = x + a
            h = rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
            x = x + self._cross_attend(lp, h, cache["k_mem"][i], cache["v_mem"][i])
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + mlp_apply(lp, h, cd)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def cache_struct(self, shape: ShapeConfig) -> dict:
        """The JAX package's dry-run cache, bf16 ``meta`` tensors: the
        sequence budget split half encoder frames, half decoder tokens."""
        cfg = self.cfg
        kv = torch.empty((cfg.n_layers, shape.global_batch, shape.seq_len // 2, cfg.n_kv_heads,
                          cfg.resolved_head_dim), dtype=torch.bfloat16, device="meta")
        return {"k": kv, "v": kv, "k_mem": kv, "v_mem": kv}

    def input_specs(self, shape: ShapeConfig) -> dict:
        if shape.kind == "decode":
            return super().input_specs(shape)
        B, half = shape.global_batch, shape.seq_len // 2
        return {"frame_embeds": torch.empty((B, half, self.cfg.d_model), dtype=torch.bfloat16,
                                            device="meta"),
                "tokens": torch.empty((B, half), dtype=torch.int32, device="meta")}

    def input_axes(self, shape: ShapeConfig) -> dict:
        if shape.kind == "decode":
            return super().input_axes(shape)
        return {"frame_embeds": ("batch", "seq", None), "tokens": ("batch", "seq")}

    def cache_axes(self, shape: ShapeConfig) -> dict:
        """Every leaf's sequence on "cache_seq"; a serving mesh step tiles
        the memory over the self-attention cache's axes (the dry run's
        shapes give both the same length)."""
        ax = ("layers", "batch", "cache_seq", None, None)
        return {"k": ax, "v": ax, "k_mem": ax, "v_mem": ax}
