"""Zamba2-style hybrid: a Mamba2 backbone and one weight-tied shared
attention block.

Own copy of the JAX package's ``models/zamba.py``. The shared transformer
block (attention and MLP, one set of weights) runs before every
``shared_block_every``-th Mamba2 layer, on ``concat([x, x0])`` (the
current stream and the original embeddings), so zamba2-1.2b's 38 layers
have ceil(38 / 6) = 7 attention sites, each followed by its group of
Mamba2 layers. The released model's per-site LoRA adapters are omitted, as
in the reference. The cache holds each site's K/V, (sites, B, S, KV, hd),
and every Mamba2 layer's states; only the K/V grow with the sequence.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import mamba2
from repro_torch.models.base import BaseModel
from repro_torch.models.common import (
    ParamSpec,
    chunked_cross_entropy,
    cache_segment,
    embed_lookup,
    last_shard,
    layer_params,
    rms_norm,
    seq_positions,
    seq_shards,
    shift_targets,
    write_prompt_cache,
)
from repro_torch.models.ffn import mlp_apply, mlp_specs
from repro_torch.models.transformer import (
    attn_block_apply,
    attn_block_decode,
    attn_block_specs,
    remat_apply,
)


class ZambaLM(BaseModel):
    GATHERED_IN_DECODE = mamba2.GATHERED_IN_DECODE

    @property
    def n_sites(self) -> int:
        return math.ceil(self.cfg.n_layers / self.cfg.shared_block_every)

    def _groups(self) -> list[tuple[int, int]]:
        """[(start, end)] Mamba2 layer ranges, one per shared-block site."""
        k, L = self.cfg.shared_block_every, self.cfg.n_layers
        return [(s, min(s + k, L)) for s in range(0, L, k)]

    def param_specs(self) -> dict:
        cfg = self.cfg
        d, dt = cfg.d_model, self.param_dtype
        shared = {
            "attn_norm": ParamSpec((2 * d,), torch.float32, init="ones", axes=("embed",)),
            "mlp_norm": ParamSpec((d,), torch.float32, init="ones", axes=("embed",)),
            **attn_block_specs(cfg, None, dt, d_in=2 * d),
            **mlp_specs(d, cfg.d_ff, None, dt),
        }
        return {
            "embed": ParamSpec((cfg.padded_vocab, d), dt, init="normal", axes=("vocab", "embed")),
            "final_norm": ParamSpec((d,), torch.float32, init="ones", axes=("embed",)),
            "lm_head": ParamSpec((d, cfg.padded_vocab), dt, axes=("embed", "vocab")),
            "shared": shared,
            "mamba": mamba2.mamba_specs(cfg, cfg.n_layers, dt),
        }

    # ---- forward ---------------------------------------------------------

    def _shared_block(self, sp: dict, x: torch.Tensor, x0: torch.Tensor,
                      positions: torch.Tensor):
        cfg, cd = self.cfg, self.compute_dtype
        h = rms_norm(torch.cat([x, x0], dim=-1), sp["attn_norm"], cfg.norm_eps)
        a, kv = attn_block_apply(cfg, sp, h, positions=positions, compute_dtype=cd)
        x = x + a
        h = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
        return x + mlp_apply(sp, h, cd), kv

    def _mamba_block(self, x: torch.Tensor, lp: dict, state: dict | None, chunked: bool):
        out, state = mamba2.mamba_apply(self.cfg, lp, x, state, compute_dtype=self.compute_dtype,
                                        chunked=chunked)
        return x + out, state

    def _forward(self, params: dict, tokens: torch.Tensor, cache_len: int | None,
                 collect_cache: bool):
        """Hidden states after the final norm and, with ``collect_cache``,
        the cache {"k", "v"} (sites, B, cache_len or S, KV, hd), zeros past
        S, and {"mamba": {"conv", "ssd"}} (L, ...)."""
        cfg, cd = self.cfg, self.compute_dtype
        x = embed_lookup(params["embed"], tokens).to(cd)
        x0 = x
        B, S = tokens.shape
        dev = tokens.device
        positions = seq_positions(B, S, dev)
        cache = None
        if collect_cache:
            whole = S * seq_shards()  # on a sequence shard: the whole prompt's length
            if cache_len is not None and cache_len < whole:
                raise ValueError(f"cache_len {cache_len} is shorter than the prompt's {whole} "
                                 f"tokens")
            start, size, _ = cache_segment(cache_len or whole)
            shape = (self.n_sites, B, size, cfg.n_kv_heads, cfg.resolved_head_dim)
            alloc = torch.zeros if cache_len else torch.empty
            cache = {"k": alloc(shape, dtype=cd, device=dev),
                     "v": alloc(shape, dtype=cd, device=dev), "mamba": {"conv": [], "ssd": []}}
        # the reference remats each of the unrolled shared sites fully, and
        # the Mamba2 layers under cfg.remat's policy
        site_remat = "none" if cfg.remat == "none" else "full"
        shared = lambda x, sp: self._shared_block(sp, x, x0, positions)  # noqa: E731
        mamba = lambda x, lp: self._mamba_block(x, lp, None, True)  # noqa: E731
        for site, (s, e) in enumerate(self._groups()):
            x, (k, v) = remat_apply(site_remat, shared, x, params["shared"])
            if collect_cache:
                write_prompt_cache(cache["k"][site], k, start)
                write_prompt_cache(cache["v"][site], v, start)
            for i in range(s, e):
                x, state = remat_apply(cfg.remat, mamba, x, layer_params(params["mamba"], i))
                if collect_cache:
                    cache["mamba"]["conv"].append(state["conv"])
                    cache["mamba"]["ssd"].append(state["ssd"])
        if collect_cache:
            cache["mamba"] = {k: torch.stack(v) for k, v in cache["mamba"].items()}
            # on a sequence shard the conv states are the last shard's rows
            # (the SSD state is already alike on every "model" rank)
            cache["mamba"]["conv"] = last_shard(cache["mamba"]["conv"])
        return rms_norm(x, params["final_norm"], cfg.norm_eps), cache

    # ---- public API ------------------------------------------------------

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy of ``batch["tokens"]`` (B, S) -> (loss,
        {"ce_loss", "tokens"}), f32 scalars."""
        tokens = batch["tokens"]
        x, _ = self._forward(params, tokens, None, collect_cache=False)
        targets, mask = shift_targets(tokens, batch.get("mask"))
        tot, cnt = chunked_cross_entropy(x, params["lm_head"].T, targets, mask,
                                         vocab_size=self.cfg.vocab_size)
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss, {"ce_loss": loss, "tokens": cnt}

    def prefill(self, params: dict, batch: dict, *, cache_len: int | None = None):
        """``batch["tokens"]`` (B, T), T a multiple of min(64, T) -> (logits
        (B, 1, V_pad) f32 of the last token, cache). ``cache_len`` grows
        only the sites' K/V (zeros past T), for decoding in place."""
        x, cache = self._forward(params, batch["tokens"], cache_len, collect_cache=True)
        return self._logits(params, last_shard(x[:, -1:])), cache

    def decode(self, params: dict, cache: dict, batch: dict):
        """One step: ``tokens`` (B, 1), ``positions`` (B,) write index per
        row. Writes the sites' new K/V entries and every Mamba2 layer's new
        states into ``cache`` in place; returns (logits (B, 1, V_pad) f32,
        cache)."""
        cfg, cd = self.cfg, self.compute_dtype
        positions = batch["positions"]
        x = embed_lookup(params["embed"], batch["tokens"]).to(cd)
        x0 = x
        sp = params["shared"]
        conv, ssd = cache["mamba"]["conv"], cache["mamba"]["ssd"]
        for site, (s, e) in enumerate(self._groups()):
            h = rms_norm(torch.cat([x, x0], dim=-1), sp["attn_norm"], cfg.norm_eps)
            a, _ = attn_block_decode(cfg, sp, h, cache["k"][site], cache["v"][site],
                                     positions=positions, compute_dtype=cd)
            x = x + a
            x = x + mlp_apply(sp, rms_norm(x, sp["mlp_norm"], cfg.norm_eps), cd)
            for i in range(s, e):
                x, state = self._mamba_block(x, layer_params(params["mamba"], i),
                                             {"conv": conv[i], "ssd": ssd[i]}, False)
                conv[i] = state["conv"]
                ssd[i] = state["ssd"]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def cache_struct(self, shape: ShapeConfig) -> dict:
        """The JAX package's dry-run cache as ``meta`` tensors: the sites'
        bf16 K/V and the Mamba2 states."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        kv = torch.empty((self.n_sites, B, S, cfg.n_kv_heads, cfg.resolved_head_dim),
                         dtype=torch.bfloat16, device="meta")
        return {"k": kv, "v": kv,
                "mamba": mamba2.mamba_state_struct(cfg, cfg.n_layers, B, self.compute_dtype)}

    def cache_axes(self, shape: ShapeConfig) -> dict:
        ax = ("layers", "batch", "cache_seq", None, None)
        return {"k": ax, "v": ax, "mamba": mamba2.mamba_state_axes()}
