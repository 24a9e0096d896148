"""RWKV6 ("Finch"): attention-free LM with data-dependent per-channel decay.

Own copy of the JAX package's ``models/rwkv6.py``, on one device. Two
numerically equivalent WKV6 cores, plain PyTorch as in the JAX package
(neither is a Pallas kernel there):

* :func:`wkv6_recurrent`: token by token (the decode path and the oracle);
* :func:`wkv6_chunked`: the chunked-parallel form of prefill and training.
  Every decay exponent is a difference of within-chunk cumulative log
  decays, so it is <= 0 (no overflow).

State per layer and head: S in R^{N x N} (key dim x value dim):
    o_t = r_t^T (S_{t-1} + u . k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The WKV state stays f32 and the token-shift states are in the compute
dtype, as the reference keeps them. Decode writes the new states into the
cache in place. Under a mesh step whose "model" axis shards the sequence,
the WKV core is ``runtime/sequence_parallel.py``'s ``wkv6_sharded`` and
the token shifts start from the previous shard's last row
(``models/common.py`` ``prev_row``), where the reference's GSPMD sees the
whole sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.base import BaseModel
from repro_torch.models.common import (
    ParamSpec,
    chunked_cross_entropy,
    column_product,
    column_products,
    embed_lookup,
    group_norm,
    last_shard,
    layer_params,
    prev_row,
    rms_norm,
    row_product,
    shift_targets,
)
from repro_torch.models.transformer import remat_apply
from repro_torch.runtime.sharding import model_parallel

MIX_LORA = 32  # ddlerp lora rank (5 heads)
DECAY_LORA = 64

# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------


def wkv6_recurrent(r, k, v, w, u, state):
    """Oracle and decode WKV. r, k, v, w: (B, H, T, N); u: (H, N); state:
    (B, H, N, N). Returns (out (B, H, T, N), state)."""
    S = state
    outs = []
    for t in range(r.shape[2]):
        r_t, k_t, v_t, w_t = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]  # (B, H, N)
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, N, N)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, S + u[None, :, :, None] * kv))
        S = w_t[..., :, None] * S + kv
    return torch.stack(outs, dim=2), S


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = 32):
    """Chunked-parallel WKV; the signature and semantics of
    :func:`wkv6_recurrent`. The chunk is ``min(chunk, T)`` and must divide
    T, as the reference asserts."""
    B, H, T, N = r.shape
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"wkv6_chunked: chunk {C} does not divide T = {T}")
    n = T // C

    def to_chunks(x):
        return x.reshape(B, H, n, C, N).permute(2, 0, 1, 3, 4)  # (n, B, H, C, N)

    rc, kc, vc = to_chunks(r), to_chunks(k), to_chunks(v)
    lw = torch.log(torch.clamp(to_chunks(w), min=1e-38))  # <= 0
    clog = torch.cumsum(lw, dim=-2)  # inclusive cumulative log decay
    cprev = clog - lw  # exclusive
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), diagonal=-1)  # a < t

    S = state
    outs = []
    for i in range(n):
        r_i, k_i, v_i, clog_i, cprev_i = rc[i], kc[i], vc[i], clog[i], cprev[i]
        # intra-chunk: scores[t, a] = sum_i r[t, i] k[a, i] exp(cprev[t, i] - clog[a, i])
        decay = torch.exp(torch.clamp(cprev_i[..., :, None, :] - clog_i[..., None, :, :],
                                      -60.0, 0.0))  # (B, H, C, C, N)
        decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
        scores = torch.einsum("bhti,bhai,bhtai->bhta", r_i, k_i, decay)
        diag = torch.einsum("bhti,hi->bht", r_i * k_i, u)  # the bonus term u
        o = torch.einsum("bhta,bhaj->bhtj", scores, v_i) + diag[..., None] * v_i
        # inter-chunk: the carried-in state
        o = o + torch.einsum("bhti,bhij->bhtj", r_i * torch.exp(cprev_i), S)
        last = clog_i[..., -1:, :]  # (B, H, 1, N)
        k_hat = k_i * torch.exp(last - clog_i)
        S = torch.exp(last[..., 0, :])[..., :, None] * S + torch.einsum(
            "bhai,bhaj->bhij", k_hat, v_i)
        outs.append(o)
    out = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(B, H, T, N)
    return out, S


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class Rwkv6LM(BaseModel):
    #: the per-channel vectors a decode step reads whole (the WKV state is)
    GATHERED_IN_DECODE = ("decay_base", "wkv_norm_scale", "wkv_norm_bias")

    def param_specs(self) -> dict:
        cfg = self.cfg
        d, L = cfg.d_model, cfg.n_layers
        H, N = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        dt, f32 = self.param_dtype, torch.float32
        layers = {
            "ln1": ParamSpec((L, d), f32, init="ones", axes=("layers", "embed")),
            "ln2": ParamSpec((L, d), f32, init="ones", axes=("layers", "embed")),
            # time-mix ddlerp
            "tm_mix_x": ParamSpec((L, d), f32, init="small", axes=("layers", "embed")),
            "tm_mix": ParamSpec((L, 5, d), f32, init="small", axes=("layers", None, "embed")),
            "tm_lora_a": ParamSpec((L, d, 5 * MIX_LORA), dt, axes=("layers", "embed", None)),
            "tm_lora_b": ParamSpec((L, 5, MIX_LORA, d), dt, init="small",
                                   axes=("layers", None, None, "embed")),
            # projections
            "w_r": ParamSpec((L, d, H * N), dt, axes=("layers", "embed", "heads")),
            "w_k": ParamSpec((L, d, H * N), dt, axes=("layers", "embed", "heads")),
            "w_v": ParamSpec((L, d, H * N), dt, axes=("layers", "embed", "heads")),
            "w_g": ParamSpec((L, d, H * N), dt, axes=("layers", "embed", "heads")),
            "w_o": ParamSpec((L, H * N, d), dt, axes=("layers", "heads", "embed")),
            # data-dependent decay
            "decay_base": ParamSpec((L, H * N), f32, init="small", axes=("layers", "heads")),
            "decay_lora_a": ParamSpec((L, d, DECAY_LORA), dt, axes=("layers", "embed", None)),
            "decay_lora_b": ParamSpec((L, DECAY_LORA, H * N), dt, init="small",
                                      axes=("layers", None, "heads")),
            "u_bonus": ParamSpec((L, H, N), f32, init="small", axes=("layers", None, None)),
            "wkv_norm_scale": ParamSpec((L, H * N), f32, init="ones", axes=("layers", "heads")),
            "wkv_norm_bias": ParamSpec((L, H * N), f32, init="zeros", axes=("layers", "heads")),
            # channel-mix
            "cm_mix_k": ParamSpec((L, d), f32, init="small", axes=("layers", "embed")),
            "cm_mix_r": ParamSpec((L, d), f32, init="small", axes=("layers", "embed")),
            "cm_k": ParamSpec((L, d, cfg.d_ff), dt, axes=("layers", "embed", "mlp")),
            "cm_v": ParamSpec((L, cfg.d_ff, d), dt, axes=("layers", "mlp", "embed")),
            "cm_r": ParamSpec((L, d, d), dt, axes=("layers", "embed", None)),
        }
        return {
            "embed": ParamSpec((cfg.padded_vocab, d), dt, init="normal", axes=("vocab", "embed")),
            "final_norm": ParamSpec((d,), f32, init="ones", axes=("embed",)),
            "lm_head": ParamSpec((d, cfg.padded_vocab), dt, axes=("embed", "vocab")),
            "layers": layers,
        }

    # ---- layer pieces ------------------------------------------------------

    def _time_mix(self, lp: dict, x: torch.Tensor, shift_state: torch.Tensor,
                  wkv_state: torch.Tensor, *, chunked: bool):
        cfg, cd = self.cfg, self.compute_dtype
        H, N = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        B, T, _ = x.shape
        if shift_state is None:
            shift_state = prev_row(x)
        prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
        xx = prev - x
        base = x + xx * lp["tm_mix_x"].to(x.dtype)
        s = torch.tanh(base.to(cd) @ lp["tm_lora_a"].to(cd)).reshape(B, T, 5, MIX_LORA)
        delta = torch.einsum("btfr,frd->btfd", s, lp["tm_lora_b"].to(cd))  # (B, T, 5, d)
        mix = lp["tm_mix"].to(cd)[None, None] + delta
        xw, xk, xv, xr, xg = [(x + xx * mix[:, :, i]).to(cd) for i in range(5)]
        # column-parallel where the weights are "model" tiles: the heads
        # gathered whole (the WKV state is)
        r, k, v, g = column_products(lp, [("w_r", xr), ("w_k", xk), ("w_v", xv), ("w_g", xg)],
                                     cd)
        r, k, v = (a.reshape(B, T, H, N) for a in (r, k, v))
        g = F.silu(g)
        dlogit = lp["decay_base"].to(torch.float32) + column_product(
            lp, "decay_lora_b", torch.tanh(xw @ lp["decay_lora_a"].to(cd)), cd).to(torch.float32)
        w = torch.exp(-torch.exp(dlogit.reshape(B, T, H, N)))  # (0, 1) per channel

        def to_bhtn(a):
            return a.transpose(1, 2).to(torch.float32)

        u = lp["u_bonus"].to(torch.float32)
        rules = model_parallel()
        if chunked and rules is not None and wkv_state is None:
            from repro_torch.runtime.sequence_parallel import wkv6_sharded

            o, wkv_state = wkv6_sharded(to_bhtn(r), to_bhtn(k), to_bhtn(v), to_bhtn(w), u, rules)
        else:
            if wkv_state is None:
                wkv_state = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
            fn = wkv6_chunked if chunked else wkv6_recurrent
            o, wkv_state = fn(to_bhtn(r), to_bhtn(k), to_bhtn(v), to_bhtn(w), u, wkv_state)
        o = o.transpose(1, 2).reshape(B, T, H * N)
        o = group_norm(o, H, lp["wkv_norm_scale"], lp["wkv_norm_bias"], 64e-5)
        out = row_product(lp, "w_o", o.to(cd) * g, cd)
        return out, x[:, -1], wkv_state

    def _channel_mix(self, lp: dict, x: torch.Tensor, shift_state: torch.Tensor):
        cd = self.compute_dtype
        if shift_state is None:
            shift_state = prev_row(x)
        prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
        xx = prev - x
        xk = (x + xx * lp["cm_mix_k"].to(x.dtype)).to(cd)
        xr = (x + xx * lp["cm_mix_r"].to(x.dtype)).to(cd)
        kk = torch.square(F.relu(column_product(lp, "cm_k", xk, cd, gather=False)))
        out = torch.sigmoid(xr @ lp["cm_r"].to(cd)) * row_product(lp, "cm_v", kk, cd)
        return out, x[:, -1]

    def _layer_apply(self, lp: dict, x: torch.Tensor, states: dict | None, *, chunked: bool):
        """One layer: (new residual stream, its states {"tm_shift",
        "cm_shift", "wkv"}); ``states`` None starts from zeros (or, on a
        sequence shard, from the previous shards)."""
        cfg = self.cfg
        if states is None:
            tm_shift = cm_shift = wkv = None
        else:
            tm_shift, cm_shift, wkv = states["tm_shift"], states["cm_shift"], states["wkv"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, tm_shift, wkv = self._time_mix(lp, h, tm_shift, wkv, chunked=chunked)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        m, cm_shift = self._channel_mix(lp, h, cm_shift)
        return x + m, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}

    # ---- public API ----------------------------------------------------------

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy of ``batch["tokens"]`` (B, S) -> (loss,
        {"ce_loss", "tokens"}), f32 scalars; each layer under ``cfg.remat``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens).to(self.compute_dtype)
        fn = lambda x, lp: self._layer_apply(lp, x, None, chunked=True)[0]  # noqa: E731
        for i in range(cfg.n_layers):
            x = remat_apply(cfg.remat, fn, x, layer_params(params["layers"], i))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        targets, mask = shift_targets(tokens, batch.get("mask"))
        tot, cnt = chunked_cross_entropy(x, params["lm_head"].T, targets, mask,
                                         vocab_size=cfg.vocab_size)
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss, {"ce_loss": loss, "tokens": cnt}

    def prefill(self, params: dict, batch: dict, *, cache_len: int | None = None):
        """``batch["tokens"]`` (B, T), T a multiple of min(32, T) -> (logits
        (B, 1, V_pad) f32 of the last token, states {"tm_shift", "cm_shift"}
        (L, B, d) in the compute dtype and "wkv" (L, B, H, N, N) f32).
        ``cache_len`` is taken for the serving app's sake: nothing grows."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"]).to(self.compute_dtype)
        per_layer = []
        for i in range(cfg.n_layers):
            x, states = self._layer_apply(layer_params(params["layers"], i), x, None, chunked=True)
            per_layer.append(states)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache = {k: torch.stack([s[k] for s in per_layer]) for k in per_layer[0]}
        # on a sequence shard the token shifts' states are the last shard's
        # rows (the WKV state is already alike on every "model" rank)
        for k in ("tm_shift", "cm_shift"):
            cache[k] = last_shard(cache[k])
        return self._logits(params, last_shard(x[:, -1:])), cache

    def decode(self, params: dict, cache: dict, batch: dict):
        """One step of ``tokens`` (B, 1) (positions are not needed): writes
        every layer's new states into ``cache`` in place; returns (logits
        (B, 1, V_pad) f32, cache)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"]).to(self.compute_dtype)
        for i in range(cfg.n_layers):
            states = {k: v[i] for k, v in cache.items()}
            x, new = self._layer_apply(layer_params(params["layers"], i), x, states, chunked=False)
            for k, v in new.items():
                cache[k][i] = v
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def cache_struct(self, shape: ShapeConfig) -> dict:
        """The recurrent states at this batch, as ``meta`` tensors (no
        sequence axis: their size does not grow)."""
        cfg = self.cfg
        B, L = shape.global_batch, cfg.n_layers
        H, N = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        shift = torch.empty((L, B, cfg.d_model), dtype=self.compute_dtype, device="meta")
        return {"tm_shift": shift, "cm_shift": shift,
                "wkv": torch.empty((L, B, H, N, N), dtype=torch.float32, device="meta")}

    def cache_axes(self, shape: ShapeConfig) -> dict:
        return {
            "tm_shift": ("layers", "batch", "embed"),
            "cm_shift": ("layers", "batch", "embed"),
            "wkv": ("layers", "batch", None, None, None),
        }
