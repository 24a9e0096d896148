"""Mamba2 block (SSD, state-space duality, in its chunked matmul form).

Own copy of the JAX package's ``models/mamba2.py``.
Recurrence per head (state S in R^{headdim x d_state}):
    S_t = exp(dt_t * A) S_{t-1} + (dt_t x_t) B_t^T
    y_t = S_t C_t + D x_t
:func:`ssd_chunked` is the Mamba2 paper's chunked algorithm (intra-chunk
(C, C) scalar decay masks), :func:`ssd_recurrent` the token-level oracle
and decode path. The depthwise causal conv (width 4) is explicit shifts and
multiply-adds, as in the reference. All three are plain PyTorch, as the
reference computes them outside any Pallas kernel. The SSD state stays f32
and the conv state is in the compute dtype, as the reference keeps them.
Under a mesh step whose "model" axis shards the sequence, the conv and the
SSD core are ``runtime/sequence_parallel.py``'s ``conv1d_sharded`` and
``ssd_sharded``, wired where the reference wires them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, column_product, rms_norm, row_product
from repro_torch.runtime.sharding import model_parallel


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None):
    """Depthwise causal conv then SiLU. ``x``: (B, T, Ch); ``w``: (K, Ch);
    ``b``: (Ch,); ``state``: (B, K - 1, Ch), the inputs before ``x`` (zeros
    when None). Returns (out (B, T, Ch), the new state)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, T + K - 1, Ch)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i][None, None] for i in range(K)) + b[None, None]
    return F.silu(out), xp[:, -(K - 1):]


def ssd_recurrent(x, dt, A, B, C, D, state):
    """Oracle and decode SSD. x: (Bt, T, H, P); dt: (Bt, T, H); A: (H,)
    negative; B, C: (Bt, T, G, N) with G = 1; D: (H,); state: (Bt, H, P,
    N). Returns (y (Bt, T, H, P), state)."""
    S = state
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t, B_t, C_t = x[:, t], dt[:, t], B[:, t], C[:, t]
        decay = torch.exp(dt_t * A[None])  # (Bt, H)
        dBx = torch.einsum("bhp,bn->bhpn", x_t * dt_t[..., None], B_t[:, 0])
        S = decay[..., None, None] * S + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", S, C_t[:, 0]) + D[None, :, None] * x_t)
    return torch.stack(ys, dim=1), S


def ssd_chunked(x, dt, A, B, C, D, state, *, chunk: int = 64):
    """Chunked SSD (the Mamba2 paper's algorithm); the semantics of
    :func:`ssd_recurrent`. The chunk is ``min(chunk, T)`` and must divide
    T, as the reference asserts."""
    Bt, T, H, P = x.shape
    N = B.shape[-1]
    Cn = min(chunk, T)
    if T % Cn:
        raise ValueError(f"ssd_chunked: chunk {Cn} does not divide T = {T}")
    n = T // Cn
    xc = x.reshape(Bt, n, Cn, H, P).permute(1, 0, 3, 2, 4)  # (n, Bt, H, C, P)
    dtc = dt.reshape(Bt, n, Cn, H).permute(1, 0, 3, 2)  # (n, Bt, H, C)
    Bc = B[:, :, 0].reshape(Bt, n, Cn, N).permute(1, 0, 2, 3)  # (n, Bt, C, N)
    Cc = C[:, :, 0].reshape(Bt, n, Cn, N).permute(1, 0, 2, 3)
    tri = torch.tril(torch.ones((Cn, Cn), dtype=torch.bool, device=x.device))  # a <= t

    S = state
    ys = []
    for i in range(n):
        x_i, dt_i, B_i, C_i = xc[i], dtc[i], Bc[i], Cc[i]
        dA = dt_i * A[None, :, None]  # (Bt, H, C), <= 0
        cum = torch.cumsum(dA, dim=-1)  # inclusive
        # intra: scores[t, a] = exp(cum_t - cum_a) (C_t . B_a) dt_a, a <= t
        L = torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :], -60.0, 0.0))
        L = torch.where(tri[None, None], L, 0.0)
        CB = torch.einsum("btn,ban->bta", C_i, B_i)  # (Bt, C, C)
        scores = CB[:, None] * L * dt_i[..., None, :]  # (Bt, H, C, C)
        y = torch.einsum("bhta,bhap->bhtp", scores, x_i)
        # inter: y += (C_t exp(cum_t)) . S
        y = y + torch.einsum("btn,bht,bhpn->bhtp", C_i, torch.exp(cum), S)
        last = cum[..., -1:]  # (Bt, H, 1)
        w = torch.exp(torch.clamp(last - cum, -60.0, 0.0)) * dt_i  # (Bt, H, C)
        dBx = torch.einsum("bhtp,bht,btn->bhpn", x_i, w, B_i)
        S = torch.exp(last[..., 0])[..., None, None] * S + dBx
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(Bt, T, H, P)
    return y + D[None, None, :, None] * x, S


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def mamba_specs(cfg, n_layers: int, dtype: torch.dtype) -> dict:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    conv_ch = di + 2 * ds  # x, B, C (ngroups = 1)
    L, f32 = n_layers, torch.float32
    return {
        "norm": ParamSpec((L, d), f32, init="ones", axes=("layers", "embed")),
        "w_in": ParamSpec((L, d, 2 * di + 2 * ds + H), dtype, axes=("layers", "embed", "mlp")),
        "conv_w": ParamSpec((L, cfg.conv_width, conv_ch), f32, axes=("layers", None, "mlp")),
        "conv_b": ParamSpec((L, conv_ch), f32, init="zeros", axes=("layers", "mlp")),
        "A_log": ParamSpec((L, H), f32, init="small", axes=("layers", None)),
        "D": ParamSpec((L, H), f32, init="ones", axes=("layers", None)),
        "dt_bias": ParamSpec((L, H), f32, init="small", axes=("layers", None)),
        "ssd_norm": ParamSpec((L, di), f32, init="ones", axes=("layers", "mlp")),
        "w_out": ParamSpec((L, di, d), dtype, axes=("layers", "mlp", "embed")),
    }


#: a block's leaves on "model" that a decode step reads whole: the conv's
#: and the SSD norm's per-channel weights (the conv and SSD states are
#: whole on every "model" rank)
GATHERED_IN_DECODE = ("conv_w", "conv_b", "ssd_norm")


def mamba_state_struct(cfg, n_layers: int, batch: int, compute_dtype: torch.dtype) -> dict:
    """The recurrent states of ``n_layers`` blocks as ``meta`` tensors:
    "conv" (L, B, K - 1, channels) in the compute dtype, "ssd" (L, B, H, P,
    N) f32."""
    di, ds = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.empty((n_layers, batch, cfg.conv_width - 1, di + 2 * ds),
                            dtype=compute_dtype, device="meta"),
        "ssd": torch.empty((n_layers, batch, H, P, ds), dtype=torch.float32, device="meta"),
    }


def mamba_state_axes() -> dict:
    return {
        "conv": ("layers", "batch", None, "mlp"),
        "ssd": ("layers", "batch", None, None, None),
    }


def mamba_apply(cfg, lp: dict, x: torch.Tensor, state: dict | None, *,
                compute_dtype: torch.dtype, chunked: bool):
    """One Mamba2 block. ``x``: (B, T, d); ``state`` {"conv", "ssd"} of this
    layer, or None (zeros). Returns (out, new_state)."""
    cd = compute_dtype
    di, ds = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    B_, T, _ = x.shape

    h = rms_norm(x, lp["norm"], cfg.norm_eps)
    zxbcdt = column_product(lp, "w_in", h, cd)  # tiles gathered before the split
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, ds, ds, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_state = None if state is None else state["conv"]
    rules = model_parallel() if state is None else None
    if rules is not None:  # a sequence shard: the conv's halo and the SSD's prefix cross shards
        from repro_torch.runtime.sequence_parallel import conv1d_sharded

        conv_out = conv1d_sharded(conv_in, lp["conv_w"].to(cd), lp["conv_b"].to(cd), rules)
        new_conv = conv_in[:, -(cfg.conv_width - 1):]
    else:
        conv_out, new_conv = conv1d_causal(conv_in, lp["conv_w"].to(cd), lp["conv_b"].to(cd),
                                           conv_state)
    xs, Bm, Cm = torch.split(conv_out, [di, ds, ds], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + lp["dt_bias"][None, None])  # (B, T, H)
    A = -torch.exp(lp["A_log"].to(torch.float32))  # (H,)
    xh = xs.reshape(B_, T, H, P).to(torch.float32)
    Bg = Bm[:, :, None, :].to(torch.float32)  # (B, T, 1, N)
    Cg = Cm[:, :, None, :].to(torch.float32)
    if state is None:
        S0 = torch.zeros((B_, H, P, ds), dtype=torch.float32, device=x.device)
    else:
        S0 = state["ssd"]
    if chunked and rules is not None:
        from repro_torch.runtime.sequence_parallel import ssd_sharded

        y, new_ssd = ssd_sharded(xh, dt, A, Bg, Cg, lp["D"].to(torch.float32), rules)
    else:
        fn = ssd_chunked if chunked else ssd_recurrent
        y, new_ssd = fn(xh, dt, A, Bg, Cg, lp["D"].to(torch.float32), S0)
    y = y.reshape(B_, T, di) * F.silu(z.to(torch.float32))
    y = rms_norm(y.to(cd), lp["ssd_norm"], cfg.norm_eps)
    out = row_product(lp, "w_out", y, cd)
    return out, {"conv": new_conv.to(cd), "ssd": new_ssd}
