"""Shared model building blocks: param specs, norms, RoPE, embeddings.

Parameters are plain nested dicts of tensors. Every leaf is declared
through a :class:`ParamSpec`; the same spec tree serves real initialization
(from a ``torch.Generator``, on the generator's device) and allocation-free
``meta`` tensors (:func:`spec_struct`), the counterpart of the JAX
package's ``ShapeDtypeStruct`` trees. The JAX specs' logical sharding axes
have no counterpart: the port runs on one device.

The loss pieces (``shift_targets``, ``chunked_cross_entropy``) are the
JAX package's one-device forms; its vocab-parallel cross-entropy
(``runtime/losses.py``) waits for the multi-device slice (ROADMAP A9).
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


def layer_params(stack: dict, i: int) -> dict:
    """Layer ``i``'s params from a dict of leaves stacked along a leading
    layer axis (the JAX package scans over that axis)."""
    return {k: v[i] for k, v in stack.items()}


def spec_struct(specs: SpecTree) -> Any:
    return tree_map(lambda s: s.struct(), specs)


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
    """Embedding rows for ``tokens`` (any shape of int ids)."""
    return embed[tokens]


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
    """
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
    return tot, cnt


def shift_targets(tokens: torch.Tensor,
                  mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard LM shift: predict token t+1 at position t. Returns the
    targets (the last one 0) and an f32 mask that drops the last position."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    m = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    if mask is not None:
        m = m * mask.to(torch.float32)
    m[:, -1] = 0.0
    return targets, m
