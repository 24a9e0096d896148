"""Shared model building blocks: param specs, norms, RoPE, embeddings.

Parameters are plain nested dicts of tensors. Every leaf is declared
through a :class:`ParamSpec`; the same spec tree serves real initialization
(from a ``torch.Generator``, on the generator's device) and allocation-free
``meta`` tensors (:func:`spec_struct`), the counterpart of the JAX
package's ``ShapeDtypeStruct`` trees. The JAX specs' logical sharding axes
have no counterpart: the port runs on one device.

``chunked_cross_entropy`` and ``shift_targets`` wait for the training
slice (ROADMAP A7).
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
    init: str = "fan_in"  # "fan_in" | "normal" | "ones" (the dense family's)

    def struct(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def initialize(self, generator: torch.Generator) -> torch.Tensor:
        """Draw on the generator's device: normal 0.02 for ``normal``,
        1/sqrt(fan_in) for ``fan_in`` (fan_in = the second-to-last dim),
        ones for norms; drawn in f32, stored in ``dtype``."""
        device = generator.device
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "normal":
            std = 0.02
        else:  # fan_in
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * std).to(self.dtype)


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
