"""Quantized gradient reduction over a mesh axis, with error feedback.

Own counterpart of the JAX package's ``runtime/grad_compress.py``: a
standalone utility, as there (no step wires it in). The scarcest link (the
cross-pod one in the reference) carries int8: each rank quantizes its
partial gradient plus the residual it carried from the last step in blocks
of 256 (symmetric, one f32 scale a block), all-gathers the int8 payloads
and the scales over the axis, and sums the dequantized copies; the
quantization error stays behind as the next residual. An int8 all-reduce
would overflow, so the wire holds the int8 tiles (about 1.02 B a param
against f32's 4).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.runtime.collectives import all_gather_stack
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map_with_paths

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization of a flat (N,) f32 ``x``, N a
    multiple of ``BLOCK``: (q (N / BLOCK, BLOCK) int8, scale (N / BLOCK, 1)
    f32), as the reference computes them (round half to even)."""
    blocks = x.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-30)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def _pad_flat(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=torch.float32, device=flat.device)])
    return flat


@torch.no_grad()
def quantized_psum(x: torch.Tensor, resid: torch.Tensor, mesh, axis: str = "pod"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sum of every ``axis`` rank's ``x`` (any shape) through an int8
    wire; ``resid``: this rank's flat error-feedback state
    (:func:`resid_len` long). Returns (the reduced value in x's shape and
    dtype, the new residual)."""
    shape, dtype = x.shape, x.dtype
    flat = _pad_flat(x)
    corrected = flat + resid
    q, scale = quantize_int8(corrected)
    new_resid = corrected - dequantize_int8(q, scale, corrected.shape)
    qg = all_gather_stack(q, mesh, axis)  # (p, blocks, BLOCK) int8 on the wire
    sg = all_gather_stack(scale, mesh, axis)  # (p, blocks, 1) f32 (small)
    reduced = (qg.to(torch.float32) * sg).sum(dim=0).reshape(-1)
    return reduced[:x.numel()].reshape(shape).to(dtype), new_resid


def resid_len(n_params: int) -> int:
    """Length of the flat error-feedback buffer for an ``n_params`` leaf."""
    return ((n_params + BLOCK - 1) // BLOCK) * BLOCK


def quantized_psum_tree(grads: Any, resids: Any, mesh, axis: str = "pod") -> tuple[Any, Any]:
    """:func:`quantized_psum` of every leaf, leaves in the JAX order."""
    res = dict(tree_flatten_with_paths(resids))
    outs = {path: quantized_psum(g, res[path], mesh, axis)
            for path, g in tree_flatten_with_paths(grads)}
    return (tree_map_with_paths(lambda path, _: outs[path][0], grads),
            tree_map_with_paths(lambda path, _: outs[path][1], grads))


def compression_wire_bytes(n_params: int) -> tuple[int, int]:
    """(compressed, f32) bytes per exchange of one gradient copy."""
    blocks = (n_params + BLOCK - 1) // BLOCK
    return n_params * 1 + blocks * 4, n_params * 4
