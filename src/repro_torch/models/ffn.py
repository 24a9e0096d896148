"""Feed-forward blocks: the gated (SwiGLU) MLP and the classic GELU MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def mlp_specs(d_model: int, d_ff: int, n_layers: int | None, dtype: torch.dtype, *,
              gated: bool = True) -> dict:
    """(Gated) MLP params; optionally stacked over a leading layer axis."""
    lead = () if n_layers is None else (n_layers,)
    lax = () if n_layers is None else ("layers",)
    specs = {
        "w_up": ParamSpec(lead + (d_model, d_ff), dtype, axes=lax + ("embed", "mlp")),
        "w_down": ParamSpec(lead + (d_ff, d_model), dtype, axes=lax + ("mlp", "embed")),
    }
    if gated:
        specs["w_gate"] = ParamSpec(lead + (d_model, d_ff), dtype, axes=lax + ("embed", "mlp"))
    return specs


def mlp_apply(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in the compute dtype; ``.to`` is free when the serving path
    has cast the weights once at load (``DecoderLM.compute_params``)."""
    x = x.to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    if "w_gate" in p:  # SwiGLU
        u = F.silu(x @ p["w_gate"].to(compute_dtype)) * u
    else:  # classic 2-matrix MLP (starcoder2); jax.nn.gelu's tanh form
        u = F.gelu(u, approximate="tanh")
    return u @ p["w_down"].to(compute_dtype)
