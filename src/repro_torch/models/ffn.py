"""Feed-forward blocks: the gated (SwiGLU) MLP and the classic GELU MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, column_products, row_product


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
    has cast the weights once at load (``DecoderLM.compute_params``). With
    ``p``'s weights the rank's "model" tiles (tensor-parallel serving) the
    up and gate products are column-parallel, their slices kept, and the
    down product row-parallel."""
    cd = compute_dtype
    x = x.to(cd)
    names = ["w_up", "w_gate"] if "w_gate" in p else ["w_up"]
    u, *g = column_products(p, [(n, x) for n in names], cd, gather=False)
    if g:  # SwiGLU
        u = F.silu(g[0]) * u
    else:  # classic 2-matrix MLP (starcoder2); jax.nn.gelu's tanh form
        u = F.gelu(u, approximate="tanh")
    return row_product(p, "w_down", u, cd)
