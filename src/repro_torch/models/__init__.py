"""Model zoo: ``build_model(cfg) -> BaseModel`` dispatch by family.

``DecoderLM`` (dense, MoE, VLM), ``EncDecLM`` (enc-dec), ``Rwkv6LM``
(the "ssm" family) and ``ZambaLM`` (the Mamba2 "hybrid"), as in the JAX
package. Every family trains through ``runtime/steps.py``'s
``build_train_step``, on the card through the flash kernels where it has
attention.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import BaseModel
from repro_torch.models.params import params_from_jax, train_state_from_jax, tree_to_numpy


def build_model(cfg: ArchConfig) -> BaseModel:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import Rwkv6LM

        return Rwkv6LM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.zamba import ZambaLM

        return ZambaLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["BaseModel", "build_model", "params_from_jax", "train_state_from_jax", "tree_to_numpy"]
