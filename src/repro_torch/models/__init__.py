"""Model zoo: ``build_model(cfg) -> BaseModel`` dispatch by family.

The port builds the dense family (``DecoderLM``); the MoE, VLM, enc-dec,
RWKV, Mamba and Zamba families wait for ROADMAP A8.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import BaseModel
from repro_torch.models.params import params_from_jax


def build_model(cfg: ArchConfig) -> BaseModel:
    if cfg.family == "dense":
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg)
    if cfg.family in ("moe", "vlm", "encdec", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP A8); "
            "the port builds the dense family")
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["BaseModel", "build_model", "params_from_jax"]
