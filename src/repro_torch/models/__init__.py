"""Model zoo: ``build_model(cfg) -> BaseModel`` dispatch by family.

The port builds the dense and MoE families (``DecoderLM``); the VLM,
enc-dec, RWKV, Mamba and Zamba families wait for ROADMAP A8.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import BaseModel
from repro_torch.models.params import params_from_jax, train_state_from_jax, tree_to_numpy


def build_model(cfg: ArchConfig) -> BaseModel:
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg)
    if cfg.family in ("vlm", "encdec", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP A8); "
            "the port builds the dense and MoE families")
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["BaseModel", "build_model", "params_from_jax", "train_state_from_jax", "tree_to_numpy"]
