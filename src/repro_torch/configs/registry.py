"""Architecture registry: ``get_arch("smollm-135m") -> ArchConfig``.

The port carries the dense family's configs (ROADMAP A8 keeps the MoE,
VLM, enc-dec, RWKV and hybrid families for later); their fields are the
JAX package's, copied.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3
from repro_torch.configs.smollm_135m import CONFIG as SMOLLM
from repro_torch.configs.stablelm_1_6b import CONFIG as STABLELM
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [QWEN3, SMOLLM, STABLELM, STARCODER2]}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None

