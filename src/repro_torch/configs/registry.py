"""Architecture registry: ``get_arch("smollm-135m") -> ArchConfig``.

All ten of the JAX package's archs (dense, MoE, VLM, enc-dec, RWKV6 and
Zamba2); their fields are the JAX package's, copied.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.kimi_k2 import CONFIG as KIMI
from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA
from repro_torch.configs.phi35_moe import CONFIG as PHI35
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS
from repro_torch.configs.smollm_135m import CONFIG as SMOLLM
from repro_torch.configs.stablelm_1_6b import CONFIG as STABLELM
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [LLAVA, SEAMLESS, PHI35, KIMI, RWKV6, QWEN3, SMOLLM, STABLELM, STARCODER2,
                        ZAMBA2]}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None
