"""Architecture registry: ``get_arch("smollm-135m") -> ArchConfig``, and the
dry run's shapes and cells (``get_shape``, ``cell_supported``,
``all_cells``).

All ten of the JAX package's archs (dense, MoE, VLM, enc-dec, RWKV6 and
Zamba2); their fields are the JAX package's, copied.
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
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


#: archs whose sequence mixing is sub-quadratic -> eligible for long_500k
SUBQUADRATIC = {"rwkv6-3b", "zamba2-1.2b"}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}") from None


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; else (False, why)."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("full-attention arch: 512k dense KV is quadratic-regime "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
