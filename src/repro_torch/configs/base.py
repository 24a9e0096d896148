"""Architecture/config dataclasses shared by the model zoo and launchers.

Every architecture is expressed as an :class:`ArchConfig`; the same
dataclass drives parameter-spec construction (``models.build_model``) and
the reduced smoke-test configs (``cfg.reduced()``). The fields are the JAX
package's fields that the dense family reads, with the same names and
defaults, so a config means the same model in both packages; the fields of
the other families (MoE, SSM, hybrid, enc-dec, VLM), of training and of
the multi-device attention routes (``attention_impl`` and its block sizes)
come with their slices (ROADMAP A7, A8, A9).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture (or a reduced variant)."""

    name: str
    family: str  # "dense" (ported) | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # stablelm partial rotary
    qk_norm: bool = False  # qwen3
    tie_embeddings: bool = False
    gated_mlp: bool = True  # False = classic 2-matrix gelu MLP (starcoder2)
    norm_eps: float = 1e-5

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    source: str = ""  # provenance note ([hf:...], [arXiv:...])

    # ---- derived ---------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it."""
        return _round_up(self.vocab_size, 256)

    def param_count(self) -> int:
        """Parameter count, from the port's own parameter specs."""
        from repro_torch.models import build_model  # lazy; avoids a cycle

        return build_model(self).param_count()

    # ---- variants --------------------------------------------------------

    def reduced(self, **overrides: Any) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small: dict[str, Any] = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            head_dim=32,
            vocab_size=512,
            param_dtype="float32",
            compute_dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def replace(self, **overrides: Any) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)
