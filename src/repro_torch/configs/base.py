"""Architecture/config dataclasses shared by the model zoo and launchers.

Every architecture is expressed as an :class:`ArchConfig`; the same
dataclass drives parameter-spec construction (``models.build_model``) and
the reduced smoke-test configs (``cfg.reduced()``). The fields are the JAX
package's fields that the six families (dense, MoE, VLM, enc-dec, RWKV6
"ssm" and the Zamba2 "hybrid") and their training read, with the same
names and defaults, so a config means the same model in both packages.
``attention_impl`` and its block sizes choose the attention route
(``models/attention.py`` ``attention``), as in the reference.
``scan_layers`` has no counterpart: the port's layer loop is a Python loop.
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


#: the JAX package's dry-run shapes of the LM family (seq_len, global_batch, kind)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture (or a reduced variant)."""

    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"

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

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_group_size: int = 256
    capacity_factor: float = 1.25

    # SSM / RWKV
    ssm_state: int = 0  # mamba2 d_state
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # hybrid (zamba2): shared attention block applied every k inner layers
    shared_block_every: int = 6

    # enc-dec
    n_enc_layers: int = 0  # seamless: encoder depth (n_layers = decoder depth)

    # vlm / audio frontend stubs
    n_patches: int = 0  # llava: patch embeddings prepended to the sequence
    frontend: str = "none"  # "none" | "vision" | "audio"

    # numerics / training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    moment_dtype: str = "float32"  # optimizer moment dtype
    first_moment: bool = True  # adafactor: False = momentum-free (1T configs)
    remat: str = "full"  # "none" | "full" | "dots"
    grad_accum: int = 1

    # attention route: "blockwise" (the flash kernel), "naive", "flash",
    # "ring" (the last two differ only under a mesh)
    attention_impl: str = "blockwise"
    attention_block_q: int = 512
    attention_block_kv: int = 1024

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

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Parameter count, from the port's own parameter specs."""
        from repro_torch.models import build_model  # lazy; avoids a cycle

        return build_model(self).param_count()

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-to experts)."""
        total = self.param_count()
        if self.family != "moe" or not self.n_experts:
            return total
        from repro_torch.models import build_model

        expert = build_model(self).expert_param_count()
        used = self.experts_per_token + self.n_shared_experts
        return total - expert + expert * used // self.n_experts

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
            remat="none",
        )
        if self.n_experts:
            small.update(n_experts=4, experts_per_token=2, moe_group_size=16)
            small.update(n_shared_experts=min(self.n_shared_experts, 1))
            # non-binding capacity (cf >= E/k): keeps prefill == decode
            # exactly — capacity dropping is group-dependent and differs
            # between the two paths
            small.update(capacity_factor=4.0)
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=16, ssm_head_dim=32, rwkv_head_dim=32)
            small.update(shared_block_every=2)
        if self.n_enc_layers:
            small.update(n_enc_layers=2)
        if self.n_patches:
            small.update(n_patches=16)
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def replace(self, **overrides: Any) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)
