"""zamba2-1.2b — hybrid: Mamba2 backbone + weight-tied shared attention block.

[arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The shared attention+MLP block is applied every ``shared_block_every``
Mamba2 layers (weight-tied across applications, Zamba2-style).
Sub-quadratic backbone -> runs long_500k (attention sites are decode-time
KV reads, O(seq) per token).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,  # mamba2 layers
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,  # shared block MLP
    vocab_size=32000,
    head_dim=64,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_block_every=6,
    param_dtype="bfloat16",
    source="[arXiv:2411.15242; hf]",
)
