"""starcoder2-3b — dense, extreme GQA (kv=2), RoPE.

[arXiv:2402.19173; hf]
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    rope_theta=999_999.0,
    gated_mlp=False,
    param_dtype="bfloat16",
    source="[arXiv:2402.19173; hf]",
)
