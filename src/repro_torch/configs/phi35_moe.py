"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    rope_theta=10_000.0,
    n_experts=16,
    experts_per_token=2,
    param_dtype="bfloat16",
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
)
