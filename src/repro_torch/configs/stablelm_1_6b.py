"""stablelm-1.6b — dense MHA with partial rotary embeddings.

[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (kv=32, MHA) d_ff=5632 vocab=100352; rotary_pct=0.25.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    rope_theta=10_000.0,
    rope_pct=0.25,
    param_dtype="bfloat16",
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
)
