"""qwen3-14b — dense, GQA + per-head qk-norm.

[hf:Qwen/Qwen3-8B; hf] (14B row of the Qwen3 family table)
40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    param_dtype="bfloat16",
    source="[hf:Qwen/Qwen3-8B; hf]",
)
