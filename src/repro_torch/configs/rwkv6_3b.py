"""rwkv6-3b ("Finch") — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]
32L d_model=2560 (attn-free) d_ff=8960 vocab=65536. WKV6 recurrence with
data-dependent per-channel decay; chunked-parallel implementation.
Sub-quadratic -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,  # 40 wkv heads
    param_dtype="bfloat16",
    source="[arXiv:2404.05892; hf]",
)
