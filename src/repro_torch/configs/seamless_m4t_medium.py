"""seamless-m4t-medium — audio enc-dec transformer backbone.

[arXiv:2308.11596; hf]
12L d_model=1024 16H (kv=16, MHA) d_ff=4096 vocab=256206; enc-dec.
The speech frontend is a STUB: the caller provides precomputed frame
embeddings (B, S_enc, d_model) for the encoder. ``train_4k`` splits the
sequence budget 1/2 encoder frames + 1/2 decoder tokens (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,  # decoder depth
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,  # padded to 256256 internally for even sharding
    head_dim=64,
    frontend="audio",
    param_dtype="bfloat16",
    source="[arXiv:2308.11596; hf]",
)
