"""llava-next-mistral-7b — VLM; Mistral-7B backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The anyres vision tower is a STUB: the caller provides precomputed
patch embeddings (B, n_patches, d_model) prepended to the token sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    n_patches=576,  # one anyres base tile (24x24 @ patch 14, CLIP-L/336)
    frontend="vision",
    param_dtype="bfloat16",
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)
