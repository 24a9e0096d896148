"""smollm-135m — llama-arch small dense model (also the e2e training example).

[hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="float32",
    source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
)
