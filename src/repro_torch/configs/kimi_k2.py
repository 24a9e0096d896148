"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

[arXiv:2501.kimi2; unverified]
61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8,
1 shared expert (DeepSeek-V3-style). Trains only with full ZeRO-3 over all
chips + bf16/factored optimizer state — see EXPERIMENTS.md §Dry-run.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    rope_theta=50_000.0,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    moe_group_size=512,
    capacity_factor=1.25,
    param_dtype="bfloat16",
    optimizer="adafactor",
    moment_dtype="bfloat16",
    first_moment=False,
    source="[arXiv:2501.kimi2; unverified]",
)
