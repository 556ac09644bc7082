"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8, 1 shared).

[arXiv:2501.kimi2, paper-table] 61L d_model=7168 64H (GQA kv=8)
expert d_ff=2048 vocab=163840; MoE 384e top-8 + 1 shared expert.
Full attention -> long_500k skipped.  Optimizer: Adafactor (factored
second moment) so 1T-param optimizer state fits 512 x 16 GB
(EXPERIMENTS.md §Memory budget).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=0,
    vocab_size=163_840,
    activation="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048, num_shared_experts=1),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=0,
    vocab_size=512,
    activation="swiglu",
    moe=MoEConfig(num_experts=8, top_k=4, d_ff=32, num_shared_experts=1),
    tie_embeddings=False,
)
