"""mixtral-8x7b — MoE (8 experts, top-2) with sliding-window attention.

[arXiv:2401.04088] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000;
SWA window 4096.  Sub-quadratic via rolling-window KV cache -> long_500k
runs (decode touches only the last `window` keys).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32_000,
    activation="swiglu",
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
    subquadratic=True,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=0,
    vocab_size=512,
    activation="swiglu",
    window=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=64),
    subquadratic=True,
    tie_embeddings=False,
)
