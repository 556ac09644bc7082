"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.

[arXiv:2402.19427] 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
Pattern unit (rglru, rglru, attn); 38 = 12 units + (rglru, rglru) tail.
Local attention window 2048 (Griffin).  Sub-quadratic: RG-LRU state is
O(1), local attention cache is O(window) -> long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    activation="geglu",
    rope="rope",
    window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="geglu",
    rope="rope",
    window=16,
    block_pattern=("rglru", "rglru", "attn"),
    subquadratic=True,
)
