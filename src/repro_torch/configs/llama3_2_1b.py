"""llama3.2-1b — small dense Llama-3 with GQA.

[hf:meta-llama/Llama-3.2-1B] 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256; head_dim=64; SwiGLU; RoPE theta 500k; tied embeddings.
Pure full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    rope_theta=500_000.0,
)
