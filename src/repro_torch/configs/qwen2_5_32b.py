"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-32B] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064; head_dim=128; SwiGLU; RoPE theta 1e6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152_064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=512,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
)
