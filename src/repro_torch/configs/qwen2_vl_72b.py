"""qwen2-vl-72b — VLM backbone with M-RoPE and dynamic resolution.

[arXiv:2409.12191] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  Backbone only: the vision tower is a STUB —
the caller provides precomputed patch embeddings (``embeds``) for 1/4 of the
sequence plus (t, h, w) M-RoPE position streams.  Full attention ->
long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    activation="swiglu",
    qkv_bias=True,
    rope="mrope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    qkv_bias=True,
    rope="mrope",
    tie_embeddings=False,
)
