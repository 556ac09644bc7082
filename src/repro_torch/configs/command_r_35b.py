"""command-r-35b — dense GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01] 40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000; head_dim=128; SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256_000,
    activation="swiglu",
    rope_theta=8_000_000.0,
)

SMOKE = ModelConfig(
    name="command-r-35b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
)
