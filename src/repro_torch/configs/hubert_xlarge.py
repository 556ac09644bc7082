"""hubert-xlarge — encoder-only audio backbone (w2v2 architecture).

[arXiv:2106.07447] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Bidirectional attention, GELU FFN.  The conv feature extractor is a STUB:
the caller feeds precomputed frame embeddings as ``embeds`` (B, S, 1280).
Encoder-only: no decode shapes (see README.md §Cell skips).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    rope="none",
    causal=False,
    embed_inputs=False,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=32,
    activation="gelu",
    rope="none",
    causal=False,
    embed_inputs=False,
    tie_embeddings=False,
)
