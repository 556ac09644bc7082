"""xlstm-1.3b — sLSTM + mLSTM block stack.

[arXiv:2405.04517] 48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.
Pattern unit: 7 mLSTM + 1 sLSTM (the paper's [7:1] ratio); 48 = 6 units.
d_ff=0: blocks carry their own projections (mLSTM 2x expansion, sLSTM
4/3 post-FFN).  Fully recurrent -> long_500k runs with O(1) state.
"""
from repro_torch.models.config import ModelConfig

_PATTERN = ("mlstm",) * 7 + ("slstm",)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    rope="none",
    block_pattern=_PATTERN,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    rope="none",
    block_pattern=_PATTERN,
    subquadratic=True,
)
