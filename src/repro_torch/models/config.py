"""Model configuration covering every assigned architecture family.

The port's copy of ``repro.models.config`` (identical apart from this
paragraph): the port never imports the JAX package.

One ``ModelConfig`` describes dense GQA transformers, MoE transformers,
RG-LRU hybrids (recurrentgemma), xLSTM stacks, encoder-only audio
backbones, and VLM backbones.  Layer stacks are expressed as a repeating
``block_pattern`` unit (scanned) plus an optional unrolled tail, which is
how heterogeneous stacks (e.g. recurrentgemma's recurrent/recurrent/attn
pattern) stay scan-compatible.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "rglru", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # None -> d_model // num_heads
    activation: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    qkv_bias: bool = False
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10_000.0
    causal: bool = True  # False for encoder-only
    window: int | None = None  # sliding-window size for attn blocks
    # Repeating layer-stack unit; e.g. ("rglru","rglru","attn").  The stack
    # is ceil-divided: full units are scanned, the remainder is a tail of
    # the unit's prefix, unrolled.
    block_pattern: tuple[BlockKind, ...] = ("attn",)
    moe: MoEConfig | None = None
    # Embedding-free input (audio/vlm stubs feed precomputed embeddings).
    embed_inputs: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # Serving / long-context
    subquadratic: bool = False  # True if decode state is O(1) or windowed
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def units(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def tail(self) -> tuple[BlockKind, ...]:
        rem = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND math."""
        d, hd = self.d_model, self.resolved_head_dim
        h, hkv = self.num_heads, self.num_kv_heads
        attn = d * (h * hd) + 2 * d * (hkv * hd) + (h * hd) * d
        if self.activation in ("swiglu", "geglu"):
            ffn = 3 * self.d_model * self.d_ff
        else:
            ffn = 2 * self.d_model * self.d_ff
        per_kind = {}
        per_kind["attn"] = attn + (ffn if self.d_ff else 0)
        # recurrent blocks: in/out proj + conv + gates (approx; see models)
        per_kind["rglru"] = 2 * d * d + 4 * d + 3 * d * d // 1
        per_kind["mlstm"] = int(4.5 * d * d)
        per_kind["slstm"] = int(4.5 * d * d)
        if self.moe is not None:
            experts = (
                self.moe.num_experts + self.moe.num_shared_experts
            ) * 3 * d * self.moe.d_ff
            router = d * self.moe.num_experts
            per_kind["attn"] = attn + experts + router
        total = 0
        for i in range(self.num_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            total += per_kind[kind]
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        all_experts = (
            self.moe.num_experts + self.moe.num_shared_experts
        ) * 3 * d * self.moe.d_ff
        active_experts = (
            self.moe.top_k + self.moe.num_shared_experts
        ) * 3 * d * self.moe.d_ff
        n_moe_layers = sum(
            1
            for i in range(self.num_layers)
            if self.block_pattern[i % len(self.block_pattern)] == "attn"
        )
        return self.param_count() - n_moe_layers * (all_experts - active_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
