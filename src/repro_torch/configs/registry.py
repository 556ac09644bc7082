"""Architecture registry: ``--arch <id>`` resolution.

The port of ``repro.configs.registry``, with the reference's ten ids.
Each id maps to a module exporting ``CONFIG`` (the full,
paper-faithful configuration) and ``SMOKE`` (a reduced variant for CPU
tests); ``get_config(arch, smoke=...)`` picks one.  Every id resolves:
the dense, mixture-of-experts, recurrent (RecurrentGemma, xLSTM), audio
and vision-language families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "SKIPS", "cell_skip_reason", "get_config"]

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "hubert-xlarge": "hubert_xlarge",
    "llama3.2-1b": "llama3_2_1b",
    "gemma-2b": "gemma_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "command-r-35b": "command_r_35b",
    "mixtral-8x7b": "mixtral_8x7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


# (arch, shape) cells that are skipped, with reasons (README.md §Cell skips)
SKIPS: dict[tuple[str, str], str] = {
    ("llama3.2-1b", "long_500k"): "skip(full-attn)",
    ("gemma-2b", "long_500k"): "skip(full-attn)",
    ("qwen2.5-32b", "long_500k"): "skip(full-attn)",
    ("command-r-35b", "long_500k"): "skip(full-attn)",
    ("kimi-k2-1t-a32b", "long_500k"): "skip(full-attn)",
    ("qwen2-vl-72b", "long_500k"): "skip(full-attn)",
    ("hubert-xlarge", "long_500k"): "skip(encoder-only)",
    ("hubert-xlarge", "decode_32k"): "skip(encoder-only)",
}


def cell_skip_reason(arch: str, shape: str) -> str | None:
    return SKIPS.get((arch, shape))
