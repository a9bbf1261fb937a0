"""Architecture config registry: the reference's eleven architectures
(dense decoders, two MoE ones, the hybrid recurrent one, xLSTM, a
vision-language one with cross-attention and an encoder-decoder one).

``get_config(name)`` returns the full-size ModelConfig;
``get_reduced(name)`` the smoke-test-sized variant of the same family.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401

ARCHS = [
    "smollm_135m",
    "mistral_nemo_12b",
    "qwen3_14b",
    "chatglm3_6b",
    "llama1_7b",          # the paper's own evaluation model
    "recurrentgemma_9b",  # RG-LRU + local attention, one-shot serving only
    "moonshot_v1_16b_a3b",        # MoE: 64 experts top-6
    "llama4_maverick_400b_a17b",  # MoE: 128 experts top-1 + shared
    "xlstm_125m",         # mLSTM + sLSTM, one-shot serving only
    "whisper_tiny",       # encoder-decoder, one-shot serving only
    "llama_3_2_vision_90b",       # cross-attention to patch embeddings
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    if name in _ALIAS:
        return _ALIAS[name]
    raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.config()


def get_reduced(name: str) -> ModelConfig:
    return reduced(get_config(name))
