"""Architecture config registry: the dense decoders, the two MoE ones and
the hybrid recurrent one (recurrentgemma-9b) the port serves.

``get_config(name)`` returns the full-size ModelConfig;
``get_reduced(name)`` the smoke-test-sized variant of the same family.
The reference registers eleven architectures; the port registers the ones
its model code runs (xLSTM, cross-attention and enc-dec families come
later).
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
