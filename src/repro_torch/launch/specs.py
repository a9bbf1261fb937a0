"""Serving config (port of ``repro.launch.specs.serve_config``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import QuantConfig

__all__ = ["serve_config"]


def serve_config(cfg: ModelConfig, w_bits: int = 4,
                 backend: str = "int_dot") -> ModelConfig:
    """Serving variant: PTQ W{w_bits}A8 linears with per-channel epilogue
    scales (``group=0``), dynamic int8 attention and an int8 KV cache.
    ``backend`` names the integer-GEMM backend (a registry name of
    :mod:`repro_torch.core.backend`); all are bit-exact on the int32
    accumulator."""
    return cfg.replace(
        quant=QuantConfig(mode="ptq", w_bits=w_bits, a_bits=8, group=0,
                          backend=backend),
        quant_attention=not cfg.is_encdec,
        kv_cache_bits=8 if not cfg.is_encdec else 16)
