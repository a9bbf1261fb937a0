"""Model / run configuration dataclasses (port of ``repro.configs.base``).

The fields the port's serving and training paths read, plus the ones
that size a config; JAX dtypes become torch dtypes (``opt_state_dtype``
keeps the reference's values: a dtype, or the string ``"bfloat16"``).
The reference's fields not kept here: ``expert_capacity_factor`` (read
only by the expert-parallel dispatch, not ported yet: the single-device
dispatch drops no token), ``seq_shard`` and ``compress_pod_grads`` (the
multi-device training paths, not ported yet), and the ``sub_quadratic``
property.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.quant.qlinear import QuantConfig

__all__ = ["ModelConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0

    # --- block pattern (super-block repeated n_layers/len(pattern) times) ---
    block_pattern: tuple[str, ...] = ("attn",)
    block_tail: tuple[str, ...] = ()
    mlp_after: tuple[int, ...] | None = None   # pattern idxs with MLP (None=all)
    local_window: int = 0            # 0 -> global attention

    # --- modality frontends (stubs: context embeddings come as given) ---
    n_context_tokens: int = 0
    encoder_layers: int = 0
    max_target_positions: int = 0

    # --- flags ---
    qk_norm: bool = False
    rope_2d: bool = False            # chatglm-style partial rotary
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    # --- quantization (the paper's technique; serve path) ---
    quant: QuantConfig = QuantConfig()
    quant_attention: bool = False    # dynamic int8 attention GEMMs (Sec. 5.7)
    kv_cache_bits: int = 16          # 8 -> int8 KV cache + stored scales
    paged_kernel: bool = False       # paged decode through the live-page
                                     # CUDA kernel (kernels/paged_attention)

    # --- training knobs ---
    dtype: Any = torch.bfloat16
    remat: str = "block"             # none | block (recompute each
                                     # super-block in the backward)
    grad_accum: int = 1              # microbatches a train step
    opt_state_dtype: Any = torch.float32   # AdamW moments (and the
                                           # gradient sum) in bf16 if
                                           # "bfloat16"
    factored_second_moment: bool = False   # Adafactor-style v (huge models)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.block_tail)
        if body % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: {body} body layers do not tile the block "
                f"pattern {self.block_pattern}")
        return body // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test-sized variant of the same family (one super-block repeat
    or two, tiny widths, few experts, small vocab) — the reference's
    ``reduced``."""
    pat = cfg.block_pattern
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return cfg.replace(
        n_layers=len(pat) * min(2, cfg.n_repeats) + len(cfg.block_tail),
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
        d_ff=256 if cfg.d_ff else 0, vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_context_tokens=64 if cfg.n_context_tokens else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        max_target_positions=64 if cfg.max_target_positions else 0,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        quant=cfg.quant.with_(group=64),
        grad_accum=1, remat="none",
    )
