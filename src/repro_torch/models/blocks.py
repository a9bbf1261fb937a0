"""Dense SwiGLU MLP block (port of ``repro.models.blocks``; the MoE and
recurrent blocks are not part of this slice). Residuals live in model.py;
blocks are pre-norm bodies."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import rms_norm
from repro_torch.quant import linear_apply, linear_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    return {"norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=gen.device),
            "up": linear_init(gen, cfg.d_model, cfg.d_ff, cfg.quant,
                              cfg.dtype),
            "down": linear_init(gen, cfg.d_ff, cfg.d_model, cfg.quant,
                                cfg.dtype),
            "gate": linear_init(gen, cfg.d_model, cfg.d_ff, cfg.quant,
                                cfg.dtype)}


def apply_mlp(params, x, cfg: ModelConfig):
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    up = linear_apply(params["up"], xn, cfg.quant)
    gate = linear_apply(params["gate"], xn, cfg.quant)
    h = F.silu(gate) * up
    return linear_apply(params["down"], h, cfg.quant).to(x.dtype)
