"""Non-attention blocks (port of ``repro.models.blocks``): the dense
SwiGLU MLP and the RG-LRU recurrent block (recurrentgemma). The MoE and
xLSTM blocks are not part of the port yet. Residuals live in model.py;
blocks are pre-norm bodies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
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


# --------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma; arXiv:2402.19427)
# --------------------------------------------------------------------------

RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model

    def lin():
        return linear_init(gen, d, d, cfg.quant, cfg.dtype)
    p = {"norm": torch.ones((d,), dtype=torch.float32, device=gen.device),
         "w_x": lin(), "w_gate": lin(), "w_r": lin(), "w_i": lin()}
    u = torch.rand((d,), generator=gen, dtype=torch.float32,
                   device=gen.device) * (0.999 - 0.9) + 0.9
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))  # softplus^-1
    p["w_out"] = lin()
    return p


def cache_rglru(cfg: ModelConfig, batch: int, device=None):
    return {"h": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device)}


def apply_rglru(params, x, cfg: ModelConfig, *, cache=None, prefill=False):
    """Griffin-style recurrent block (temporal conv omitted, as in the
    reference). Prefill (or no cache) runs the recurrence h_t = a_t h_{t-1}
    + b_t from h_0 = 0 through ``ops.rg_lru`` (B5 on CUDA tensors, its
    plain version on CPU ones) and, with a cache, stores h at the last
    position in it; decode is one elementwise step from the cache, written
    back in place. Returns (y, cache)."""
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    xi = linear_apply(params["w_x"], xn, cfg.quant)
    gate = F.gelu(linear_apply(params["w_gate"], xn, cfg.quant),
                  approximate="tanh")
    r = torch.sigmoid(linear_apply(params["w_r"], xn, cfg.quant)
                      .to(torch.float32))
    i = torch.sigmoid(linear_apply(params["w_i"], xn, cfg.quant)
                      .to(torch.float32))
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r           # (B,S,D) f32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xi.to(torch.float32))
    if cache is None or prefill:
        h0 = torch.zeros((b.shape[0], b.shape[2]), dtype=torch.float32,
                         device=b.device)
        h = ops.rg_lru(b, a, h0)
        if cache is not None:
            cache["h"].copy_(h[:, -1])
    else:
        step = a[:, 0] * cache["h"] + b[:, 0]
        cache["h"].copy_(step)
        h = step[:, None]
    y = linear_apply(params["w_out"], h.to(x.dtype) * gate, cfg.quant)
    return y.to(x.dtype), cache
