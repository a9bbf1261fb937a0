"""Non-attention blocks (port of ``repro.models.blocks``): the dense
SwiGLU MLP, the top-k MoE block and the RG-LRU recurrent block
(recurrentgemma). The xLSTM blocks are not part of the port yet.
Residuals live in model.py; blocks are pre-norm bodies.
"""
from __future__ import annotations

import math

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
# MoE: top-k routing, sorted dispatch, per-expert products
# --------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig):
    """The reference's MoE leaves: an f32 ``norm``; the ``router`` (d, E)
    and the experts ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d)
    as plain ``cfg.dtype`` tensors (the experts are not quantized, as in
    the reference: only attention and the shared expert's linears go
    through the integer GEMM); a ``shared`` SwiGLU MLP when the config
    has shared experts. Each (E, d, f) leaf is drawn in f32 and cast, one
    at a time (the peak of a draw is one f32 leaf)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lim = 1.0 / math.sqrt(d)

    def draw(shape, s):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=gen.device).mul_(s).to(cfg.dtype)
    p = {"norm": torch.ones((d,), dtype=torch.float32, device=gen.device),
         "router": draw((d, e), lim),
         "w_gate": draw((e, d, f), lim),
         "w_up": draw((e, d, f), lim),
         "w_down": draw((e, f, d), 1.0 / math.sqrt(f))}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg)
    return p


def _moe_local(x2, gates, eids, w_gate, w_up, w_down):
    """The experts' products for tokens ``x2`` (N, D) routed to ``eids``
    (N, K) with ``gates`` (N, K) in x2's dtype. The N * K assignments are
    sorted by expert (a stable argsort, as the reference's), so each
    expert's rows are one contiguous group; the groups' ends are found on
    the device (``searchsorted`` over the sorted ids: no host read), and
    the three products, ``silu(x W_gate) * (x W_up)`` then ``W_down``, are
    one ``torch._grouped_mm`` each over all experts in the working dtype
    (the reference's ``ragged_dot``, an XLA op, not a Pallas kernel; an
    expert with no rows reads no weights). Each output row is scaled by
    its gate and put back in (token, slot) order, and a token's K outputs
    are added in slot order: no atomics, so the sum is the same on every
    run. Every assignment is kept (the reference's single-device capacity,
    N * K); the expert-parallel dispatch across devices, with its capacity
    factor, is not ported yet."""
    n, k = eids.shape
    flat_e = eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = x2[order // k]                                  # (N * K, D)
    experts = torch.arange(w_gate.shape[0], dtype=flat_e.dtype,
                           device=flat_e.device)
    offs = torch.searchsorted(flat_e[order], experts,
                              right=True).to(torch.int32)
    h = F.silu(torch._grouped_mm(xs, w_gate, offs=offs)) * torch._grouped_mm(
        xs, w_up, offs=offs)
    out = torch._grouped_mm(h.to(w_down.dtype), w_down, offs=offs)
    scaled = out * gates.reshape(-1)[order, None]
    y = torch.empty_like(scaled)
    y[order] = scaled                                    # (token, slot)
    y = y.view(n, k, -1)
    acc = y[:, 0]
    for j in range(1, k):
        acc = acc + y[:, j]
    return acc


def route(params, x, cfg: ModelConfig):
    """The MoE router: (the normed x, gates (B, S, K) f32, expert ids
    (B, S, K)): the f32 router product, softmax, the top ``cfg.top_k``
    experts and their gates renormalized (floor 1e-9)."""
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = torch.matmul(xn.to(torch.float32),
                          params["router"].to(torch.float32))
    gates, eids = torch.topk(torch.softmax(logits, -1), cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return xn, gates, eids


def apply_moe(params, x, cfg: ModelConfig):
    """Top-k MoE on one device: :func:`route`, the experts through
    :func:`_moe_local`, plus the shared expert's MLP of x where the config
    has one. The router and the experts run under the profiler ranges
    ``moe.router`` and ``moe.experts``."""
    b, s, d = x.shape
    with torch.profiler.record_function("moe.router"):
        xn, gates, eids = route(params, x, cfg)
    with torch.profiler.record_function("moe.experts"):
        y = _moe_local(xn.reshape(b * s, d),
                       gates.reshape(b * s, -1).to(x.dtype),
                       eids.reshape(b * s, -1), params["w_gate"],
                       params["w_up"], params["w_down"]).reshape(b, s, d)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, cfg)
    return y.to(x.dtype)


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
