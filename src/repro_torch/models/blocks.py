"""Non-attention blocks (port of ``repro.models.blocks``): the dense
MLP (SwiGLU, or GELU for the ``audio`` family), the top-k MoE block, the
RG-LRU recurrent block (recurrentgemma) and the xLSTM blocks (mLSTM,
chunkwise parallel over a prompt; sLSTM, a loop over positions).
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


def init_mlp(gen: torch.Generator, cfg: ModelConfig, gelu: bool = False):
    """SwiGLU (``up``, ``down``, ``gate``), or with ``gelu`` the two-matrix
    GELU MLP (no ``gate``)."""
    p = {"norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                            device=gen.device),
         "up": linear_init(gen, cfg.d_model, cfg.d_ff, cfg.quant, cfg.dtype),
         "down": linear_init(gen, cfg.d_ff, cfg.d_model, cfg.quant,
                             cfg.dtype)}
    if not gelu:
        p["gate"] = linear_init(gen, cfg.d_model, cfg.d_ff, cfg.quant,
                                cfg.dtype)
    return p


def apply_mlp(params, x, cfg: ModelConfig):
    """``silu(gate) * up`` where the params have a gate, else the
    tanh-form GELU of ``up`` (``jax.nn.gelu``'s default), then ``down``."""
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    up = linear_apply(params["up"], xn, cfg.quant)
    if "gate" in params:
        gate = linear_apply(params["gate"], xn, cfg.quant)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
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


# --------------------------------------------------------------------------
# xLSTM blocks (arXiv:2405.04517): chunkwise-parallel mLSTM, looped sLSTM
# --------------------------------------------------------------------------

MLSTM_CHUNK = 64


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)`` with the reference's softplus, ``logaddexp(-x,
    0) = max(-x, 0) + log1p(exp(-|x|))`` on every input (torch's
    ``softplus`` returns its input above ``threshold``)."""
    return -(torch.clamp(-x, min=0) + torch.log1p(torch.exp(-x.abs())))


def init_mlstm(gen: torch.Generator, cfg: ModelConfig):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd

    def lin(i, o):
        return linear_init(gen, i, o, cfg.quant, cfg.dtype)
    return {"norm": torch.ones((d,), dtype=torch.float32, device=gen.device),
            "w_q": lin(d, h * hd), "w_k": lin(d, h * hd),
            "w_v": lin(d, h * hd), "w_if": lin(d, 2 * h),
            "w_o": lin(h * hd, d)}


def cache_mlstm(cfg: ModelConfig, batch: int, device=None):
    h, hd = cfg.n_heads, cfg.hd
    return {"C": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, hd), dtype=torch.float32,
                             device=device)}


def _mlstm_proj(params, x, cfg: ModelConfig):
    """q, k, v (B, S, H, hd) in x's dtype (k scaled by hd^-0.5 there, the
    scale rounded to that dtype first, as a JAX weak-typed scalar is), and
    the gates' logs (B, S, H) in f32."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    q = linear_apply(params["w_q"], xn, cfg.quant).reshape(b, s, h, hd)
    k_scale = torch.tensor(hd ** -0.5, dtype=x.dtype).item()
    k = linear_apply(params["w_k"], xn, cfg.quant).reshape(b, s, h, hd) \
        * k_scale
    v = linear_apply(params["w_v"], xn, cfg.quant).reshape(b, s, h, hd)
    gif = linear_apply(params["w_if"], xn, cfg.quant).reshape(b, s, h, 2)
    log_i = gif[..., 0].to(torch.float32)                # input gate (log)
    log_f = _log_sigmoid(gif[..., 1].to(torch.float32))  # forget gate (log)
    return q, k, v, log_i, log_f


def _mlstm_chunkwise(q, k, v, log_i, log_f, C0, n0):
    """The stabilizer-free chunkwise form over a whole prompt, in f32:
    chunks of ``MLSTM_CHUNK`` positions (one chunk of S where S is not a
    multiple of it, as in the reference); inside a chunk the decay matrix
    exp(F_t - F_u + log i_u), u <= t; across chunks the (C, n) summaries
    carried by a loop over chunks from (C0, n0). Returns (out (B, S, H,
    hd), C, n at the end)."""
    b, s, h, hd = q.shape
    c = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else s
    nc = s // c

    def resh(t):
        return t.reshape(b, nc, c, *t.shape[2:])
    qc, kc, vc = (resh(t.to(torch.float32)) for t in (q, k, v))
    lic, lfc = resh(log_i), resh(log_f)
    fc = torch.cumsum(lfc, dim=2)                        # (B,NC,C,H)
    ftot = fc[:, :, -1]
    decay = fc[:, :, :, None, :] - fc[:, :, None, :, :] + lic[:, :, None]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    # exp overflows above the diagonal: select, never multiply by a mask
    a = torch.where(tri[None, None, :, :, None], torch.exp(decay),
                    torch.zeros((), dtype=torch.float32, device=q.device))
    scores = torch.einsum("bnthd,bnuhd->bntuh", qc, kc) * a
    intra = torch.einsum("bntuh,bnuhd->bnthd", scores, vc)
    n_intra = torch.einsum("bntuh,bnuhd->bnthd", a, kc)
    w_end = torch.exp(ftot[:, :, None, :] - fc + lic)    # (B,NC,C,H)
    kv_sum = torch.einsum("bnuh,bnuhk,bnuhv->bnhkv", w_end, kc, vc)
    k_sum = torch.einsum("bnuh,bnuhk->bnhk", w_end, kc)
    cs, ns = [], []
    cm, nm = C0, n0
    for j in range(nc):                                  # the reference's scan
        cs.append(cm)
        ns.append(nm)
        e = torch.exp(ftot[:, j])
        cm = e[..., None, None] * cm + kv_sum[:, j]
        nm = e[..., None] * nm + k_sum[:, j]
    c_hist = torch.stack(cs, dim=1)                      # (B,NC,H,K,V)
    n_hist = torch.stack(ns, dim=1)                      # (B,NC,H,K)
    ef = torch.exp(fc)[..., None]
    inter = torch.einsum("bnthd,bnhdv->bnthv", qc * ef, c_hist)
    n_inter = n_hist[:, :, None] * ef
    num = intra + inter
    den = torch.einsum("bnthd,bnthd->bnth", qc, n_intra + n_inter).abs()
    out = num / torch.clamp(den, min=1.0)[..., None]
    return out.reshape(b, s, h, hd), cm, nm


def apply_mlstm(params, x, cfg: ModelConfig, *, cache=None, prefill=False):
    """Matrix-memory LSTM. Without a cache, or at prefill, the chunkwise
    form over the prompt (from the cache's state, written back in place
    at prefill); with a cache otherwise, one decode step from C (B, H, hd,
    hd) and n (B, H, hd), in f32, written back in place. Returns (y,
    cache)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q, k, v, log_i, log_f = _mlstm_proj(params, x, cfg)
    if cache is not None and not prefill:                # decode step
        i_g = torch.exp(log_i[:, 0])                     # (B,H)
        f_g = torch.exp(log_f[:, 0])
        k0, v0, q0 = (t[:, 0].to(torch.float32) for t in (k, v, q))
        kv = torch.einsum("bhk,bhv->bhkv", k0, v0)
        cm = f_g[..., None, None] * cache["C"] + i_g[..., None, None] * kv
        nm = f_g[..., None] * cache["n"] + i_g[..., None] * k0
        num = torch.einsum("bhkv,bhk->bhv", cm, q0)
        den = torch.einsum("bhk,bhk->bh", nm, q0).abs()
        out = (num / torch.clamp(den, min=1.0)[..., None])[:, None]
        cache["C"].copy_(cm)
        cache["n"].copy_(nm)
    else:                                                # chunkwise
        if cache is not None:
            c0, n0 = cache["C"], cache["n"]
        else:
            c0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                             device=x.device)
            n0 = torch.zeros((b, h, hd), dtype=torch.float32,
                             device=x.device)
        out, cm, nm = _mlstm_chunkwise(q, k, v, log_i, log_f, c0, n0)
        if cache is not None:
            cache["C"].copy_(cm)
            cache["n"].copy_(nm)
    y = linear_apply(params["w_o"],
                     out.reshape(b, -1, h * hd).to(x.dtype), cfg.quant)
    return y.to(x.dtype), cache


def init_slstm(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    p = {"norm": torch.ones((d,), dtype=torch.float32, device=gen.device)}
    for name in ("w_z", "r_z", "w_i", "r_i", "w_f", "r_f", "w_o", "r_o",
                 "w_out"):
        p[name] = linear_init(gen, d, d, cfg.quant, cfg.dtype)
    return p


def cache_slstm(cfg: ModelConfig, batch: int, device=None):
    return {name: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                              device=device) for name in "hcnm"}


def _slstm_step(params, cfg: ModelConfig, state, xt):
    """One stabilized exponential-gated step from ``state`` (h, c, n, m in
    f32) at xt (B, D). Each gate adds its two linears (on xt and on h cast
    to xt's dtype) in that dtype, then casts to f32; the linears run in
    the reference's order (z, o, i, f; w before r)."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    hx = h.to(xt.dtype)

    def gate(wk, rk):
        return (linear_apply(params[wk], xt, cfg.quant)
                + linear_apply(params[rk], hx, cfg.quant)).to(torch.float32)
    z = torch.tanh(gate("w_z", "r_z"))
    o = torch.sigmoid(gate("w_o", "r_o"))
    log_i = gate("w_i", "r_i")
    log_f = _log_sigmoid(gate("w_f", "r_f"))
    m_new = torch.maximum(log_f + m, log_i)
    keep = torch.exp(log_f + m - m_new)
    write = torch.exp(log_i - m_new)
    c_new = keep * c + write * z
    n_new = keep * n + write
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def apply_slstm(params, x, cfg: ModelConfig, *, cache=None, prefill=False):
    """Scalar-memory LSTM: a loop over positions from the cache's state at
    prefill (zeros without a cache), or one step from it at decode; the
    cache is written back in place. ``w_out`` runs once over every
    position's h. Returns (y, cache)."""
    b, s, _ = x.shape
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    if cache is not None and not prefill:
        state = _slstm_step(params, cfg, cache, xn[:, 0])
        y = state["h"][:, None]
    else:
        state = cache if cache is not None else cache_slstm(
            cfg, b, device=x.device)
        hs = []
        for t in range(s):
            state = _slstm_step(params, cfg, state, xn[:, t])
            hs.append(state["h"])
        y = torch.stack(hs, dim=1)
    if cache is not None:
        for name, val in state.items():
            cache[name].copy_(val)
    y = linear_apply(params["w_out"], y.to(x.dtype), cfg.quant)
    return y.to(x.dtype), cache
