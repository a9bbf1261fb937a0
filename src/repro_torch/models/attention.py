"""Attention (port of ``repro.models.attention``, self-attention serving
slice): RMSNorm, RoPE, GQA attention with the paper's dynamic int8
quantized attention GEMMs, the dense KV cache, and the paged KV pool of
the continuous-batching serve engine.

Integer products that the reference leaves to XLA (``_scores``/``_pv``,
``attend_cached``) go through :func:`repro_torch.core.backend.int_matmul`
semantics: float64 einsums, exact for int8 operands, cast to int32.
Pools and caches are updated in place where the reference donates its
buffers. Prefill over more than ``CHUNK_THRESHOLD`` positions takes
``attend_chunked`` (float, query chunks of ``Q_CHUNK``), and a local
window keeps a rolling dense cache of ``min(max_len, window)`` slots.
Cross-attention (:func:`apply_cross`) attends from the decoder's
positions to context embeddings (an encoder's output or a frontend's
stub): no RoPE, a dense cache of the context's K/V in the working dtype
(never int8) written at prefill and read alone at decode.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import linear_apply, linear_init, quantize_per_token
from repro_torch.quant.quantize import true_div
from repro_torch.tracepoints import scope

NEG_INF = -1e30
CHUNK_THRESHOLD = 2048        # direct softmax below, chunked above
Q_CHUNK = 1024                # query-chunk size of attend_chunked


def _int_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 einsum with an int32 result (float64 inside)."""
    with scope("int_einsum"):
        return torch.einsum(spec, a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    out = (x * torch.rsqrt(var + eps).to(x.dtype)) * scale
    return out.to(x.dtype)          # keep activations in the working dtype


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         partial: bool = False) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S). partial=True rotates only the first
    half of head_dim."""
    d = x.shape[-1]
    rot_d = d // 2 if partial else d
    exps = -torch.arange(0, rot_d, 2, dtype=torch.float32,
                         device=x.device) / rot_d
    # a Python base (aten.pow.Scalar, rounded to float32 like exps): no
    # host data enters the call
    freqs = torch.pow(float(theta), exps)
    ang = positions[..., None].to(torch.float32) * freqs      # (B, S, rd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot_d].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    out = out.reshape(xr.shape).to(x.dtype)
    if partial:
        out = torch.cat([out, x[..., rot_d:]], -1)
    return out


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*groups, D)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _quantize_kv(t: torch.Tensor):
    """KV8 cache quantization, always from float32: the stored (int8, scale)
    pair is then a function of the row values alone."""
    with scope("quantize_kv"):
        return quantize_per_token(t.to(torch.float32))


def _scores(q, k, scale, quant: bool):
    """einsum('bqhd,bkhd->bhqk'), optionally with dynamic-int8 operands."""
    if quant:
        qq, sq = quantize_per_token(q)                    # (B,Sq,H,1)
        kk, sk = quantize_per_token(k)                    # (B,Sk,H,1)
        s32 = _int_einsum("bqhd,bkhd->bhqk", qq, kk)
        sq_b = sq.movedim(2, 1)                           # (B,H,Sq,1)
        sk_b = sk.movedim(2, 1)[..., 0][:, :, None, :]    # (B,H,1,Sk)
        return s32.to(torch.float32) * sq_b * sk_b * scale
    return torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale


def _pv(p, v, quant: bool):
    """P (B,H,Sq,Sk) @ V (B,Sk,H,D) -> (B,Sq,H,D), optionally int8."""
    if quant:
        qp, sp = quantize_per_token(p)                    # rows over Sk
        sv = true_div(v.abs().amax(dim=1, keepdim=True), 127.) + 1e-8
        qv = torch.clamp(torch.round(v / sv), -128, 127).to(torch.int8)
        o32 = _int_einsum("bhqk,bkhd->bqhd", qp, qv)
        return o32.to(torch.float32) * sp.movedim(1, 2) * sv
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attend_full(q, k, v, mask, scale, quant: bool = False):
    """Direct softmax attention. q (B,Sq,H,D), k/v (B,Sk,H,D) repeated."""
    s = _scores(q, k, scale, quant)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return _pv(p, v, quant)


def attend_chunked(q, k, v, scale, causal: bool, window: int,
                   q_offset=0, kv_len=None):
    """Query-chunked float attention, the reference's path above
    ``CHUNK_THRESHOLD``: each chunk of ``Q_CHUNK`` queries (the whole of
    ``q`` when Sq is not a multiple of it) sees the full K/V, so the score
    tile is (chunk, Sk) and no softmax state is carried. Masks: causal,
    ``qpos - kpos < window`` where ``window``, ``kpos < kv_len`` where
    given; queries sit at ``q_offset + i``.

    q (B,Sq,H,D); k/v (B,Sk,H,D) already GQA-repeated."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    cq = Q_CHUNK if sq % Q_CHUNK == 0 else sq
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, sq, cq):
        qpos = q_offset + c0 + torch.arange(cq, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, c0:c0 + cq], k) \
            .to(torch.float32) * scale
        ok = torch.ones((cq, sk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= qpos[:, None] >= kpos[None, :]
        if window:
            ok &= qpos[:, None] - kpos[None, :] < window
        if kv_len is not None:
            ok &= kpos[None, :] < kv_len
        s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v))
    return torch.cat(outs, dim=1)


def attend_cached(q, ck, cv, cks, cvs, valid, cfg: ModelConfig, scale):
    """Decode-step attention against a contiguous (B, S, KV, D) cache view.

    q (B, Sq, H, D); ck/cv the cached keys/values — int8 with cks/cvs
    per-position scales for the KV8 layout, else the working dtype; valid
    (B', S) bool with B' in {1, B}. The one implementation of cached
    decode attention: the dense cache and the paged gather path both call
    it, and it is the plain version of the paged-attention kernel.
    """
    b, sq, h, hd = q.shape
    kv = ck.shape[2]
    groups = h // kv
    int8_cache = ck.dtype == torch.int8
    qg = q.reshape(b, sq, kv, groups, hd)
    if cfg.quant_attention:
        qq, sqs = quantize_per_token(qg)             # (B,1,KV,G,1)
        if int8_cache:
            kk, sks = ck, cks
        else:
            kk, sks = quantize_per_token(ck)         # (B,S,KV,1)
        s32 = _int_einsum("bqkgd,bskd->bkgqs", qq, kk)
        sk_b = sks[..., 0].permute(0, 2, 1)[:, :, None, None, :]
        s = (s32.to(torch.float32) * scale
             * sqs.movedim(1, 3)                      # (B,KV,G,1,1)
             * sk_b)                                  # (B,KV,1,1,S)
    elif int8_cache:
        kf = ck.to(torch.float32) * cks
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                         kf) * scale
    else:
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck) \
            .to(torch.float32) * scale
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if cfg.quant_attention:
        if int8_cache:
            # fold the per-position V scales into P before quantizing
            vs_b = cvs[..., 0].permute(0, 2, 1)[:, :, None, None, :]
            qp, sps = quantize_per_token(p * vs_b)
            qv = cv
            sv_out = 1.0
        else:
            qp, sps = quantize_per_token(p)
            sv = true_div(cv.abs().amax(dim=1, keepdim=True), 127.) + 1e-8
            qv = torch.clamp(torch.round(cv / sv), -128, 127) \
                .to(torch.int8)
            sv_out = sv[:, :, :, None, :]
        o32 = _int_einsum("bkgqs,bskd->bqkgd", qp, qv)
        out = (o32.to(torch.float32) * sps.movedim(-1, 1) * sv_out)
    elif int8_cache:
        vf = cv.to(torch.float32) * cvs
        out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    else:
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(cv.dtype), cv)
    return out.reshape(b, sq, h, hd)


# --------------------------------------------------------------------------
# Block-level self-attention with a dense cache
# --------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig):
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    qcfg = cfg.quant
    ones = lambda n: torch.ones((n,), dtype=torch.float32, device=gen.device)
    p = {
        "norm": ones(cfg.d_model),
        "wq": linear_init(gen, cfg.d_model, h * hd, qcfg, cfg.dtype),
        "wk": linear_init(gen, cfg.d_model, kv * hd, qcfg, cfg.dtype),
        "wv": linear_init(gen, cfg.d_model, kv * hd, qcfg, cfg.dtype),
        "wo": linear_init(gen, h * hd, cfg.d_model, qcfg, cfg.dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones(hd)
        p["k_norm"] = ones(hd)
    return p


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: int = 0, cross: bool = False, device=None):
    """One layer's dense cache: ``max_len`` slots, or a rolling cache of
    ``min(max_len, window)`` slots for a local window. KV8 configs keep
    int8 codes and per-position scales, except in a ``cross`` cache,
    which always holds the working dtype."""
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if cfg.kv_cache_bits == 8 and not cross:
        return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                "ks": z(shape[:-1] + (1,), torch.float32),
                "vs": z(shape[:-1] + (1,), torch.float32)}
    return {"k": z(shape, cfg.dtype), "v": z(shape, cfg.dtype)}


def _qkv(params, x, cfg: ModelConfig, positions):
    """Pre-norm q/k/v projections with optional qk-norm and RoPE."""
    qcfg = cfg.quant
    b, sq, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    q = linear_apply(params["wq"], xn, qcfg).reshape(b, sq, h, hd)
    k = linear_apply(params["wk"], xn, qcfg).reshape(b, sq, kv, hd)
    v = linear_apply(params["wv"], xn, qcfg).reshape(b, sq, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_2d)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_2d)
    return q, k, v


def _out_proj(params, out, x, cfg: ModelConfig):
    b, sq = out.shape[:2]
    out = out.reshape(b, sq, -1)
    y = linear_apply(params["wo"], out.to(x.dtype), cfg.quant)
    return y.to(x.dtype)


def _kv_stores(k, v, int8: bool) -> dict:
    if int8:
        qk, ks = _quantize_kv(k)
        qv, vs = _quantize_kv(v)
        return {"k": qk, "v": qv, "ks": ks, "vs": vs}
    return {"k": k, "v": v}


def _write_prompt(cache, k, v, allow_roll: bool) -> None:
    """Write a prompt's (or a context's) K/V (B, S, KV, D) into a dense
    cache in place: its last ``min(size, S)`` positions, position p at
    slot p % size (int8 codes and scales for a KV8 cache)."""
    size, sq = cache["k"].shape[1], k.shape[1]
    if sq > size and not allow_roll:
        raise ValueError(f"prompt of {sq} exceeds the cache ({size})")
    take = min(size, sq)
    slots = (torch.arange(take, device=k.device) + (sq - take)) % size
    int8 = cache["k"].dtype == torch.int8
    for name, val in _kv_stores(k[:, sq - take:], v[:, sq - take:],
                                int8).items():
        cache[name][:, slots] = val.to(cache[name].dtype)


def apply_cross(params, x, cfg: ModelConfig, *, context=None, cache=None):
    """Cross-attention block body (pre-norm, residual outside): queries
    from x, no RoPE. With ``context`` (B, Sc, d) its K/V are projected,
    written in place to ``cache`` where one is given (prefill), and every
    query attends to every context position; without it (decode) the K/V
    come from the cache alone, over all of its positions. Returns (out,
    cache)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, sq, _ = x.shape
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    q = linear_apply(params["wq"], xn, cfg.quant).reshape(b, sq, h, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    scale = hd ** -0.5
    if context is None:
        size = cache["k"].shape[1]
        valid = torch.ones((1, size), dtype=torch.bool, device=x.device)
        out = attend_cached(q, cache["k"], cache["v"], None, None, valid,
                            cfg, scale)
        return _out_proj(params, out, x, cfg), cache
    sc = context.shape[1]
    k = linear_apply(params["wk"], context, cfg.quant).reshape(b, sc, kv, hd)
    v = linear_apply(params["wv"], context, cfg.quant).reshape(b, sc, kv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cache is not None:
        _write_prompt(cache, k, v, allow_roll=True)
    groups = h // kv
    mask = torch.ones((b, 1, sq, sc), dtype=torch.bool, device=x.device)
    out = attend_full(q, _repeat_kv(k, groups), _repeat_kv(v, groups), mask,
                      scale, cfg.quant_attention)
    return _out_proj(params, out, x, cfg), cache


def apply_attn(params, x, cfg: ModelConfig, *, positions, cache=None,
               step=None, window=0, prefill=False, causal=True):
    """Self-attention block body (pre-norm, residual outside), causal
    unless ``causal=False`` (the encoder's; cross-attention is
    :func:`apply_cross`).

    Modes: train (cache=None), prefill (cache given, filled in place with
    the prompt's K/V), decode (cache given, position ``step`` written in
    place). With a local ``window`` prefill masks ``qpos - kpos <
    window``, and the cache rolls: position p lives in slot p % size, the
    prompt's last ``size`` positions are kept and decode attends over
    the ``min(step + 1, size)`` filled slots. Returns (out, cache)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, sq, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    scale = hd ** -0.5
    groups = h // kv

    if cache is None or prefill:
        if cache is not None:
            _write_prompt(cache, k, v, allow_roll=bool(window))
        kf, vf = _repeat_kv(k, groups), _repeat_kv(v, groups)
        if sq > CHUNK_THRESHOLD:
            out = attend_chunked(q, kf, vf, scale, causal, window)
        else:
            qp = positions[:, :, None]
            kp = positions[:, None, :]
            mask = qp >= kp if causal else torch.ones(
                (b, sq, sq), dtype=torch.bool, device=x.device)
            if window:
                mask &= qp - kp < window
            out = attend_full(q, kf, vf, mask[:, None], scale,
                              cfg.quant_attention)
    else:
        size = cache["k"].shape[1]
        slot = step % size if window else step
        int8 = cache["k"].dtype == torch.int8
        for name, val in _kv_stores(k, v, int8).items():
            cache[name][:, slot] = val[:, 0].to(cache[name].dtype)
        lanes = torch.arange(size, device=x.device)
        valid = (lanes < min(step + 1, size))[None, :]
        out = attend_cached(q, cache["k"], cache["v"], cache.get("ks"),
                            cache.get("vs"), valid, cfg, scale)
    return _out_proj(params, out, x, cfg), cache


# --------------------------------------------------------------------------
# Paged KV cache (the continuous-batching serve path, repro_torch.serve)
# --------------------------------------------------------------------------
#
# One layer's pool: (n_pages, page_size, KV, D) K/V buffers (+ per-position
# scales under KV8) shared by every slot, addressed through an int32 page
# table. Logical position p of a slot lives at (page_indices[slot, p //
# page_size], p % page_size); page 0 is the null page (never allocated —
# inactive slots point at it and their writes land in it).

def init_attn_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                        device=None):
    """One attention layer's page pool (unstacked; Model stacks layers)."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if cfg.kv_cache_bits == 8:
        return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                "ks": z(shape[:-1] + (1,), torch.float32),
                "vs": z(shape[:-1] + (1,), torch.float32)}
    return {"k": z(shape, cfg.dtype), "v": z(shape, cfg.dtype)}


def _gather_pages(buf, page_indices):
    """(n_pages, ps, ...) gathered to a contiguous (B, P*ps, ...) view in
    logical-position order."""
    g = buf[page_indices.long()]                # (B, P, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def attend_paged_gather(q, pool, page_indices, steps, cfg: ModelConfig,
                        scale):
    """Decode attention over a page pool by gathering every slot's full
    page extent and masking lanes past its step (:func:`attend_cached`):
    the oracle, and the plain version of the paged-attention kernel."""
    int8_pool = pool["k"].dtype == torch.int8
    ck = _gather_pages(pool["k"], page_indices)
    cv = _gather_pages(pool["v"], page_indices)
    cks = _gather_pages(pool["ks"], page_indices) if int8_pool else None
    cvs = _gather_pages(pool["vs"], page_indices) if int8_pool else None
    size = ck.shape[1]
    lanes = torch.arange(size, device=q.device)
    valid = lanes[None, :] < torch.clamp(steps.long() + 1, max=size)[:, None]
    return attend_cached(q, ck, cv, cks, cvs, valid, cfg, scale)


def apply_attn_paged_prefill(params, x, cfg: ModelConfig, *, pool,
                             prefix_page_ids, write_page_ids, write_offs,
                             write_from: int):
    """Suffix prefill for ONE request (B=1) against a page pool.

    ``x`` (1, Ls, d) embeds the prompt suffix at positions start..L-1,
    ``start = len(prefix_page_ids) * page_size`` (the trie-shared range,
    gathered from the pool). Suffix K/V rows ``write_from..`` are written
    in place to ``(write_page_ids[i], write_offs[i])``. Returns (out, pool).
    """
    b, ls, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ps = pool["k"].shape[1]
    n_pre = len(prefix_page_ids)
    start = n_pre * ps
    total = start + ls
    qpos = (start + torch.arange(ls, device=x.device)).expand(b, ls)
    q, k, v = _qkv(params, x, cfg, qpos)
    scale = hd ** -0.5

    int8_pool = pool["k"].dtype == torch.int8
    wp, wo = write_page_ids.long(), write_offs.long()
    for name, val in _kv_stores(k, v, int8_pool).items():
        pool[name][wp, wo] = val[0, write_from:].to(pool[name].dtype)

    if n_pre:
        pre = prefix_page_ids.long()
        k_pre = pool["k"][pre].reshape(1, start, kvh, hd)
        v_pre = pool["v"][pre].reshape(1, start, kvh, hd)
        k_full = torch.cat([k_pre.to(k.dtype), k], dim=1)
        v_full = torch.cat([v_pre.to(v.dtype), v], dim=1)
    else:
        k_full, v_full = k, v
    groups = h // kvh
    kf, vf = _repeat_kv(k_full, groups), _repeat_kv(v_full, groups)
    # the dense prefill's threshold, on the total length (prefix + suffix)
    if total > CHUNK_THRESHOLD:
        out = attend_chunked(q, kf, vf, scale, True, 0, q_offset=start)
    else:
        kpos = torch.arange(total, device=x.device)
        mask = qpos[:, :, None] >= kpos[None, None, :]
        out = attend_full(q, kf, vf, mask[:, None], scale,
                          cfg.quant_attention)
    return _out_proj(params, out, x, cfg), pool


def apply_attn_paged_prefill_batched(params, x, cfg: ModelConfig, *, pool,
                                     prefix_page_ids, prefix_lens,
                                     suffix_lens, write_page_ids, write_offs,
                                     write_pos):
    """Bucket-padded batched prefill: N requests' suffixes in ONE call.

    ``x`` (B, Lb, d) holds each row's suffix left-aligned and zero-padded;
    ``prefix_page_ids`` (B, PPb) the shared prefix pages padded with the
    null page, ``prefix_lens``/``suffix_lens`` (B,) the real extents. Write
    lane i of row b stores suffix row ``write_pos[b, i]`` at
    ``(write_page_ids[b, i], write_offs[b, i])`` in place (dead lanes hit
    the null page). Padded K/V lanes are zeroed before attention so the
    int8 P.V absmax sees the unpadded extent. Returns (out, pool).
    """
    b, ls, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ps = pool["k"].shape[1]
    n_pre = prefix_page_ids.shape[1]
    start = n_pre * ps
    total = start + ls
    if total > CHUNK_THRESHOLD:
        raise NotImplementedError(
            "bucketed prefill is full-extent only; the engine falls back "
            "to per-request prefill above CHUNK_THRESHOLD")
    dev = x.device
    qpos = prefix_lens[:, None].long() + torch.arange(ls, device=dev)[None]
    q, k, v = _qkv(params, x, cfg, qpos)
    scale = hd ** -0.5

    int8_pool = pool["k"].dtype == torch.int8
    wp, wo = write_page_ids.long(), write_offs.long()
    gather = write_pos.long()[:, :, None, None]
    for name, val in _kv_stores(k, v, int8_pool).items():
        rows = torch.take_along_dim(val, gather, dim=1)       # (B, Lb, ...)
        pool[name][wp, wo] = rows.to(pool[name].dtype)

    suf_idx = torch.arange(ls, device=dev)
    suf_valid = suf_idx[None, :] < suffix_lens[:, None]        # (B, Lb)
    if n_pre:
        pre_valid = (torch.arange(start, device=dev)[None, :]
                     < prefix_lens[:, None])
        pre = prefix_page_ids.long()
        k_pre = pool["k"][pre].reshape(b, start, kvh, hd)
        v_pre = pool["v"][pre].reshape(b, start, kvh, hd)
        k_full = torch.cat([k_pre.to(k.dtype), k], dim=1)
        v_full = torch.cat([v_pre.to(v.dtype), v], dim=1)
        key_valid = torch.cat([pre_valid, suf_valid], dim=1)
    else:
        k_full, v_full = k, v
        key_valid = suf_valid
    kv_mask = key_valid[:, :, None, None]
    k_full = torch.where(kv_mask, k_full, torch.zeros_like(k_full))
    v_full = torch.where(kv_mask, v_full, torch.zeros_like(v_full))
    groups = h // kvh
    causal = suf_idx[None, :, None] >= suf_idx[None, None, :]  # (1, Lb, Lb)
    mask_suf = causal & suf_valid[:, None, :]
    if n_pre:
        mask_pre = pre_valid[:, None, :].expand(b, ls, start)
        mask = torch.cat([mask_pre, mask_suf], dim=2)
    else:
        mask = mask_suf
    out = attend_full(q, _repeat_kv(k_full, groups),
                      _repeat_kv(v_full, groups), mask[:, None], scale,
                      cfg.quant_attention)
    return _out_proj(params, out, x, cfg), pool


def apply_attn_paged_decode(params, x, cfg: ModelConfig, *, pool,
                            page_indices, steps, kernel: bool | None = None):
    """One paged decode step over all slots. x (B, 1, d); page_indices
    (B, P) int32; steps (B,) int32 — the position each slot writes. The new
    K/V row is written into the pool in place. Returns (out, pool).

    ``kernel`` (default ``cfg.paged_kernel``) routes attention through the
    live-page CUDA kernel (:mod:`repro_torch.kernels.paged_attention`); the
    gather path (:func:`attend_paged_gather`) is its plain version and the
    oracle.
    """
    hd = cfg.hd
    ps = pool["k"].shape[1]
    pos = steps[:, None].long()
    q, k, v = _qkv(params, x, cfg, pos)
    scale = hd ** -0.5

    st = steps.long()
    page = torch.take_along_dim(page_indices.long(), (st // ps)[:, None],
                                dim=1)[:, 0]
    off = st % ps
    int8_pool = pool["k"].dtype == torch.int8
    for name, val in _kv_stores(k, v, int8_pool).items():
        pool[name][page, off] = val[:, 0].to(pool[name].dtype)

    if kernel is None:
        kernel = cfg.paged_kernel
    if kernel:
        from repro_torch.kernels.paged_attention import paged_attention
        out = paged_attention(q, pool, page_indices, steps, cfg, scale)
    else:
        out = attend_paged_gather(q, pool, page_indices, steps, cfg, scale)
    return _out_proj(params, out, x, cfg), pool
