"""Live-page paged-attention decode kernel (CUDA C++,
``csrc/paged_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/paged_attention.py``
(``paged_attention``) in all four of its pool layouts, one template
instance of the kernel each (:data:`LAYOUTS`):

  * int8 pool, quantized attention (``kv_cache_bits=8``,
    ``quant_attention=True``): the serving layout;
  * exact pool (the working dtype, bf16 or f32), quantized attention;
  * exact pool, float attention (the unquantized ``--fp`` serve);
  * int8 pool, float attention.

:func:`paged_attention` prepares q as the reference's wrapper does (per
token int8 codes in q's own dtype under quantized attention; f32 in the
int8 pool's float layout; as it is in the exact pool's), then on CUDA
tensors launches one thread block cluster per (slot, KV head, block of at
most 8 of its query heads), whose ranks split the slot's live pages and
reduce the row statistics through distributed shared memory
(:func:`launch_plan` chooses the cluster size, the pages per rank, the
rows staged at once and the blocks of heads); on CPU tensors it runs
:func:`paged_attention_plain`, the gather + ``attend_cached`` path. Each
launch adds one to ``paged_attention.launches``. The kernel's softmax and
float dots sum in another order than the plain version, so the two agree
within the bounds of :func:`agreement`, not bit for bit.

The kernel takes any number G of query heads per KV head (more than 8
are served by ``ceil(G / 8)`` clusters of heads, each staging the KV
head's pages again) and any head dimension, as the reference's does: a
row is staged at a stride rounded up to 16 bytes with a zero tail, in
the widest copy unit that divides the row and the pools' bases (a view
at any offset is read in place), and P.V runs in passes of 512 elements
of the head. :func:`launch_plan` refuses only a block that would not fit
shared memory with a single staged row.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.quant.quantize import quantize_per_token

__all__ = ["paged_attention", "paged_attention_plain", "agreement",
           "float_roundings", "bf16_neighbours", "launch_plan", "smem_bytes",
           "heads_per_block", "LaunchPlan", "LAYOUTS", "ROW_BUDGET"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# (quant_attention, int8 pool) -> the kernel's layout code and name
LAYOUTS = {(True, True): (0, "int8 pool + int8 attention"),
           (True, False): (1, "exact pool + int8 attention"),
           (False, False): (2, "exact pool + float attention"),
           (False, True): (3, "int8 pool + float attention")}
_POOL_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


# The kernel's constants (csrc/paged_attention.cu): threads per block,
# query heads per block at most, blocks per cluster at most (the portable
# size) and the shared memory a block may use.
THREADS, MAX_G, MAX_CLUSTER = 128, 8, 8
SMEM_LIMIT = 232448


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def heads_per_block(g: int) -> int:
    """The query heads one block serves out of ``g`` per KV head: ``g`` cut
    into ceil(g / MAX_G) blocks as even as they come (16: 8 and 8; 9: 5
    and 4)."""
    n = -(-g // MAX_G)
    return -(-g // n)


def smem_bytes(g: int, hd: int, itemsize: int, int8_pool: bool,
               quant: bool, lanes: int, chunk_rows: int) -> int:
    """A block's dynamic shared memory for ``g`` query heads per KV head,
    as the kernel carves it (``smem_bytes`` in the CUDA source) for the
    block's gb = :func:`heads_per_block` (g) heads, with rows staged at
    srb = ``hd * itemsize`` rounded up to 16 bytes (hdp = srb / itemsize
    elements): the K chunk (which later holds the P.V partial sums of the
    block's parts, 4 * gb * max(4 * THREADS, hdp) bytes), the V chunk, the
    chunk's K scales and every lane's V scale (int8 pool), the score row
    (gb * lanes f32), the inbox of the P.V sums this rank adds (gb * hdp +
    8 words), q (gb * hdp words), the statistics (with max(THREADS, hdp)
    words of |V| maxima), the P codes (quantized attention)."""
    g = heads_per_block(g)
    srb = _align16(hd * itemsize)
    hdp = srb // itemsize
    small = (7 * MAX_G + (THREADS // 32) * MAX_G + max(THREADS, hdp)
             + 2 * hdp) * 4
    sizes = (max(chunk_rows * srb, 4 * g * max(4 * THREADS, hdp)),
             chunk_rows * srb,
             chunk_rows * 4 if int8_pool else 0, lanes * 4 if int8_pool else 0,
             g * lanes * 4, (g * hdp + MAX_CLUSTER) * 4, g * hdp * 4, small,
             g * lanes if quant else 0)
    return sum(_align16(n) for n in sizes)


class LaunchPlan(NamedTuple):
    """How one call is spread: ``cluster`` blocks per (slot, KV head,
    block of ``heads`` query heads; ``head_blocks`` such blocks per KV
    head); rank r owns pages r, r + cluster, ... (``pages_per_rank`` at
    most); ``chunk_rows`` pool rows are staged at once; ``smem`` bytes per
    block."""
    cluster: int
    pages_per_rank: int
    chunk_rows: int
    smem: int
    heads: int
    head_blocks: int

    def pages(self, rank: int, n_pages: int) -> list[int]:
        """The page indices (of a table ``n_pages`` wide) rank owns."""
        return list(range(rank, n_pages, self.cluster))

    def grid(self, slots: int, kv_heads: int) -> tuple[int, int]:
        """The launch's grid: block x serves slot x // cluster as rank
        x % cluster (the cluster dims are (cluster, 1, 1)), block y KV
        head y // head_blocks and its query heads from heads * (y %
        head_blocks)."""
        return self.cluster * slots, kv_heads * self.head_blocks


@functools.lru_cache(maxsize=256)
def launch_plan(n_pages: int, page_size: int, g: int, hd: int,
                itemsize: int, int8_pool: bool, quant: bool) -> LaunchPlan:
    """The launch for a table of ``n_pages`` pages of ``page_size`` rows
    and ``g`` query heads per KV head: the portable cluster of min(8,
    n_pages) blocks (one grid column of cluster blocks per slot, so the
    cluster divides the grid), each owning every cluster-th page;
    :func:`heads_per_block` query heads per cluster; and the most rows per
    staged chunk that keep a block within 227 KiB of shared memory (the
    whole of a rank's rows at every serving shape). Raises when not even
    one row fits. Cached: the serving loop asks for the same few shapes on
    every call."""
    cluster = min(MAX_CLUSTER, n_pages)
    ppr = -(-n_pages // cluster)
    lanes = ppr * page_size
    args = (g, hd, itemsize, int8_pool, quant, lanes)
    if smem_bytes(*args, 1) > SMEM_LIMIT:
        raise ValueError(
            f"paged attention: {ppr} pages of {page_size} rows per rank "
            f"(G={g}, hd={hd}) outgrow a block's shared memory")
    lo, hi = 1, lanes                       # largest chunk that fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(*args, mid) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    heads = heads_per_block(g)
    return LaunchPlan(cluster, ppr, lo, smem_bytes(*args, lo), heads,
                      -(-g // heads))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``csrc/paged_attention.cu``."""
    if not getattr(lib, "_typed", False):
        lib.paged_attention_launch.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _I, _I, _I, _P, _P]
        lib.paged_attention_launch.restype = _I
        lib.paged_attention_smem.argtypes = [_I, _I, _I, _I, _I, _I, _I]
        lib.paged_attention_smem.restype = ctypes.c_size_t
        lib.paged_attention_error.argtypes = [_I]
        lib.paged_attention_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _library() -> ctypes.CDLL:
    return typed(build.load("paged_attention"))


def paged_attention_plain(q, pool, page_indices, steps, cfg, scale):
    """The plain version: gather the full page extent, mask, attend
    (``models.attention.attend_paged_gather``), in any pool layout."""
    from repro_torch.models.attention import attend_paged_gather
    return attend_paged_gather(q, pool, page_indices, steps, cfg, scale)


# Rows (slot, query head) of one call that may lie beyond the tight bound
# of :func:`agreement`: a code or rounding that falls the other way at a
# boundary moves one row, a fault in the arithmetic moves most of them.
ROW_BUDGET = 2

_U = 2.0 ** -24                 # f32 unit roundoff


def bf16_neighbours(x: torch.Tensor):
    """For float64 ``x``: (lo, ulp), the bf16 magnitudes lo <= |x| < lo +
    ulp around |x| (8 significant bits: ulp = 2^(e - 8) for |x| in
    [2^(e-1), 2^e)). Rounding |x| to bf16 turns from lo to lo + ulp at the
    midpoint lo + ulp / 2."""
    a = x.abs()
    _, e = torch.frexp(a)
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return torch.floor(a / ulp) * ulp, ulp


def float_roundings(q, pool, page_indices, steps, scale) -> dict:
    """The bf16 float layout's two roundings to the pool dtype, recomputed
    in float64 from the plain version's own intermediates
    (``models.attention.attend_cached``): the score, the bf16 ``einsum``
    of q and K (an f32 dot of hd exact products, rounded to bf16), and P,
    ``p.to(bf16)`` of the f32 softmax of the scaled scores.

    A rounding is *ambiguous* when the value rounded lies within its own
    f32 error of a bf16 midpoint: the kernel's f32 value and the plain
    version's may then round to different neighbours. The radii, per side
    (a value either side computes lies within them of the exact value):

    * score: an f32 sum of hd exact products in any order errs by at most
      (hd - 1) u sum_d |q_d k_d| (u = 2^-24) from the exact dot;
    * P, given the same scores (the same f32 s - max in both): expf errs
      by 2 ulp (4u) on the card and 1 ulp on the host, the exp-sum over the
      row's n live lanes by (n - 1) u in any order (the kernel's runs in
      rank order across the cluster), the division by u (a reciprocal and
      a product, 2u, on the host); so P's f32 value lies within (n + 8) u
      p of the exact softmax p.

    Returns, per (slot, KV head, query head, lane) of the gathered extent:
    ``dot`` (the exact score dot, f64), ``score`` (the plain version's
    bf16 score, f64), ``p`` (the exact softmax of its scaled scores, f64),
    ``P`` (its bf16 P, f64), ``p_ulp`` (P's bf16 spacing), ``p_amb`` and
    ``s_amb`` (ambiguous P and score roundings, live lanes only),
    ``s_step`` (how far s moves when the score rounds to its other
    neighbour: one bf16 ulp of the score, times ``scale``); ``v`` (slot,
    lane, KV head, hd) in f64, ``live`` (slot, lane) and ``order`` (slot,
    KV head, query head, d): how far the two sides' f32 P·V sums, in other
    orders, may lie apart, 2 gamma_(n-1) sum_j P_j |v_jd| over the n live
    lanes (:func:`agreement`; P_j one bf16 step up at an ambiguous lane)."""
    from repro_torch.models.attention import NEG_INF, _gather_pages
    table = page_indices.cpu().long()
    ck = _gather_pages(pool["k"].cpu(), table)          # (B, S, KV, hd)
    cv = _gather_pages(pool["v"].cpu(), table)
    b, size, kvh, hd = ck.shape
    qg = q.cpu().reshape(b, 1, kvh, -1, hd)
    lanes = torch.arange(size)
    valid = lanes[None] < torch.clamp(steps.cpu().long() + 1,
                                      max=size)[:, None]
    live = valid[:, None, None, :]                       # (B, 1, 1, S)
    # the plain version's scores and P, as attend_cached makes them
    sb = torch.einsum("bqkgd,bskd->bkgqs", qg, ck)[:, :, :, 0]
    s32 = torch.where(live, sb.to(torch.float32) * scale,
                      torch.full_like(sb, NEG_INF, dtype=torch.float32))
    p32 = torch.softmax(s32, dim=-1)
    P = p32.to(torch.bfloat16).double()
    # exact values and their distance from a bf16 midpoint
    q64, k64 = qg[:, 0].double(), ck.double()
    dot = torch.einsum("bkgd,bskd->bkgs", q64, k64)
    mag = torch.einsum("bkgd,bskd->bkgs", q64.abs(), k64.abs())
    lo, ulp = bf16_neighbours(dot)
    s_amb = live & ((dot.abs() - lo - ulp / 2).abs()
                    <= (hd - 1) * _U * mag)
    p = torch.softmax(s32.double(), dim=-1)
    n = valid.sum(-1)[:, None, None, None].double()
    lo_p, p_ulp = bf16_neighbours(p)
    p_amb = live & ((p - lo_p - p_ulp / 2).abs() <= (n + 8) * _U * p)
    _, p_ulp = bf16_neighbours(P)
    v = cv.double()
    k = n - 1
    order = 2 * k * _U / (1 - k * _U) * torch.einsum(
        "bkgs,bskd->bkgd", P + p_ulp * (p_amb | s_amb), v.abs())
    return {"dot": dot, "score": sb.double(), "p": p, "P": P,
            "p_ulp": p_ulp, "p_amb": p_amb, "s_amb": s_amb,
            "s_step": ulp * scale, "v": v, "live": valid, "order": order}


def agreement(got, want, pool, page_indices, steps, cfg, *, q=None,
              scale=None) -> dict:
    """How far the kernel's output ``got`` lies from the plain version's
    ``want`` on the same inputs (``q``, ``pool``, ``page_indices``,
    ``steps``, ``cfg``, ``scale``; q and scale are needed by the bf16
    float layout only). Two bounds per element:

    * tight, where every code agrees and only sum orders differ. Int8
      attention: the int32 P·V is the same integer and only the P scale
      moves, by the relative error of the softmax sum (about ulps; 2^-14
      allowed). The bf16 float layout, where every rounding to the pool
      dtype agrees: one bf16 ulp of the output, 2^-7 of max(|got|,
      |want|), for the two sides' final roundings to bf16, plus the order
      of their f32 P·V sums. A product P_j v_jd of two bf16 values is
      exact in f32 (8 + 8 significant bits), so a side's f32 sum of a
      row's n live products, in any order, lies within gamma_(n-1) sum_j
      P_j |v_jd| of the exact sum (each product passes at most n - 1
      additions; gamma_k = k u / (1 - k u), u = 2^-24), and the two sides'
      sums within twice that of each other (``order``): more than an ulp
      of o_d where o_d nearly cancels. Where a rounding is ambiguous
      (:func:`float_roundings`: the value rounded lies within its f32
      error of a bf16 midpoint), the kernel may round it the other way,
      and the bound adds the first-order change that doing so makes to
      each output element o_d of the row: a P lane j
      moves P_j by its bf16 spacing, o_d by ulp(P_j) |v_jd|; a score lane i
      moves s_i by s_step_i, o_d by p_i s_step_i (v_id - o_d) through the
      softmax, and P_i lands on another rounding, ulp(P_i) |v_id| more.
      f32 float attention: rtol and atol 1e-5.
    * loose, where a P code falls one step the other way (int8 attention,
      two steps allowed: 2 * 128 * sps * sv with the row's P scale sps <=
      max of the slot's live V scales / 127 (int8 pool; sv = 1) or 1 / 127
      (exact pool; sv = the slot's |V| max over its gathered extent / 127
      per d)), or a bf16 rounding does (bf16 float layout: 2^-7 max|v|).
      f32 float attention: as tight.

    Returns ``max_abs_err``, ``rows`` (B * H), ``rows_beyond`` (rows with
    an element beyond the tight bound) and ``worst_loose`` (the largest
    |got - want| / loose bound). The two agree when ``rows_beyond <=
    ROW_BUDGET`` and ``worst_loose <= 1``."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    pool = {n: a.detach().cpu() for n, a in pool.items()}
    table = page_indices.cpu().long()
    b, pps = table.shape
    _, ps, kvh, hd = pool["k"].shape
    got, want = got.reshape(b, kvh, -1, hd), want.reshape(b, kvh, -1, hd)
    int8_pool = pool["k"].dtype == torch.int8
    layout = LAYOUTS[(bool(cfg.quant_attention), int8_pool)][0]
    err = (got - want).abs()
    if layout in (0, 1):
        tight = want.abs() * 2.0 ** -14
        if layout == 0:
            lanes = torch.arange(pps * ps)
            live = lanes[None] < torch.clamp(steps.cpu().long() + 1,
                                              max=pps * ps)[:, None]
            vs = pool["vs"][table].reshape(b, pps * ps, kvh)
            vmax = torch.where(live[..., None], vs, 0.0).amax(1)
            loose = 2 * 128 / 127 * vmax[:, :, None, None]
        else:
            v = pool["v"][table].float().abs().reshape(b, pps * ps, kvh, hd)
            loose = 2 * 128 / 127 * (v.amax(1) / 127 + 1e-8)[:, :, None]
    elif layout == 2 and pool["k"].dtype == torch.bfloat16:
        if q is None or scale is None:
            raise ValueError("the bf16 float layout's bound needs q and "
                             "scale")
        r = float_roundings(q, pool, table, steps, scale)
        av = r["v"].abs()
        flip = r["p_ulp"] * (r["p_amb"] | r["s_amb"])
        shift = r["p"] * r["s_step"] * r["s_amb"]
        moved = (torch.einsum("bkgs,bskd->bkgd", flip + shift, av)
                 + shift.sum(-1, keepdim=True) * want.abs().double())
        tight = (torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
                 + r["order"] + moved)
        loose = float(pool["v"].float().abs().max()) * 2.0 ** -7
    else:
        tight = loose = want.abs() * 1e-5 + 1e-5
    beyond = (err > tight).any(-1)
    return {"max_abs_err": float(err.max()), "rows": beyond.numel(),
            "rows_beyond": int(beyond.sum()),
            "worst_loose": float((err / loose).max())}


def paged_attention(q, pool, page_indices, steps, cfg, scale):
    """Live-page decode attention. ``q`` (B, 1, H, hd) post-RoPE; ``pool``
    one layer's leaves ``k``/``v`` (n_pages, ps, KV, hd), int8 with
    ``ks``/``vs`` (n_pages, ps, KV, 1) f32 under KV8, else the working
    dtype; ``page_indices`` (B, P) int32; ``steps`` (B,) int32, the
    position written this step. Returns (B, 1, H, hd): the pool dtype in
    the exact pool's float layout, else f32 (what ``attend_cached`` gives
    for the layout). Raises, as the reference does, for more than one
    query position, and for heads that are not whole groups per KV
    head."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool, page_indices, steps, cfg,
                                     scale)
    b, sq_len, h, hd = q.shape
    if sq_len != 1:
        raise ValueError(f"decode kernel expects Sq == 1, got {sq_len}")
    n_pages, ps, kvh = pool["k"].shape[:3]
    g = h // kvh
    if g < 1 or h % kvh:
        raise ValueError(
            f"the paged-attention kernel takes whole query heads per KV "
            f"head; got {h} heads over {kvh} KV heads")
    lib = _library()
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    pages = page_indices.shape[1]
    int8_pool = pool["k"].dtype == torch.int8
    layout = LAYOUTS[(bool(cfg.quant_attention), int8_pool)][0]
    names = ("k", "v", "ks", "vs") if int8_pool else ("k", "v")
    leaves = {name: pool[name] for name in names}
    for name, a in leaves.items():
        if a.device != q.device or not a.is_contiguous():
            raise ValueError(f"pool leaf {name} must be contiguous on "
                             f"{q.device}")
    pool_dtype = pool["k"].dtype
    if not int8_pool and (pool_dtype not in _POOL_DTYPE
                          or pool["v"].dtype != pool_dtype):
        raise ValueError(f"the kernel's exact pools are float32 or "
                         f"bfloat16, got {pool_dtype} / {pool['v'].dtype}")
    if int8_pool and any(leaves[n].dtype != torch.float32
                         for n in ("ks", "vs")):
        raise ValueError("the int8 pool's scales must be float32")
    table = page_indices.to(device=q.device, dtype=torch.int32).contiguous()
    st = steps.to(device=q.device, dtype=torch.int32).contiguous()
    qg = q.reshape(b, kvh, g, hd)
    sq32 = None
    if cfg.quant_attention:
        qk, sqs = quantize_per_token(qg)        # q's dtype, as the reference
        sq32 = sqs.to(torch.float32).reshape(b, kvh, g).contiguous()
    elif int8_pool:
        qk = qg.to(torch.float32)               # contracted in f32
    else:
        if q.dtype != pool_dtype:
            raise ValueError(f"the exact pool's float layout takes q in the "
                             f"pool dtype {pool_dtype}, got {q.dtype}")
        qk = qg
    qk = qk.contiguous()
    out_dtype = pool_dtype if layout == 2 else torch.float32
    out = torch.empty((b, kvh, g, hd), dtype=out_dtype, device=q.device)
    plan = launch_plan(pages, ps, g, hd, pool_dtype.itemsize, int8_pool,
                       bool(cfg.quant_attention))
    ptr = (lambda a: None if a is None else a.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        layout, _POOL_DTYPE.get(pool_dtype, 0), qk.data_ptr(), ptr(sq32),
        leaves["k"].data_ptr(), leaves["v"].data_ptr(), ptr(leaves.get("ks")),
        ptr(leaves.get("vs")), table.data_ptr(), st.data_ptr(),
        plan.grid(b, kvh)[0], kvh, g, hd, ps, pages, float(scale),
        plan.cluster, plan.pages_per_rank, plan.chunk_rows, out.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: "
                           f"{lib.paged_attention_error(err).decode()}")
    paged_attention.launches += 1
    return out.reshape(b, 1, h, hd)


paged_attention.launches = 0
