"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels build at first
use); on a host without one each test skips with the reason. They import
no JAX, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

``chip_smoke.py`` runs the same comparisons at the serving shapes and
times them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda():
    """Decided per test, never at import: skip without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,m,groups", [(24, 64, 1, 1), (576, 576, 4, 1),
                                          (576, 1536, 33, 1),
                                          (48, 576, 17, 4)])
def test_forest_kernel_equals_plain(cuda, n, k, m, groups):
    from repro_torch.core.engine import BatchedTransitiveEngine, compile_plan
    from repro_torch.kernels.transitive_forest import (forest_plain,
                                                       transitive_forest)
    rng = np.random.default_rng(n + k + m)
    w = rng.integers(-8, 8, size=(n, k))
    d = compile_plan(BatchedTransitiveEngine(4, 8).plan(w, groups=groups),
                     device=cuda)
    x = torch.from_numpy(rng.integers(-128, 128, size=(k, m))).to(cuda)
    before = transitive_forest.launches
    got = transitive_forest(d, x)
    assert transitive_forest.launches == before + 1
    torch.testing.assert_close(got, forest_plain(d, x), rtol=0, atol=0)


def _pattern(name, n, k, rng):
    """int4 weights: the planner tests' direct-heavy and sparse patterns."""
    if name == "outlier_heavy":              # many direct nodes
        return np.where(rng.random((n, k)) < 0.9, 7, -8)
    if name == "single_row":                 # one live row: mostly unused
        w = np.zeros((n, k), dtype=np.int64)
        w[0] = rng.integers(-8, 8, size=k)
        return w
    return rng.integers(-8, 8, size=(n, k))


@pytest.mark.parametrize("pattern,n,k,m,groups", [
    ("outlier_heavy", 48, 576, 4, 1), ("single_row", 96, 576, 8, 1),
    ("random", 576, 1536, 33, 1), ("random", 200, 576, 17, 4),
    ("outlier_heavy", 40, 192, 2, 3), ("random", 1536, 576, 512, 1),
    ("random", 300, 64, 3, 1), ("random", 100, 576, 4, 9),
    ("random", 300, 8, 40, 1), ("random", 300, 576, 96, 1)])
def test_fused_forest_kernel_cases(cuda, pattern, n, k, m, groups):
    """The fused kernel from a compact ForestPlan against both plain
    versions (dense ``run_device`` and ``forest_plan_plain``), and its row
    entry (int8 (M, K) -> (M, G, N)) against its (K, M) entry: exact.

    The shapes reach both stores of both blocks: narrow blocks (M <= 8)
    store plainly where a group is one chunk of 8 tiles (K=64; 9 groups
    of 8 tiles) and add atomically otherwise; wide blocks (M > 8) store
    plainly where a group is one tile (K=8) and add atomically where the
    grid is split over K."""
    from repro_torch.core.engine import (FOREST_DIRECT, FOREST_UNUSED,
                                         BatchedTransitiveEngine,
                                         compile_plan, forest_plan_plain,
                                         pack_forest_plan)
    from repro_torch.kernels.transitive_forest import (
        forest_plain, transitive_forest, transitive_forest_rows)
    rng = np.random.default_rng(n + k + m + groups)
    w = _pattern(pattern, n, k, rng)
    d = compile_plan(BatchedTransitiveEngine(4, 8).plan(w, groups=groups),
                     device=cuda)
    f = pack_forest_plan(d)
    if pattern == "outlier_heavy":
        assert (f.producer == FOREST_DIRECT).any()
    if pattern == "single_row":
        assert (f.producer == FOREST_UNUSED).float().mean() > 0.5
    x = torch.from_numpy(rng.integers(-128, 128, size=(k, m))).to(cuda)
    before = transitive_forest.launches
    got = transitive_forest(f, x)
    rows = transitive_forest_rows(f, x.T.to(torch.int8).contiguous())
    assert transitive_forest.launches == before + 2
    torch.testing.assert_close(got, forest_plain(d, x), rtol=0, atol=0)
    torch.testing.assert_close(got, forest_plan_plain(f, x), rtol=0, atol=0)
    want_rows = got.T if groups == 1 else got.permute(2, 1, 0)
    torch.testing.assert_close(rows, want_rows, rtol=0, atol=0)


@pytest.mark.parametrize("page_size,max_len", [(4, 32), (16, 256)])
def test_paged_attention_kernel_within_tolerance(cuda, page_size, max_len):
    """Within the bounds of ``kernels.paged_attention.agreement`` (the
    reasons are in its docstring): at most ROW_BUDGET rows beyond the
    tight bound, none beyond two P-code steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    from repro_torch.launch.specs import serve_config
    cfg = serve_config(get_config("smollm_135m"))
    b, kv, g, hd = 4, 3, 3, 64
    gen = torch.Generator(device=cuda).manual_seed(page_size)
    pps = max_len // page_size
    shp = (b * pps + 1, page_size, kv, hd)
    pool = {"k": torch.randint(-128, 128, shp, generator=gen, device=cuda,
                               dtype=torch.int8),
            "v": torch.randint(-128, 128, shp, generator=gen, device=cuda,
                               dtype=torch.int8),
            "ks": torch.rand(shp[:-1] + (1,), generator=gen, device=cuda),
            "vs": torch.rand(shp[:-1] + (1,), generator=gen, device=cuda)}
    steps = torch.tensor([0, 3, max_len // 2, max_len - 1],
                         dtype=torch.int32, device=cuda)
    table = torch.arange(1, b * pps + 1, dtype=torch.int32,
                         device=cuda).reshape(b, pps)
    q = torch.randn((b, 1, kv * g, hd), generator=gen, device=cuda)
    got = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    want = paged_attention_plain(q, pool, table, steps, cfg, hd ** -0.5)
    assert got.dtype == want.dtype
    _assert_agree(got, want, q, pool, table, steps, cfg, hd ** -0.5)


# (m, n, k, w_bits, t, groups, fill): fill None draws random codes; (a, b)
# fills x with a and w with b ("lo" -2^(S-1), "hi" 2^(S-1) - 1), which
# pushes the kernel's packed 16-bit halves to their limits (0 and the
# flush schedule's bound) at width 8 (T=8, K=640) and 4 (T=4, K=644).
# Split cases: K=1536 at M=1 runs 8 blocks per cluster, K=576 at M=4 5,
# 12 groups of 128 at M=4 2, M=512 N=1536 none.
_TGEMM_CASES = [
    (4, 1536, 576, 4, 8, 1, None), (130, 70, 512, 4, 8, 1, None),
    (1, 8, 64, 8, 8, 1, None), (33, 192, 576, 8, 4, 1, None),
    (17, 96, 256, 2, 8, 1, None), (512, 576, 1536, 4, 8, 1, None),
    (4, 576, 1536, 4, 8, 12, None), (9, 40, 96, 4, 4, 3, None),
    (1, 576, 1536, 4, 8, 1, None), (4, 576, 576, 4, 8, 1, None),
    (1, 192, 1536, 4, 8, 12, None), (512, 1536, 576, 4, 8, 1, None)]
_TGEMM_CASES += [(20, 136, 640 if t == 8 else 644, bits, t, 1, (a, b))
                 for bits in (2, 4, 5, 6, 8) for t in (4, 8)
                 for a, b in ((-128, "lo"), (-128, "hi"), (127, "lo"),
                              (127, "hi"))]


def _tgemm_id(case):
    *dims, fill = case
    tag = "-".join(map(str, dims))
    return tag if fill is None else f"{tag}-x{fill[0]}-w{fill[1]}"


@pytest.mark.parametrize("m,n,k,w_bits,t,groups,fill", _TGEMM_CASES,
                         ids=[_tgemm_id(c) for c in _TGEMM_CASES])
def test_transitive_gemm_kernel_equals_plain(cuda, m, n, k, w_bits, t,
                                             groups, fill):
    from repro_torch.kernels.transitive_gemm import (lut_width,
                                                     transitive_gemm_cuda,
                                                     transitive_gemm_plain)
    rng = np.random.default_rng(m + n + k)
    lim = 1 << (w_bits - 1)
    if fill is None:
        x = rng.integers(-128, 128, (m, k))
        w = rng.integers(-lim, lim, (n, k))
    else:
        x = np.full((m, k), fill[0])
        w = np.full((n, k), -lim if fill[1] == "lo" else lim - 1)
    x = torch.from_numpy(x.astype(np.int8))
    w = torch.from_numpy(w.astype(np.int8))
    kw = dict(w_bits=w_bits, t=t, groups=groups)
    if fill is not None:
        assert lut_width(k, groups) == ((8, True) if t == 8 else (4, True))
    before = transitive_gemm_cuda.launches
    got = transitive_gemm_cuda(x.to(cuda), w.to(cuda), **kw)
    assert transitive_gemm_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), transitive_gemm_plain(x, w, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,n,k,g", [(4, 576, 1536, 128), (512, 1536, 576, 64),
                                     (130, 200, 384, 128), (3, 24, 96, 32)])
def test_w4a8_gemm_kernel_within_tolerance(cuda, m, n, k, g):
    """The reference's tolerance (rtol 2e-3, atol 1e-2): exact group dots,
    f32 group terms summed in another order. Held for both instances on
    the same data: the wrapper's (``w4a8_wgmma`` at these groups and
    aligned bases) and ``w4a8_dot`` through the uncounted launcher."""
    from repro_torch.kernels import w4a8_gemm as w4
    rng = np.random.default_rng(m + n + k + g)
    args = [rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32),
            rng.integers(-8, 8, (n, k)).astype(np.int8),
            rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)]
    args = [torch.from_numpy(a).to(cuda) for a in args]
    want = w4.w4a8_gemm_plain(*args, group=g)
    before = w4.w4a8_gemm_cuda.launches
    got = w4.w4a8_gemm_cuda(*args, group=g)
    assert w4.w4a8_gemm_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-2)
    torch.testing.assert_close(_w4a8_dot_out(args, g), want, rtol=2e-3,
                               atol=1e-2)


def _w4a8_dot_out(args, g):
    """``w4a8_dot``'s output on qx, sx, qw, sg through the uncounted
    launcher, whatever ``launch_plan`` would pick."""
    from repro_torch.kernels import w4a8_gemm as w4
    qx, sx, qw, sg = args
    out = torch.full((qx.shape[0], qw.shape[0]), float("nan"),
                     device=qx.device)
    w4._launch(w4._library(), qx, sx.reshape(-1).contiguous(), qw, sg, out,
               g, w4.dot_plan(qx.shape[0], qw.shape[0], qx.shape[1], g))
    return out


@pytest.mark.parametrize("b,s,d", [(4, 2048, 4096), (2, 13, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_lru_kernel_within_tolerance(cuda, b, s, d, dtype):
    """The reference's tolerance: 3e-4 in float32, 3e-2 in bfloat16."""
    from repro_torch.kernels.rg_lru import rg_lru_cuda, rg_lru_plain
    rng = np.random.default_rng(b + s + d)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, d)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x, a, h0 = (v.to(cuda, dt) for v in (x, a, h0))
    before = rg_lru_cuda.launches
    got = rg_lru_cuda(x, a, h0)
    assert rg_lru_cuda.launches == before + 1 and got.dtype == dt
    tol = 3e-2 if dtype == "bfloat16" else 3e-4
    torch.testing.assert_close(got.float(), rg_lru_plain(x, a, h0).float(),
                               rtol=tol, atol=tol)


def _pool(layout, dtype, shp, gen, cuda):
    """A random pool for a layout code (kernels/paged_attention.LAYOUTS):
    int8 with f32 scales (0, 3) or exact in ``dtype`` (1, 2)."""
    if layout in (0, 3):
        return {"k": torch.randint(-128, 128, shp, generator=gen,
                                   device=cuda, dtype=torch.int8),
                "v": torch.randint(-128, 128, shp, generator=gen,
                                   device=cuda, dtype=torch.int8),
                "ks": torch.rand(shp[:-1] + (1,), generator=gen,
                                 device=cuda) * 0.02 + 1e-3,
                "vs": torch.rand(shp[:-1] + (1,), generator=gen,
                                 device=cuda) * 0.02 + 1e-3}
    return {"k": torch.randn(shp, generator=gen, device=cuda).to(dtype),
            "v": (torch.randn(shp, generator=gen, device=cuda) * 2)
            .to(dtype)}


def _assert_agree(got, want, q, pool, table, steps, cfg, scale):
    from repro_torch.kernels.paged_attention import ROW_BUDGET, agreement
    agree = agreement(got, want, pool, table, steps, cfg, q=q, scale=scale)
    assert agree["rows_beyond"] <= ROW_BUDGET, agree
    assert agree["worst_loose"] <= 1, agree


@pytest.mark.parametrize("page_size,max_len", [(8, 64), (16, 256),
                                               (16, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", [1, 2, 3])
def test_paged_attention_other_layouts_within_tolerance(cuda, layout, dtype,
                                                        page_size, max_len):
    """The kernel's three other pool layouts against the plain version on
    CPU copies, ragged steps, dead table entries at the null page (which
    holds data: the exact pool's |V| max folds it in), within the bounds
    of ``kernels.paged_attention.agreement``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (LAYOUTS,
                                                     paged_attention,
                                                     paged_attention_plain)
    from repro_torch.launch.specs import serve_config
    quant = {v[0]: k[0] for k, v in LAYOUTS.items()}[layout]
    cfg = serve_config(get_config("smollm_135m")).replace(
        quant_attention=quant)
    dt = getattr(torch, dtype)
    b, kv, g, hd = 4, 3, 3, 64
    gen = torch.Generator(device=cuda).manual_seed(layout + max_len)
    pps = max_len // page_size
    pool = _pool(layout, dt, (b * pps + 1, page_size, kv, hd), gen, cuda)
    steps = torch.tensor([0, 3, max_len // 2, max_len - 1],
                         dtype=torch.int32, device=cuda)
    table = torch.zeros((b, pps), dtype=torch.int32, device=cuda)
    nxt = 1
    for s in range(b):
        live = int(steps[s]) // page_size + 1
        table[s, :live] = torch.arange(nxt, nxt + live)
        nxt += live
    q = torch.randn((b, 1, kv * g, hd), generator=gen, device=cuda).to(dt)
    before = paged_attention.launches
    got = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    assert paged_attention.launches == before + 1
    cpu = {n: a.cpu() for n, a in pool.items()}
    want = paged_attention_plain(q.cpu(), cpu, table.cpu(), steps.cpu(), cfg,
                                 hd ** -0.5)
    assert got.dtype == want.dtype
    _assert_agree(got, want, q, cpu, table, steps, cfg, hd ** -0.5)


# B2 cluster cases: (b, kv, g, hd, page_size, max_len, exact pool dtype,
# steps; None draws them). The first holds steps 0, ps - 1, ps and the last
# position, and a fifth slot whose table is all dead (only page 0, read
# through its zero entries); P = 12 at page size 4 is not a multiple of the
# cluster of 8; f32 pools at hd=128 over max_len 2048 and bf16 ones over
# 4096 stage each rank's rows in several chunks.
_B2_CASES = [
    (5, 3, 3, 64, 16, (256,), "bfloat16", [0, 15, 16, 255, 5]),
    (1, 2, 1, 16, 4, (48,), "bfloat16", [47]),
    (2, 2, 3, 16, 1, (40,), "float32", [0, 39]),
    (64, 3, 8, 64, 16, (256,), "bfloat16", None),
    (64, 1, 1, 16, 16, (256,), "float32", None),
    (3, 2, 8, 128, 16, (48,), "bfloat16", [0, 20, 47]),
    (2, 2, 3, 128, 16, (2048,), "float32", [700, 2047]),
    (1, 1, 8, 128, 16, (4096,), "bfloat16", [4095])]


def _b2_id(case):
    b, kv, g, hd, ps, (max_len,), dtype, _ = case
    return f"B{b}-KV{kv}-G{g}-hd{hd}-ps{ps}-len{max_len}-{dtype}"


@pytest.mark.parametrize("case", _B2_CASES, ids=_b2_id)
@pytest.mark.parametrize("layout", [0, 1, 2, 3])
def test_paged_attention_cluster_cases(cuda, layout, case):
    """B2's cluster launch in each pool layout against the plain version on
    CPU copies, within the bounds of ``kernels.paged_attention.agreement``,
    one launch per call; a second call on the same inputs gives the same
    bits (no atomics: every sum runs in a fixed order)."""
    from repro_torch.kernels.paged_attention import (LAYOUTS, launch_plan,
                                                     paged_attention,
                                                     paged_attention_plain)
    b, kv, g, hd, ps, (max_len,), dtype, _ = case
    q, pool, table, steps, cfg = _b2_inputs(layout, case,
                                            layout + b + hd + max_len, cuda)
    quant, int8_pool = {v[0]: k for k, v in LAYOUTS.items()}[layout]
    itemsize = 1 if int8_pool else getattr(torch, dtype).itemsize
    plan = launch_plan(max_len // ps, ps, g, hd, itemsize, int8_pool, quant)
    assert plan.cluster == min(8, max_len // ps)
    before = paged_attention.launches
    got = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    again = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    assert paged_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    cpu = {n: a.cpu() for n, a in pool.items()}
    want = paged_attention_plain(q.cpu(), cpu, table.cpu(), steps.cpu(), cfg,
                                 hd ** -0.5)
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    _assert_agree(got, want, q, cpu, table, steps, cfg, hd ** -0.5)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 5, 9, 16, 32])
@pytest.mark.parametrize("layout", [0, 1, 2, 3])
def test_paged_attention_head_blocks_and_wide_heads(cuda, layout, g, hd):
    """Any number of query heads per KV head (above 8 in blocks of at most
    8, each its own cluster) and head dimensions up to 256, in each pool
    layout: B=3 slots over 2 KV heads at page size 16 and max_len 256,
    random steps, against the plain version on CPU copies within the
    bounds of ``agreement``; one launch per call over the grid
    ``launch_plan`` gives; two calls bit-identical."""
    from repro_torch.kernels.paged_attention import (LAYOUTS, launch_plan,
                                                     paged_attention,
                                                     paged_attention_plain)
    case = (3, 2, g, hd, 16, (256,), "bfloat16", None)
    q, pool, table, steps, cfg = _b2_inputs(layout, case,
                                            1000 * layout + 10 * g + hd,
                                            cuda)
    quant, int8_pool = {v[0]: k for k, v in LAYOUTS.items()}[layout]
    plan = launch_plan(16, 16, g, hd, pool["k"].element_size(), int8_pool,
                       quant)
    assert plan.heads * plan.head_blocks >= g
    assert plan.heads * (plan.head_blocks - 1) < g and plan.heads <= 8
    before = paged_attention.launches
    got = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    again = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    assert paged_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    cpu = {n: a.cpu() for n, a in pool.items()}
    want = paged_attention_plain(q.cpu(), cpu, table.cpu(), steps.cpu(), cfg,
                                 hd ** -0.5)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    _assert_agree(got, want, q, cpu, table, steps, cfg, hd ** -0.5)


@pytest.mark.parametrize("hd", [8, 9, 34, 40, 72, 320, 512])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("layout", [0, 1, 2, 3])
def test_paged_attention_any_head_dim(cuda, layout, g, hd):
    """Any head dimension, as the reference's kernel takes: rows that are
    not a multiple of 16 bytes (staged at a 16-byte stride with a zero
    tail, copied in 8-, 4-, 2- or 1-byte units: hd 8, 40 and 72 in int8
    rows of 8-byte units, 34 in 2-byte ones, 9 in single bytes) and heads
    above 256 (P.V in passes of 512), in each pool layout at G = 1, 4 and
    16: B=3 slots over 2 KV heads at page size 16 and max_len 256 against
    the plain version on CPU copies within the bounds of ``agreement``;
    one launch per call; two calls bit-identical."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    case = (3, 2, g, hd, 16, (256,), "bfloat16", None)
    q, pool, table, steps, cfg = _b2_inputs(layout, case,
                                            1000 * layout + 10 * g + hd,
                                            cuda)
    before = paged_attention.launches
    got = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    again = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    assert paged_attention.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    cpu = {n: a.cpu() for n, a in pool.items()}
    want = paged_attention_plain(q.cpu(), cpu, table.cpu(), steps.cpu(), cfg,
                                 hd ** -0.5)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    _assert_agree(got, want, q, cpu, table, steps, cfg, hd ** -0.5)


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("layout", [0, 2])
def test_paged_attention_reads_pool_views_in_place(cuda, layout, offset):
    """K and V leaves that are contiguous views starting ``offset``
    elements into their storage (bases off a 16-byte boundary) are read
    where they lie, in the widest copy unit that divides the row and the
    bases: the same bits as on freshly allocated copies of them."""
    from repro_torch.kernels.paged_attention import paged_attention
    case = (3, 2, 4, 64, 16, (256,), "bfloat16", None)
    q, pool, table, steps, cfg = _b2_inputs(layout, case, 77 + offset, cuda)
    views = dict(pool)
    for name in ("k", "v"):
        a = pool[name]
        flat = torch.empty(a.numel() + offset, dtype=a.dtype, device=cuda)
        views[name] = flat[offset:].view(a.shape)
        views[name].copy_(a)
        assert views[name].data_ptr() % 16
    got = paged_attention(q, views, table, steps, cfg, 64 ** -0.5)
    want = paged_attention(q, pool, table, steps, cfg, 64 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _b2_inputs(layout, case, seed, cuda):
    """(q, pool, table, steps, cfg) of a B2 cluster case in one layout,
    drawn from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import LAYOUTS
    from repro_torch.launch.specs import serve_config
    b, kv, g, hd, ps, (max_len,), dtype, steps = case
    quant = {v[0]: k[0] for k, v in LAYOUTS.items()}[layout]
    cfg = serve_config(get_config("smollm_135m")).replace(
        quant_attention=quant)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    pps = max_len // ps
    pool = _pool(layout, dt, (b * pps + 1, ps, kv, hd), gen, cuda)
    if steps is None:
        steps = torch.randint(0, max_len, (b,), generator=gen, device=cuda)
    steps = torch.as_tensor(steps, dtype=torch.int32, device=cuda)
    table = torch.zeros((b, pps), dtype=torch.int32, device=cuda)
    nxt = 1
    for s in range(b):
        live = int(steps[s]) // ps + 1
        if (s, live) != (4, 1):                 # slot 4 of case 0: page 0
            table[s, :live] = torch.arange(nxt, nxt + live)
        nxt += live
    q = torch.randn((b, 1, kv * g, hd), generator=gen, device=cuda)
    q = q.to(dt) if layout == 2 else q.to(torch.bfloat16)
    return q, pool, table, steps, cfg


def _plain_row(r, row, flip, scale):
    """The plain version's output row (slot, KV head, head) from
    ``float_roundings``' intermediates: its bf16 P times V in float64,
    rounded once to bf16, with the rounding ``flip`` (None; ("P", lane):
    P's; ("s", lane): the score's, P following through the softmax)
    turned to its other bf16 neighbour."""
    from repro_torch.kernels.paged_attention import bf16_neighbours
    P = r["P"][row].clone()
    if flip is not None and flip[0] == "P":
        lo, ulp = bf16_neighbours(r["p"][row][flip[1]])
        P[flip[1]] = 2 * lo + ulp - P[flip[1]]
    elif flip is not None:
        dot, score = r["dot"][row][flip[1]], r["score"][row].clone()
        lo, ulp = bf16_neighbours(dot)
        score[flip[1]] = torch.sign(dot) * (2 * lo + ulp - score[flip[1]]
                                            .abs())
        s32 = torch.where(r["live"][row[0]], score.float() * scale,
                          torch.full_like(score, -1e30, dtype=torch.float32))
        P = torch.softmax(s32, -1).to(torch.bfloat16).double()
    return (P @ r["v"][row[0], :, row[1]]).float().to(torch.bfloat16).float()


def _ulps(a, b):
    """max |a - b| over a row, in units of one bf16 ulp, 2^-7 max(|a|,
    |b|) (0 where both are 0)."""
    one = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
    return float(torch.where(one > 0, (a - b).abs() / one, 0.0).max())


def test_paged_attention_bf16_rows_beyond_are_explained(cuda):
    """C5: the exact bf16 float layout at B=64, KV=3, G=8 (1,536 rows per
    call), at the cluster case's seed 386 and 8 more. Every row that the
    kernel leaves beyond one bf16 ulp of the plain version is explained:
    it lies within one ulp of the plain version recomputed exactly
    (float64 P·V, rounded once to bf16) as it is ("none": the two sides'
    f32 P·V sums differ) or with one ambiguous score or P rounding
    (``kernels.paged_attention.float_roundings``) turned, or within one
    ulp plus the sum-order term (``order``) of the plain version itself;
    and ``agreement`` leaves at most ROW_BUDGET rows beyond. Prints, per
    seed, each row beyond one ulp (slot, KV head, head) with its
    ambiguous lanes, the turn found (False: none), whether the order term
    alone takes it, and how far (in ulps) the plain version and the
    kernel lie from the exact recomputation."""
    from repro_torch.kernels.paged_attention import (ROW_BUDGET, agreement,
                                                     float_roundings,
                                                     paged_attention,
                                                     paged_attention_plain)
    case = _B2_CASES[3]
    hd, scale = case[3], case[3] ** -0.5
    for seed in (386, 0, 1, 2, 3, 4, 5, 6, 7):
        q, pool, table, steps, cfg = _b2_inputs(2, case, seed, cuda)
        got = paged_attention(q, pool, table, steps, cfg, scale).cpu()
        cpu = {n: a.cpu() for n, a in pool.items()}
        want = paged_attention_plain(q.cpu(), cpu, table.cpu(), steps.cpu(),
                                     cfg, scale)
        agree = agreement(got, want, cpu, table, steps, cfg, q=q,
                          scale=scale)
        kvh = pool["k"].shape[2]
        got, want = (a.float().reshape(a.shape[0], kvh, -1, hd)
                     for a in (got, want))
        one = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
        beyond = ((got - want).abs() > one).any(-1)
        r = float_roundings(q, cpu, table, steps, scale)
        readings = []
        for row in map(tuple, beyond.nonzero().tolist()):
            amb = [(kind, j) for kind in ("s", "P")
                   for j in r[f"{kind.lower()}_amb"][row].nonzero()[:, 0]
                   .tolist()]
            turn = next((f for f in [None, *amb]
                         if _ulps(_plain_row(r, row, f, scale), got[row])
                         <= 1), False)
            order = bool(((got[row] - want[row]).abs()
                          <= one[row] + r["order"][row]).all())
            exact = _plain_row(r, row, None, scale)
            readings.append((row, len(amb), "none" if turn is None else
                             turn and f"{turn[0]}{turn[1]}", order,
                             round(_ulps(want[row], exact), 2),
                             round(_ulps(got[row], exact), 2)))
        print(f"[C5] seed {seed}: {int(beyond.sum())} of {beyond.numel()} "
              f"rows beyond one bf16 ulp; (row, ambiguous lanes, turn that "
              f"brings it within one ulp, within one ulp + order term, ulps "
              f"plain vs exact, ulps kernel vs exact): {readings}; rows "
              f"beyond agreement's bound: {agree['rows_beyond']}, worst "
              f"|diff| / loose bound {agree['worst_loose']:.3e}")
        assert all(turn is not False or order
                   for _, _, turn, order, _, _ in readings), readings
        assert agree["rows_beyond"] <= ROW_BUDGET, agree
        assert agree["worst_loose"] <= 1, agree


def test_paged_attention_smem_matches_the_kernel(cuda):
    """``kernels.paged_attention.smem_bytes`` (what ``launch_plan`` sizes
    the chunk by) equals the kernel's own carve-up for every layout, at
    G up to 32 query heads per KV head (blocks of at most 8) and head
    dimensions from 8 to 1024, multiples of 16 or not."""
    from repro_torch.kernels.paged_attention import _library, smem_bytes
    lib = _library()
    for layout, pool_dtype in ((0, 0), (1, 0), (1, 1), (2, 0), (2, 1),
                               (3, 0)):
        int8_pool = layout in (0, 3)
        itemsize = 1 if int8_pool else (4, 2)[pool_dtype]
        for g in (1, 3, 8, 9, 16, 32):
            for hd in (8, 9, 16, 32, 34, 48, 64, 72, 128, 256, 320, 512,
                       1024):
                for ps, ppr, chunk in ((16, 2, 32), (16, 16, 100), (1, 5, 1),
                                       (4, 2, 7)):
                    want = smem_bytes(g, hd, itemsize, int8_pool,
                                      layout in (0, 1), ppr * ps, chunk)
                    assert lib.paged_attention_smem(
                        layout, pool_dtype, g, hd, ps, ppr, chunk) == want


@pytest.mark.parametrize("t", [1, 2, 3, 5, 6, 7, 9, 12, 15])
@pytest.mark.parametrize("w_bits", [2, 4, 8])
def test_transitive_gemm_generic_kernel_equals_plain(cuda, t, w_bits):
    """T outside {4, 8} through ``transitive_gemm_cuda``: one launch of the
    LUT kernel at the width ``lut_width`` picks (K / groups = 24T and 2T:
    the unaligned instance wherever they are not multiples of 4), exact,
    ragged N, one group and three."""
    from repro_torch.kernels.transitive_gemm import (transitive_gemm_cuda,
                                                     transitive_gemm_plain)
    rng = np.random.default_rng(t * 10 + w_bits)
    lim = 1 << (w_bits - 1)
    for m, n, k, groups in ((4, 300, 24 * t, 1), (9, 70, 6 * t, 3)):
        x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
        w = torch.from_numpy(rng.integers(-lim, lim, (n, k)).astype(np.int8))
        kw = dict(w_bits=w_bits, t=t, groups=groups)
        before = transitive_gemm_cuda.launches
        got = transitive_gemm_cuda(x.to(cuda), w.to(cuda), **kw)
        assert transitive_gemm_cuda.launches == before + 1
        torch.testing.assert_close(got.cpu(), transitive_gemm_plain(x, w,
                                                                    **kw),
                                   rtol=0, atol=0)


def _exact_grouped(x, w, groups):
    """The integer GEMM per group (int64, wrapped to int32)."""
    kg = x.shape[1] // groups
    return torch.stack([x[:, i * kg:(i + 1) * kg].long()
                        @ w[:, i * kg:(i + 1) * kg].long().T
                        for i in range(groups)], dim=1).to(torch.int32)


@pytest.mark.parametrize("t", [16, 32])
@pytest.mark.parametrize("w_bits", [2, 4, 8])
def test_transitive_gemm_generic_wide_t_is_exact(cuda, t, w_bits):
    """T = 16 and 32 (the kernel's own width, 8, blocks K: T only has to
    divide K / groups): exact against the integer GEMM (int64, wrapped to
    int32), one group and three, ragged N, extreme values; at T = 16 also
    against the plain version (whose 2^T-entry LUT is too large at T =
    32). One launch per call."""
    from repro_torch.kernels.transitive_gemm import (transitive_gemm_cuda,
                                                     transitive_gemm_plain)
    rng = np.random.default_rng(t + w_bits)
    lim = 1 << (w_bits - 1)
    for m, n, k, groups, fill in ((4, 300, 4 * t, 1, None),
                                  (3, 70, 6 * t, 3, None),
                                  (2, 33, 2 * t, 1, (-128, -lim))):
        if fill is None:
            x = rng.integers(-128, 128, (m, k))
            w = rng.integers(-lim, lim, (n, k))
        else:
            x, w = np.full((m, k), fill[0]), np.full((n, k), fill[1])
        x = torch.from_numpy(x.astype(np.int8))
        w = torch.from_numpy(w.astype(np.int8))
        kw = dict(w_bits=w_bits, t=t, groups=groups)
        before = transitive_gemm_cuda.launches
        got = transitive_gemm_cuda(x.to(cuda), w.to(cuda), **kw).cpu()
        assert transitive_gemm_cuda.launches == before + 1
        torch.testing.assert_close(got, _exact_grouped(x, w, groups),
                                   rtol=0, atol=0)
        if t == 16:
            torch.testing.assert_close(got, transitive_gemm_plain(x, w, **kw),
                                       rtol=0, atol=0)


# The unaligned instance (K / groups not a multiple of 4): (m, n, k,
# groups, w_bits, T, fill). K % 4 != 0 at one group (T=5 at K=575, T=7 at
# K=574; M > 8; a K of 4,995 whose 1,249 subtiles split over a cluster),
# ragged N, three groups of 5 bytes, row strides of 18 and 30 bytes, and
# extreme values (activations -128 or 127 against the weights' extremes).
_UNALIGNED_CASES = [
    (4, 1536, 575, 1, 4, 5, None), (4, 1536, 574, 1, 8, 7, None),
    (64, 192, 575, 1, 4, 5, None), (4, 576, 4995, 1, 4, 5, None),
    (7, 130, 21, 1, 2, 3, None), (3, 300, 15, 3, 4, 5, None),
    (5, 70, 18, 2, 8, 3, None), (9, 33, 30, 3, 4, 5, None)]
_UNALIGNED_CASES += [(20, 136, 639, 1, bits, 9, (a, b))
                     for bits in (2, 4, 8) for a in (-128, 127)
                     for b in ("lo", "hi")]


@pytest.mark.parametrize("m,n,k,groups,w_bits,t,fill", _UNALIGNED_CASES,
                         ids=[_tgemm_id(c) for c in _UNALIGNED_CASES])
def test_transitive_gemm_unaligned_is_exact(cuda, m, n, k, groups, w_bits,
                                            t, fill):
    """K / groups not a multiple of 4: the wrapper picks the unaligned
    instance, which stages bytes by plain loads and zero-fills each
    group's last subtile; one launch, exact against the integer GEMM and
    the plain version."""
    from repro_torch.kernels.transitive_gemm import (lut_width,
                                                     transitive_gemm_cuda,
                                                     transitive_gemm_plain)
    assert lut_width(k, groups) == (4, False)
    rng = np.random.default_rng(m + n + k)
    lim = 1 << (w_bits - 1)
    if fill is None:
        x = rng.integers(-128, 128, (m, k))
        w = rng.integers(-lim, lim, (n, k))
    else:
        x = np.full((m, k), fill[0])
        w = np.full((n, k), -lim if fill[1] == "lo" else lim - 1)
    x = torch.from_numpy(x.astype(np.int8))
    w = torch.from_numpy(w.astype(np.int8))
    kw = dict(w_bits=w_bits, t=t, groups=groups)
    before = transitive_gemm_cuda.launches
    got = transitive_gemm_cuda(x.to(cuda), w.to(cuda), **kw).cpu()
    assert transitive_gemm_cuda.launches == before + 1
    torch.testing.assert_close(got, _exact_grouped(x, w, groups), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, transitive_gemm_plain(x, w, **kw),
                               rtol=0, atol=0)


def _kernel_names(fn):
    """The device kernels one call of ``fn`` runs, by the profiler's names,
    read through ``repro_torch.launch.device_events``: a profile can lose
    its first launches, so each opens with a primer, and a read is taken
    only when it holds every launch of the call."""
    from repro_torch.launch.device_events import kernel_names
    return kernel_names(fn)


def _assert_one_launch_of(fn, kernel):
    names = _kernel_names(fn)
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("t,n,k,m,groups", [(9, 1536, 576, 4, 1),
                                            (9, 576, 576, 64, 1),
                                            (10, 200, 180, 5, 2),
                                            (12, 64, 96, 3, 1),
                                            (14, 16, 28, 2, 1),
                                            (15, 16, 30, 4, 1),
                                            (15, 8, 30, 20, 2),
                                            (16, 8, 32, 4, 1)])
def test_forest_dense_kernel_equals_plain(cuda, t, n, k, m, groups):
    """Plans with T > 8 handed to both forest entries as DevicePlans
    against ``run_device``: exact. For 9 <= T <= 15 each call is one
    launch of the fused kernel ``forest_fused16`` (the DevicePlan packed
    at its first call, int16 gathers), counted in
    ``transitive_forest_dense.launches``; from T = 16 one launch of
    ``forest_sparse`` (packed into a SparseForestPlan), counted in
    ``launch_sparse.launches``."""
    from repro_torch.core.engine import BatchedTransitiveEngine, compile_plan
    from repro_torch.kernels.transitive_forest import (
        forest_plain, transitive_forest, transitive_forest_rows)
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    rng = np.random.default_rng(t + n + k)
    w = rng.integers(-8, 8, size=(n, k))
    d = compile_plan(BatchedTransitiveEngine(4, t).plan(w, groups=groups),
                     device=cuda)
    x = torch.from_numpy(rng.integers(-128, 128, size=(k, m))).to(cuda)
    qx = x.T.to(torch.int8).contiguous()
    counter, kernel = ((transitive_forest_dense, "forest_fused16") if t <= 15
                       else (launch_sparse, "forest_sparse"))
    before = counter.launches
    got = transitive_forest(d, x)
    rows = transitive_forest_rows(d, qx)
    assert counter.launches == before + 2
    want = forest_plain(d, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(rows.T if groups == 1
                               else rows.permute(2, 1, 0), want, rtol=0,
                               atol=0)
    x32 = x.to(torch.int32)              # no cast kernel inside the call
    _assert_one_launch_of(lambda: transitive_forest(d, x32), kernel)
    _assert_one_launch_of(lambda: transitive_forest_rows(d, qx), kernel)


# (T, N, K, M, groups, weight bits, fill): fill None for random weights
# and int8 activations, else (activation, weight) everywhere
_SPARSE_CASES = [
    # T = 16 and 17, ungrouped and grouped, 8-bit weights
    (16, 16, 32, 3, 1, 4, None), (16, 24, 64, 5, 2, 4, None),
    (16, 8, 32, 4, 1, 8, None), (17, 64, 68, 9, 2, 4, None),
    # N not a multiple of 8 (rows read plainly, not by cp.async); more
    # outputs and columns than one block's (bn 512, bm 8 x 5 blocks)
    (17, 20, 34, 4, 1, 4, None), (16, 300, 64, 33, 1, 4, None),
    # several rounds per rank with two plan buffers (40 and 18 tiles a
    # group over clusters of 16): the kernel takes any T a SparseForestPlan
    # holds, so narrow plans plan quickly here
    (9, 64, 360, 4, 1, 4, None), (9, 40, 324, 6, 2, 4, None),
    # extreme values
    (16, 40, 64, 4, 1, 4, (-128, -8)), (16, 40, 64, 4, 1, 4, (127, 7)),
    (16, 40, 64, 4, 1, 4, (-128, 7)), (16, 40, 64, 4, 1, 4, (127, -8))]


def _sparse_id(case):
    t, n, k, m, g, bits, fill = case
    return f"T{t}-{n}x{k}-M{m}-G{g}-W{bits}" + (
        f"-fill{fill[0]}_{fill[1]}" if fill else "")


@pytest.mark.parametrize("case", _SPARSE_CASES, ids=_sparse_id)
def test_forest_sparse_cases(cuda, case):
    """``forest_sparse`` from a SparseForestPlan through both entries:
    exact against the DevicePlan's ``run_device``, the plan's
    ``sparse_forest_plain`` and the integer GEMM (per group); each call
    one launch by count and by profiler name; two calls bit-identical."""
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan,
                                         pack_sparse_forest_plan,
                                         run_device, sparse_forest_plain)
    from repro_torch.kernels.transitive_forest import (
        transitive_forest, transitive_forest_rows)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    t, n, k, m, groups, bits, fill = case
    rng = np.random.default_rng(t + n + k + m + groups)
    lo = 1 << (bits - 1)
    if fill is None:
        w = rng.integers(-lo, lo, size=(n, k))
        x = rng.integers(-128, 128, size=(k, m))
    else:
        x, w = np.full((k, m), fill[0]), np.full((n, k), fill[1])
    d = compile_plan(BatchedTransitiveEngine(bits, t).plan(w, groups=groups),
                     device=cuda)
    s = pack_sparse_forest_plan(d)
    x = torch.from_numpy(x.astype(np.int32)).to(cuda)
    qx = x.T.to(torch.int8).contiguous()
    before = launch_sparse.launches
    got = transitive_forest(s, x)
    rows = transitive_forest_rows(s, qx)
    assert launch_sparse.launches == before + 2
    kg = k // groups
    gemm = np.stack([w[:, i * kg:(i + 1) * kg].astype(np.int64)
                     @ x.cpu().numpy()[i * kg:(i + 1) * kg]
                     for i in range(groups)], axis=1)            # (N, G, M)
    gemm = torch.from_numpy(gemm.astype(np.int32))
    torch.testing.assert_close(got.cpu(), gemm[:, 0] if groups == 1
                               else gemm, rtol=0, atol=0)
    torch.testing.assert_close(got, run_device(d, x), rtol=0, atol=0)
    torch.testing.assert_close(got, sparse_forest_plain(s, x), rtol=0,
                               atol=0)
    torch.testing.assert_close(rows, got.T if groups == 1
                               else got.permute(2, 1, 0), rtol=0, atol=0)
    assert torch.equal(transitive_forest_rows(s, qx), rows)
    assert torch.equal(transitive_forest(s, x), got)
    _assert_one_launch_of(lambda: transitive_forest_rows(s, qx),
                          "forest_sparse")
    _assert_one_launch_of(lambda: transitive_forest(s, x), "forest_sparse")


@pytest.mark.parametrize("count", [30000, 39202])
def test_forest_two_pass_route_for_tables_too_large(cuda, count):
    """A T = 16 DevicePlan whose compact table does not fit shared memory
    (30,000 slots: packs, but one column and its codes exceed 227 KiB) or
    int16 (39,202 slots: every node up to popcount 8) runs the two-pass
    kernel, picked from its size: both entries exact against
    ``run_device``, each call one ``forest_dense_tiles`` and one
    ``forest_dense_ape`` and no ``forest_sparse``, counted in
    ``transitive_forest_dense.launches``."""
    from repro_torch.core.engine import (compile_plan, complete_forest_plan,
                                         run_device)
    from repro_torch.kernels.transitive_forest import (
        transitive_forest, transitive_forest_rows)
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    d = compile_plan(complete_forest_plan(16, count, 48, seed=count),
                     device=cuda)
    rng = np.random.default_rng(count)
    x = torch.from_numpy(rng.integers(-128, 128, size=(16, 4))).to(
        cuda, torch.int32)
    qx = x.T.to(torch.int8).contiguous()
    before, sparse = transitive_forest_dense.launches, launch_sparse.launches
    got = transitive_forest(d, x)
    rows = transitive_forest_rows(d, qx)
    assert transitive_forest_dense.launches == before + 2
    assert launch_sparse.launches == sparse
    want = run_device(d, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(rows.T, want, rtol=0, atol=0)
    names = _kernel_names(lambda: transitive_forest(d, x))
    assert not any("forest_sparse" in nm for nm in names), names
    assert sum("forest_dense_tiles" in nm for nm in names) == 1, names
    assert sum("forest_dense_ape" in nm for nm in names) == 1, names


def test_sparse_smem_matches_the_kernel(cuda):
    """The host's carve-up (``sparse_smem``, which ``sparse_tiling`` and
    ``sparse_fits`` size the launch and the route with) is the kernel's
    own."""
    from repro_torch.kernels import transitive_forest_sparse as tfs
    lib = tfs._library()
    for args in [(16, 4, 8720, 4, 1, 512), (17, 8, 100, 1, 2, 64),
                 (16, 2, 68, 8, 2, 128), (31, 4, 30004, 1, 1, 64),
                 (9, 3, 516, 2, 2, 256)]:
        assert lib.transitive_forest_sparse_smem(*args) == \
            tfs.sparse_smem(*args)


# (T, N, K, M, groups, fill): fill None for random int4 weights and int8
# activations, else (activation, weight) everywhere
_FUSED16_CASES = [
    # smollm-135m's four linear shapes at T = 12, decode
    (12, 576, 576, 4, 1, None), (12, 192, 576, 4, 1, None),
    (12, 1536, 576, 4, 1, None), (12, 576, 1536, 4, 1, None),
    # prefill, and the grouped down-projection: 16 groups of 96 (a group
    # holds whole 12-wide tiles; 128 does not)
    (12, 1536, 576, 512, 1, None), (12, 576, 1536, 4, 16, None),
    # M not a multiple of the block's columns (bm = 4, 8, 8 x 2 blocks)
    (9, 300, 576, 3, 1, None), (11, 200, 352, 5, 2, None),
    (13, 100, 104, 13, 1, None),
    # extreme values
    (12, 96, 576, 4, 1, (-128, -8)), (12, 96, 576, 4, 1, (127, 7)),
    (12, 96, 576, 4, 1, (-128, 7)), (12, 96, 576, 4, 1, (127, -8)),
    (15, 40, 60, 4, 1, (-128, -8)), (15, 40, 60, 4, 1, (127, 7)),
    (15, 40, 60, 4, 1, (-128, 7)), (15, 40, 60, 4, 1, (127, -8))]


def _fused16_id(case):
    t, n, k, m, g, fill = case
    return f"T{t}-{n}x{k}-M{m}-G{g}" + (f"-fill{fill[0]}_{fill[1]}"
                                         if fill else "")


@pytest.mark.parametrize("case", _FUSED16_CASES, ids=_fused16_id)
def test_forest_fused16_cases(cuda, case):
    """The fused kernel for 9 <= T <= 15 from a ForestPlan with int16
    gathers, through both entries: exact against the DevicePlan's
    ``run_device``, the ForestPlan's ``forest_plan_plain`` and the integer
    GEMM (per group); each call one launch of ``forest_fused16``; two calls
    bit-identical."""
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan, forest_plan_plain,
                                         pack_forest_plan)
    from repro_torch.kernels.transitive_forest import (
        forest_plain, transitive_forest, transitive_forest_rows)
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    t, n, k, m, groups, fill = case
    rng = np.random.default_rng(t + n + k + m + groups)
    if fill is None:
        w = rng.integers(-8, 8, size=(n, k))
        x = rng.integers(-128, 128, size=(k, m))
    else:
        x, w = np.full((k, m), fill[0]), np.full((n, k), fill[1])
    d = compile_plan(BatchedTransitiveEngine(4, t).plan(w, groups=groups),
                     device=cuda)
    f = pack_forest_plan(d)
    assert f.rows.dtype == torch.int16
    x = torch.from_numpy(x.astype(np.int32)).to(cuda)
    qx = x.T.to(torch.int8).contiguous()
    before = transitive_forest_dense.launches
    got = transitive_forest(f, x)
    rows = transitive_forest_rows(f, qx)
    assert transitive_forest_dense.launches == before + 2
    kg = k // groups
    gemm = np.stack([w[:, i * kg:(i + 1) * kg].astype(np.int64)
                     @ x.cpu().numpy()[i * kg:(i + 1) * kg]
                     for i in range(groups)], axis=1)            # (N, G, M)
    gemm = torch.from_numpy(gemm.astype(np.int32))
    want = gemm[:, 0] if groups == 1 else gemm
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    torch.testing.assert_close(got, forest_plain(d, x), rtol=0, atol=0)
    torch.testing.assert_close(got, forest_plan_plain(f, x), rtol=0, atol=0)
    torch.testing.assert_close(rows, got.T if groups == 1
                               else got.permute(2, 1, 0), rtol=0, atol=0)
    assert torch.equal(transitive_forest_rows(f, qx), rows)
    assert torch.equal(transitive_forest(f, x), got)
    _assert_one_launch_of(lambda: transitive_forest_rows(f, qx),
                          "forest_fused16")
    _assert_one_launch_of(lambda: transitive_forest(f, x), "forest_fused16")


def test_fused16_smem_matches_the_kernel(cuda):
    """The host's carve-up (``fused16_smem``, which ``wide_tiling`` sizes
    the launch with) is the kernel's own."""
    from repro_torch.kernels import transitive_forest_dense as tfd
    lib = tfd._library()
    for args in [(9, 4, 4, 8, 2, 64), (12, 4, 4, 1, 2, 64),
                 (15, 8, 1, 1, 1, 128), (13, 3, 8, 1, 2, 256),
                 (10, 2, 2, 4, 1, 128)]:
        assert lib.transitive_forest_fused16_smem(*args) == \
            tfd.fused16_smem(*args)


@pytest.mark.parametrize("m,n,k,g", [(4, 1536, 576, 6), (4, 576, 32768, 128),
                                     (33, 100, 32766, 6), (3, 24, 9000, 9000),
                                     (5, 40, 4101, 1367)])
def test_w4a8_gemm_kernel_any_group_and_k(cuda, m, n, k, g):
    """Groups that are not a multiple of 4 (byte-wise dots) and K beyond
    one activation tile (4096 bytes per row; groups that straddle tiles),
    against the plain version's function evaluated exactly (float64: the
    group dots are integers, each group term dot * sg is exact).

    Bound: the kernel's own f32 rounding, first order, in the order of
    summation of the instance ``launch_plan`` picks (``_w4a8_bound``).
    Where that is ``w4a8_wgmma`` (group 128 at K = 32,768), ``w4a8_dot``
    runs on the same data too, through the uncounted launcher, and is
    held to the bound of its own order. At 5,461 groups of 6 the bound
    stays below a fiftieth of the mean |group term| * sx, so a dropped or
    half-counted group fails on its own."""
    from repro_torch.kernels.w4a8_gemm import launch_plan, w4a8_gemm_cuda
    rng = np.random.default_rng(m + n + k + g)
    args = [rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32),
            rng.integers(-8, 8, (n, k)).astype(np.int8),
            rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)]
    groups = k // g
    part = np.einsum("mgi,ngi->mgn", args[0].reshape(m, groups, g)
                     .astype(np.float64), args[2].reshape(n, groups, g)
                     .astype(np.float64))
    assert np.abs(part).max() < 2 ** 24            # exact as f32 in-kernel
    terms = part * args[3].T.astype(np.float64)[None]   # (m, groups, n)
    sx = args[1].astype(np.float64)
    exact = terms.sum(1) * sx
    targs = [torch.from_numpy(a).to(cuda) for a in args]
    plan = launch_plan(m, n, k, g, targs[0].data_ptr(), targs[2].data_ptr())
    assert plan.kernel == ("w4a8_wgmma" if g == 128 else "w4a8_dot")
    before = w4a8_gemm_cuda.launches
    got = w4a8_gemm_cuda(*targs, group=g)
    assert w4a8_gemm_cuda.launches == before + 1
    outs = {plan.kernel: got}
    if plan.kernel == "w4a8_wgmma":
        outs["w4a8_dot"] = _w4a8_dot_out(targs, g)
    for kernel, out in outs.items():
        bound = _w4a8_bound(terms, sx, exact, kernel, plan.ranges)
        diff = np.abs(out.cpu().numpy().astype(np.float64) - exact)
        assert (diff <= bound).all(), (kernel,
                                       float((diff / bound).max()))


def _w4a8_bound(terms, sx, exact, kernel, ranges):
    """The first-order bound of ``kernel``'s f32 rounding from the exact
    output, u = 2^-24, times 1.01 for second-order terms, given the exact
    group terms (m, groups, n), sx (m, 1) and the exact output.
    ``w4a8_dot`` (csrc/w4a8_gemm.cu: warp v adds the terms of groups v,
    v + 8, ... in increasing g, then the eight warp sums in order, then
    times sx): u (sum over the additions of |partial sum| + |term|, plus
    the partial sums of the warp sums) |sx| + u |out|. ``w4a8_wgmma``
    (each rank adds its groups' terms in increasing g, ``ranges``, then
    the ranks' sums in rank order, then times sx): u (sum over the
    products of |term|, over each rank's additions of |partial sum|, over
    the rank sums of |running total|) |sx| + u |out|."""
    if kernel == "w4a8_dot":
        err, warp_sums = 0.0, []
        for v in range(8):
            tv = terms[:, v::8]
            err = err + (np.abs(np.cumsum(tv, 1)) + np.abs(tv)).sum(1)
            warp_sums.append(tv.sum(1))
        err = err + np.abs(np.cumsum(warp_sums, 0)[1:]).sum(0)
    else:
        err, totals = np.abs(terms).sum(1), []
        for lo, hi in ranges:
            run = np.cumsum(terms[:, lo:hi], 1)
            err = err + np.abs(run[:, 1:]).sum(1)
            totals.append(run[:, -1])
        err = err + np.abs(np.cumsum(totals, 0)[1:]).sum(0)
    return 1.01 * 2.0 ** -24 * (err * sx + np.abs(exact))


@pytest.mark.parametrize("m,n,k,g,offset", [
    (512, 1536, 576, 48, 0), (9, 200, 960, 96, 0), (512, 576, 1536, 64, 0),
    (512, 1536, 576, 64, 1), (4, 576, 1536, 128, 4)])
def test_w4a8_dot_keeps_its_groups_rows_and_views(cuda, m, n, k, g, offset):
    """``w4a8_dot``, which serves every group outside 32..256 and every
    base that is not 16-byte aligned: groups 48 and 96 (four-code words,
    no tensor-core instance) through the wrapper; groups 64 and 128 with
    qx and qw as views ``offset`` bytes into a buffer (so ``launch_plan``
    routes them to ``w4a8_dot``, and the wrapper copies an odd base to a
    word-aligned one) through the wrapper, and the aligned group 64 at
    M = 512 (64 blocks of 8 rows) through the uncounted launcher. Each
    wrapper call is one ``w4a8_dot`` launch by the counter and runs no
    ``w4a8_wgmma``; every output lies within the first-order bound of
    ``w4a8_dot``'s order from the exact function (``_w4a8_bound``) and
    within the reference's tolerance of the plain version."""
    from repro_torch.kernels.w4a8_gemm import (launch_plan, w4a8_gemm_cuda,
                                               w4a8_gemm_plain)
    rng = np.random.default_rng(m + n + k + g + offset)
    qx = rng.integers(-128, 128, (m, k)).astype(np.int8)
    sx = rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
    qw = rng.integers(-8, 8, (n, k)).astype(np.int8)
    sg = rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)

    def view(a):                # a at ``offset`` bytes into a buffer
        buf = torch.empty(a.size + 16, dtype=torch.int8, device=cuda)
        out = buf[offset:offset + a.size].view(a.shape)
        out.copy_(torch.from_numpy(a))
        return out
    targs = [view(qx), torch.from_numpy(sx).to(cuda), view(qw),
             torch.from_numpy(sg).to(cuda)]
    plan = launch_plan(m, n, k, g, targs[0].data_ptr(), targs[2].data_ptr())
    through_wrapper = plan.kernel == "w4a8_dot"
    assert through_wrapper == (g not in (32, 64, 128, 256) or offset != 0)
    if through_wrapper:
        before = w4a8_gemm_cuda.launches
        got = w4a8_gemm_cuda(*targs, group=g)
        assert w4a8_gemm_cuda.launches == before + 1
        names = _kernel_names(lambda: w4a8_gemm_cuda(*targs, group=g))
        assert sum("w4a8_dot" in nm for nm in names) == 1, names
        assert not any("w4a8_wgmma" in nm for nm in names), names
    else:
        got = _w4a8_dot_out(targs, g)
    part = np.einsum("mgi,ngi->mgn",
                     qx.reshape(m, k // g, g).astype(np.float64),
                     qw.reshape(n, k // g, g).astype(np.float64))
    terms = part * sg.T.astype(np.float64)[None]
    exact = terms.sum(1) * sx.astype(np.float64)
    bound = _w4a8_bound(terms, sx.astype(np.float64), exact, "w4a8_dot",
                        None)
    diff = np.abs(got.cpu().numpy().astype(np.float64) - exact)
    assert (diff <= bound).all(), float((diff / bound).max())
    torch.testing.assert_close(got, w4a8_gemm_plain(*targs, group=g),
                               rtol=2e-3, atol=1e-2)


def _w4a8_inputs(m, n, k, g, cuda, seed, kind="random"):
    """qx, sx, qw, sg from a seed on the card: random int8 activations,
    int4 weights and scales in [0.5, 2), or ``extreme``: activations all
    at -128, 127 or -127, weights at -8 or 7, group scales spanning
    2^-20 .. 2^20."""
    rng = np.random.default_rng(seed)
    if kind == "extreme":
        qx = rng.choice(np.array([-128, 127, -127], np.int8), (m, k))
        qw = rng.choice(np.array([-8, 7], np.int8), (n, k))
        sg = np.exp2(rng.uniform(-20, 20, (n, k // g))).astype(np.float32)
    else:
        qx = rng.integers(-128, 128, (m, k)).astype(np.int8)
        qw = rng.integers(-8, 8, (n, k)).astype(np.int8)
        sg = rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)
    sx = rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
    return [torch.from_numpy(a).to(cuda) for a in (qx, sx, qw, sg)]


@pytest.mark.parametrize("m,n,k,g", [
    (1, 24, 96, 32), (3, 200, 384, 64), (4, 576, 1536, 128),
    (8, 1536, 576, 64), (9, 200, 1024, 256), (64, 576, 1536, 128),
    (130, 200, 384, 128), (512, 1536, 576, 64), (4, 11008, 4096, 128),
    (3, 11008, 256, 256), (64, 11008, 512, 64), (4, 576, 32768, 128),
    (9, 24, 32768, 32), (130, 1536, 2048, 256), (512, 24, 1024, 32),
    (512, 576, 1536, 128)])
def test_w4a8_wgmma_bit_equal_one_launch(cuda, m, n, k, g):
    """The tensor-core instance against ``w4a8_gemm_ordered`` (its own
    order, plain torch): bit-equal; within the reference's tolerance of
    the plain version (rtol 2e-3, atol 1e-2); one launch of
    ``w4a8_wgmma`` per call by the counter and by the profiler's name."""
    from repro_torch.kernels.w4a8_gemm import (launch_plan, w4a8_gemm_cuda,
                                               w4a8_gemm_ordered,
                                               w4a8_gemm_plain)
    args = _w4a8_inputs(m, n, k, g, cuda, m + n + k + g)
    plan = launch_plan(m, n, k, g, args[0].data_ptr(), args[2].data_ptr())
    assert plan.kernel == "w4a8_wgmma"
    before = w4a8_gemm_cuda.launches
    got = w4a8_gemm_cuda(*args, group=g)
    assert w4a8_gemm_cuda.launches == before + 1
    torch.testing.assert_close(
        got, w4a8_gemm_ordered(*args, group=g, plan=plan), rtol=0, atol=0)
    torch.testing.assert_close(got, w4a8_gemm_plain(*args, group=g),
                               rtol=2e-3, atol=1e-2)
    _assert_one_launch_of(lambda: w4a8_gemm_cuda(*args, group=g),
                          "w4a8_wgmma")


@pytest.mark.parametrize("m,n,k,g", [(4, 1536, 1024, 128),
                                     (130, 200, 2048, 256),
                                     (64, 576, 8192, 32)])
def test_w4a8_wgmma_every_split_bit_equal(cuda, m, n, k, g):
    """Every cluster split ``launch_plan`` can pick (1 to 8 ranks along K)
    at decode, prefill and group 32, through the uncounted launcher:
    bit-equal to ``w4a8_gemm_ordered`` at the same split."""
    from repro_torch.kernels import w4a8_gemm as w4
    args = _w4a8_inputs(m, n, k, g, cuda, 7)
    sx = args[1].reshape(-1).contiguous()
    for split in range(1, 9):
        plan = w4.with_split(w4.launch_plan(m, n, k, g, args[0].data_ptr(),
                                            args[2].data_ptr()), split)
        out = torch.full((m, n), float("nan"), device=cuda)
        w4._launch(w4._library(), args[0], sx, args[2], args[3], out, g,
                   plan)
        torch.testing.assert_close(
            out, w4.w4a8_gemm_ordered(*args, group=g, plan=plan), rtol=0,
            atol=0, msg=f"split {split}")


@pytest.mark.parametrize("m,n,k,g", [(4, 576, 1536, 128), (512, 200, 512, 64),
                                     (9, 1536, 1024, 256), (64, 24, 96, 32)])
def test_w4a8_wgmma_extreme_values_bit_equal(cuda, m, n, k, g):
    """All activations at -128, 127 or -127, weights at -8 or 7, group
    scales spanning 2^-20 .. 2^20: bit-equal to ``w4a8_gemm_ordered``."""
    from repro_torch.kernels.w4a8_gemm import (launch_plan, w4a8_gemm_cuda,
                                               w4a8_gemm_ordered)
    args = _w4a8_inputs(m, n, k, g, cuda, 11, kind="extreme")
    plan = launch_plan(m, n, k, g, args[0].data_ptr(), args[2].data_ptr())
    assert plan.kernel == "w4a8_wgmma"
    got = w4a8_gemm_cuda(*args, group=g)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, w4a8_gemm_ordered(*args, group=g, plan=plan), rtol=0, atol=0)


def test_w4a8_wgmma_smem_matches_the_kernel(cuda):
    """The host's carve-up (``wgmma_smem``, which ``launch_plan`` sizes the
    launch and the split's residency with) is the kernel's own."""
    from repro_torch.kernels import w4a8_gemm as w4
    lib = w4._library()
    for bt, (wgs, kb, ns) in w4.TILINGS.items():
        for args in [(bt, wgs, ns, kb), (bt, wgs, 2, 2 * kb),
                     (bt, wgs, 3, 1)]:
            assert lib.w4a8_wgmma_smem(*args) == w4.wgmma_smem(*args)


@pytest.mark.parametrize("xdt,adt", [("float16", "float16"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "float16"),
                                     ("float16", "float32"),
                                     ("float64", "float64"),
                                     ("float64", "bfloat16"),
                                     ("float32", "float64")])
def test_rg_lru_kernel_mixed_dtypes_bit_equal(cuda, xdt, adt):
    """x and a in any of f32, bf16, f16, f64: the output takes x's dtype,
    and kernel and plain version round the same f32 operations (a float64
    input rounded to f32 first): bit-equal."""
    from repro_torch.kernels.rg_lru import rg_lru_cuda, rg_lru_plain
    rng = np.random.default_rng(11)
    b, s, d = 4, 300, 257
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, d)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x, a = x.to(cuda, getattr(torch, xdt)), a.to(cuda, getattr(torch, adt))
    h0 = h0.to(cuda)
    before = rg_lru_cuda.launches
    got = rg_lru_cuda(x, a, h0)
    assert rg_lru_cuda.launches == before + 1
    assert got.dtype == getattr(torch, xdt)
    torch.testing.assert_close(got, rg_lru_plain(x, a, h0), rtol=0, atol=0)


@pytest.mark.parametrize("b,s", [(4, 128), (1, 2100)])
def test_rg_lru_kernel_bit_equal_at_recurrentgemma_prefill(cuda, b, s):
    """recurrentgemma-9b's prefill shapes (D = 4096, f32, h0 = 0: what
    ``apply_rglru`` passes at a 128-token batch of 4 and a 2,100-token
    prompt), a_t in (0.9, 1) and b_t = sqrt(1 - a_t^2) x_t as the block
    forms them: one launch, bit-equal to the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rg_lru import rg_lru_cuda, rg_lru_plain
    gen = torch.Generator(device=cuda).manual_seed(s)
    a = torch.rand((b, s, 4096), generator=gen, device=cuda) * 0.1 + 0.9
    x = torch.sqrt(1 - a * a) * torch.randn((b, s, 4096), generator=gen,
                                            device=cuda)
    h0 = torch.zeros((b, 4096), device=cuda)
    before = rg_lru_cuda.launches
    got = ops.rg_lru(x, a, h0)
    assert rg_lru_cuda.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, rg_lru_plain(x, a, h0), rtol=0, atol=0)


# (b, s, d, x dtype, a dtype, x one element off 16 bytes, kernel); s "st-1"
# and "st+1" are one step either side of the plan's stage (or batch).
_B5_CASES = [
    (4, 1, 4096, "float32", "float32", False, "rg_lru_ring"),
    (4, "st-1", 4096, "float32", "float32", False, "rg_lru_ring"),
    (4, "st+1", 4096, "float32", "float32", False, "rg_lru_ring"),
    (1, 300, 32, "float32", "float32", False, "rg_lru_ring"),
    (1, 300, 4096, "float32", "float32", False, "rg_lru_ring"),
    (2, 100, 4100, "float32", "float32", False, "rg_lru_ring"),
    (2, 100, 4097, "float32", "float32", False, "rg_lru_regs"),
    (2, 100, 4096, "float32", "float32", True, "rg_lru_regs"),
    (2, 100, 4096, "bfloat16", "bfloat16", True, "rg_lru_regs"),
    (2, 300, 512, "float64", "bfloat16", False, "rg_lru_ring"),
    (2, 300, 257, "float64", "bfloat16", False, "rg_lru_regs"),
    (4, 300, 4096, "bfloat16", "bfloat16", False, "rg_lru_ring"),
    (4, 300, 4096, "float16", "float16", False, "rg_lru_ring"),
    (4, "st+1", 4096, "float32", "bfloat16", False, "rg_lru_ring"),
    (3, 1, 33, "bfloat16", "float16", False, "rg_lru_regs"),
    (3, "st-1", 33, "float32", "float32", False, "rg_lru_regs"),
    (3, "st+1", 33, "float32", "float32", False, "rg_lru_regs"),
    (1, 77, 8, "float32", "float64", False, "rg_lru_ring"),
]


def _b5_id(case):
    b, s, d, xdt, adt, off, _ = case
    return f"B{b}-S{s}-D{d}-{xdt}-{adt}" + ("-off" if off else "")


def _b5_inputs(b, s, d, xdt, adt, off, cuda, seed):
    """x, a, h0 from a seed; x one element past a 16-byte aligned base
    when ``off`` (contiguous all the same)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, d)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    x = x.to(cuda, getattr(torch, xdt))
    if off:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        buf[1:].copy_(x.flatten())
        x = buf[1:].view(b, s, d)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x, a.to(cuda, getattr(torch, adt)), h0.to(cuda)


@pytest.mark.parametrize("case", _B5_CASES, ids=_b5_id)
def test_rg_lru_instances_bit_equal_one_launch(cuda, case):
    """Both instances of B5 (``rg_lru_ring`` where x, a and h have 16-byte
    aligned bases and rows, ``rg_lru_regs`` elsewhere) against the plain
    version: bit-equal, one launch per call by the counter and by the
    profiler's name, at S on both sides of a stage, B=1, ragged D, a base
    one element off 16 bytes and float64 x."""
    from repro_torch.kernels.rg_lru import (launch_plan, rg_lru_cuda,
                                            rg_lru_plain)
    b, s, d, xdt, adt, off, kernel = case
    if isinstance(s, str):
        size = torch.empty((), dtype=getattr(torch, xdt)).element_size()
        asize = torch.empty((), dtype=getattr(torch, adt)).element_size()
        st = launch_plan(b, 1, d, size, asize, size, 0 if kernel ==
                         "rg_lru_ring" else 1).st
        s = st + (1 if s == "st+1" else -1)
    x, a, h0 = _b5_inputs(b, s, d, xdt, adt, off, cuda, b + s + d)
    plan = launch_plan(b, s, d, x.element_size(), a.element_size(),
                       x.element_size(), x.data_ptr(), a.data_ptr(), 0)
    assert plan.kernel == kernel
    before = rg_lru_cuda.launches
    got = rg_lru_cuda(x, a, h0)
    assert rg_lru_cuda.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got, rg_lru_plain(x, a, h0), rtol=0, atol=0)
    _assert_one_launch_of(lambda: rg_lru_cuda(x, a, h0), kernel)


@pytest.mark.parametrize("d,off", [(4096, False), (4096, True), (257, False)])
def test_rg_lru_two_calls_bit_identical(cuda, d, off):
    """Two calls of either instance on the same inputs give the same bits
    (B=4, S=2048; recurrentgemma-9b's width at d=4096)."""
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    x, a, h0 = _b5_inputs(4, 2048, d, "float32", "float32", off, cuda, 3)
    first = rg_lru_cuda(x, a, h0)
    second = rg_lru_cuda(x, a, h0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_divides_truly_on_the_card(cuda, dtype):
    """Per-token codes and scales, and the exact pool's V scale, made on
    the card equal the CPU's bit for bit: ``quant.quantize.true_div``
    divides on both devices (a Python-scalar divisor on the card would
    be a reciprocal multiply). The kernels and the reference divide."""
    from repro_torch.quant import quantize_per_token
    from repro_torch.quant.quantize import true_div
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((512, 576))
                          * rng.uniform(1e-3, 1e3, (512, 1)))
                         .astype(np.float32)).to(getattr(torch, dtype))
    q_cpu, s_cpu = quantize_per_token(x)
    q_dev, s_dev = quantize_per_token(x.to(cuda))
    torch.testing.assert_close(q_dev.cpu(), q_cpu, rtol=0, atol=0)
    torch.testing.assert_close(s_dev.cpu(), s_cpu, rtol=0, atol=0)
    amax = x.abs().amax(dim=0, keepdim=True)
    torch.testing.assert_close(true_div(amax.to(cuda), 127.).cpu(),
                               true_div(amax, 127.), rtol=0, atol=0)
