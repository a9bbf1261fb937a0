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
    """Tolerance: two P-code steps, 2 * max(vs) * 128 / 127 (the reason is
    in chip_smoke.check_attention)."""
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
    tol = 2 * float(pool["vs"].max()) * 128 / 127
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# (m, n, k, w_bits, t, groups, fill): fill None draws random codes; (a, b)
# fills x with a and w with b ("lo" -2^(S-1), "hi" 2^(S-1) - 1), which
# pushes the kernel's packed 16-bit halves to their limits (0 and the
# flush schedule's bound). Split cases: K=1536 at M=1 runs 8 blocks per
# cluster, K=576 at M=4 5, 12 groups of 128 at M=4 2, M=512 N=1536 none.
_TGEMM_CASES = [
    (4, 1536, 576, 4, 8, 1, None), (130, 70, 512, 4, 8, 1, None),
    (1, 8, 64, 8, 8, 1, None), (33, 192, 576, 8, 4, 1, None),
    (17, 96, 256, 2, 8, 1, None), (512, 576, 1536, 4, 8, 1, None),
    (4, 576, 1536, 4, 8, 12, None), (9, 40, 96, 4, 4, 3, None),
    (1, 576, 1536, 4, 8, 1, None), (4, 576, 576, 4, 8, 1, None),
    (1, 192, 1536, 4, 8, 12, None), (512, 1536, 576, 4, 8, 1, None)]
_TGEMM_CASES += [(20, 136, 640, bits, t, 1, (a, b))
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
    from repro_torch.kernels.transitive_gemm import (transitive_gemm_cuda,
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
    before = transitive_gemm_cuda.launches
    got = transitive_gemm_cuda(x.to(cuda), w.to(cuda), **kw)
    assert transitive_gemm_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), transitive_gemm_plain(x, w, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,n,k,g", [(4, 576, 1536, 128), (512, 1536, 576, 64),
                                     (130, 200, 384, 128), (3, 24, 96, 32)])
def test_w4a8_gemm_kernel_within_tolerance(cuda, m, n, k, g):
    """The reference's tolerance (rtol 2e-3, atol 1e-2): exact group dots,
    f32 group terms summed in another order."""
    from repro_torch.kernels.w4a8_gemm import w4a8_gemm_cuda, w4a8_gemm_plain
    rng = np.random.default_rng(m + n + k + g)
    args = [rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32),
            rng.integers(-8, 8, (n, k)).astype(np.int8),
            rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)]
    args = [torch.from_numpy(a).to(cuda) for a in args]
    before = w4a8_gemm_cuda.launches
    got = w4a8_gemm_cuda(*args, group=g)
    assert w4a8_gemm_cuda.launches == before + 1
    torch.testing.assert_close(got, w4a8_gemm_plain(*args, group=g),
                               rtol=2e-3, atol=1e-2)


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
