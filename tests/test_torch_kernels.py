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
