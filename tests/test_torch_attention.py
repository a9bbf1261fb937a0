"""Port parity: attention of ``repro_torch`` against the JAX reference.

The paged decode attention (the plain version of the port's CUDA kernel,
which is what a CPU tensor runs) is held against the reference's Pallas
``paged_attention`` in interpret mode and against its gather +
``attend_cached`` oracle, over page sizes 2, 4 and 8 with ragged live
page counts. Norms, RoPE and the prefill attention are held to the float
tolerances stated at each check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as ref_paged_attention)
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402

T = torch.from_numpy


@pytest.fixture(scope="module")
def cfgs():
    ref = ref_serve_config(ref_reduced("smollm_135m")).replace(
        dtype=jnp.float32)
    pt = serve_config(get_reduced("smollm_135m")).replace(
        dtype=torch.float32)
    return pt, ref


def test_rms_norm_and_rope_match(rng):
    """f32 RMSNorm and RoPE: the same element-wise formulas; torch and XLA
    may differ by an ulp or two in rsqrt / pow / cos / sin, so rtol 1e-6
    on O(1) values."""
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        PA.rms_norm(T(x), T(scale), 1e-6).numpy(),
        np.asarray(RA.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=1e-6, atol=1e-6)
    pos = np.array([[0, 1, 2, 7, 300], [5, 6, 7, 8, 9]], np.int32)
    for partial in (False, True):
        np.testing.assert_allclose(
            PA.rope(T(x), T(pos), 10000.0, partial).numpy(),
            np.asarray(RA.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                               partial)),
            rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_attend_full_matches(quant, rng):
    """Prefill attention. Unquantized: f32 einsum + softmax in another
    summation order, rtol 1e-5. Quantized: int8 scores and P.V are exact
    integer products (float64 in the port), so differences come only from
    softmax ulps that may move a P code by one step at a rounding
    boundary: atol of one P step (1/127 of the row max times max|v|)."""
    b, sq, h, d = 2, 6, 4, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    mask = np.tril(np.ones((sq, sq), bool))[None, None]
    got = PA.attend_full(T(q), T(k), T(v), T(mask), d ** -0.5, quant)
    want = np.asarray(RA.attend_full(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask),
                                     d ** -0.5, quant))
    if quant:
        step = np.abs(v).max() / 127.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=step)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _paged_case(rng, page_size, b=4, kv=2, g=2, hd=32, max_len=32):
    """A random int8 pool with f32 scales, ragged live counts (1, 1, 2
    and 3 pages), and a page table whose dead entries hit the null page."""
    pps = max_len // page_size
    n_pages = b * pps + 1
    k = rng.integers(-128, 128, size=(n_pages, page_size, kv, hd),
                     dtype=np.int8)
    v = rng.integers(-128, 128, size=(n_pages, page_size, kv, hd),
                     dtype=np.int8)
    ks = (rng.random((n_pages, page_size, kv, 1)) * 0.02 + 1e-3) \
        .astype(np.float32)
    vs = (rng.random((n_pages, page_size, kv, 1)) * 0.02 + 1e-3) \
        .astype(np.float32)
    steps = np.array([0, 1, page_size, 3 * page_size - 1], np.int32)[:b]
    table = np.zeros((b, pps), np.int32)
    nxt = 1
    for s in range(b):
        for p in range(steps[s] // page_size + 1):
            table[s, p], nxt = nxt, nxt + 1
    q = rng.standard_normal((b, 1, kv * g, hd)).astype(np.float32)
    pool = {"k": k, "v": v, "ks": ks, "vs": vs}
    return q, pool, table, steps


@pytest.mark.parametrize("page_size", [2, 4, 8])
def test_paged_decode_matches_reference_kernel_and_oracle(page_size, cfgs,
                                                          rng):
    """The port's paged attention (plain version on CPU) vs the reference
    Pallas kernel (interpret mode) and its gather oracle. Scores are exact
    int32 products times the same f32 scale factors in the same order;
    the softmax exp and sums may differ by ulps, which can move one P
    code by one step at a rounding boundary, so the tolerance is one P
    step times max|v|: atol = max(p * vs) / 127 * 128."""
    pt_cfg, ref_cfg = cfgs
    q, pool, table, steps = _paged_case(rng, page_size)
    scale = 32 ** -0.5
    got = paged_attention(T(q), {n: T(a) for n, a in pool.items()},
                          T(table), T(steps), pt_cfg, scale)
    assert got.shape == q.shape and got.dtype == torch.float32
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    want_kernel = np.asarray(ref_paged_attention(
        jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(steps),
        ref_cfg, scale, interpret=True))
    size = table.shape[1] * page_size
    valid = np.arange(size)[None, :] < np.minimum(steps + 1, size)[:, None]
    gather = {n: RA._gather_pages(a, jnp.asarray(table))
              for n, a in jpool.items()}
    want_oracle = np.asarray(RA.attend_cached(
        jnp.asarray(q), gather["k"], gather["v"], gather["ks"],
        gather["vs"], jnp.asarray(valid), ref_cfg, scale))
    atol = pool["vs"].max() / 127.0 * 128
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=atol)
    np.testing.assert_allclose(got.numpy(), want_oracle, rtol=0, atol=atol)
    # the live-page walk never reads past a slot's step: scribbling over
    # every dead lane of every live page leaves the result unchanged
    scribbled = {n: a.copy() for n, a in pool.items()}
    for s, st in enumerate(steps):
        for lane in range(st + 1, (st // page_size + 1) * page_size):
            pid, off = table[s, lane // page_size], lane % page_size
            scribbled["k"][pid, off] = 127
            scribbled["v"][pid, off] = -128
    again = paged_attention(T(q), {n: T(a) for n, a in scribbled.items()},
                            T(table), T(steps), pt_cfg, scale)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_paged_attention_other_layouts_raise(cfgs, rng):
    pt_cfg, _ = cfgs
    q, pool, table, steps = _paged_case(rng, 4)
    with pytest.raises(NotImplementedError, match="int8 pool"):
        paged_attention(T(q), {n: T(a) for n, a in pool.items()}, T(table),
                        T(steps), pt_cfg.replace(quant_attention=False),
                        32 ** -0.5)


def test_paged_decode_layer_kernel_vs_gather(cfgs, rng):
    """apply_attn_paged_decode through the kernel wrapper and through the
    gather path writes the same pool bytes and returns the same output
    (on CPU both run the same plain version)."""
    import repro_torch.models.model as M
    pt_cfg, _ = cfgs
    model = M.Model(pt_cfg.replace(n_layers=1), device="cpu")
    params = M._index(model.init(3)["blocks"], 0)["b0"]
    q, pool, table, steps = _paged_case(rng, 4, b=4, kv=2, g=2, hd=32)
    x = torch.from_numpy(rng.standard_normal((4, 1, 128)).astype(np.float32))
    outs, pools = [], []
    for kernel in (False, True):
        p = {n: T(a.copy()) for n, a in pool.items()}
        y, p = PA.apply_attn_paged_decode(params, x, pt_cfg, pool=p,
                                          page_indices=T(table),
                                          steps=T(steps), kernel=kernel)
        outs.append(y)
        pools.append(p)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for n in pool:
        torch.testing.assert_close(pools[0][n], pools[1][n], rtol=0, atol=0)
