"""Port parity: the plain GEMM / recurrence versions and the public kernel
API of ``repro_torch`` against the JAX reference, on CPU tensors.

Same numpy inputs into both packages. Integer results (bit planes,
TransRows, subset-sum LUTs, int32 GEMM accumulators) are equal exactly.
The group-dequant GEMM and the recurrence are held to the reference's own
tolerances (``tests/test_kernels.py``): the reference's Pallas kernels
sum f32 group terms and scan in other orders than a plain loop.
The reference's ``ops`` run their Pallas kernels in interpret mode here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bitslice as ref_bitslice  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import bitslice  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rg_lru import rg_lru_cuda  # noqa: E402
from repro_torch.kernels.transitive_gemm import (  # noqa: E402
    transitive_gemm_cuda)
from repro_torch.kernels.w4a8_gemm import w4a8_gemm_cuda  # noqa: E402


def _codes(rng, shape, bits):
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bit_planes_and_transrows_equal_reference(bits, rng):
    w = _codes(rng, (6, 32), bits).astype(np.int32)
    planes = bitslice.bit_planes_torch(torch.from_numpy(w), bits)
    want = np.asarray(ref_bitslice.bit_planes_jnp(jnp.asarray(w), bits))
    assert planes.dtype == torch.uint8
    np.testing.assert_array_equal(planes.numpy(), want)
    for t in (4, 8):
        rows = bitslice.pack_transrows_torch(planes, t)
        np.testing.assert_array_equal(
            rows.numpy(),
            np.asarray(ref_bitslice.pack_transrows_jnp(jnp.asarray(want), t)))
        np.testing.assert_array_equal(
            rows.numpy(), bitslice.transrow_matrix(w, bits, t))


def test_lut_build_equals_reference(rng):
    xt = rng.integers(-128, 128, (3, 5, 8)).astype(np.int32)
    got = ref.lut_build_ref(torch.from_numpy(xt))
    assert got.dtype == torch.int32 and got.shape == (3, 5, 256)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ref.lut_build_ref(jnp.asarray(xt))))


@pytest.mark.parametrize("wbits,t", [(8, 8), (4, 8), (8, 4), (2, 8), (4, 4)])
def test_transrows_and_transitive_matmul_ref_equal_reference(wbits, t, rng):
    qx = _codes(rng, (2, 3, 64), 8)
    qw = _codes(rng, (10, 64), wbits)
    np.testing.assert_array_equal(
        ref._transrows(torch.from_numpy(qw), wbits, t).numpy(),
        np.asarray(ref_ref._transrows(jnp.asarray(qw), wbits, t)))
    got = ref.transitive_matmul_ref(torch.from_numpy(qx),
                                    torch.from_numpy(qw), wbits, t)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 10)
    want = ref_ref.transitive_matmul_ref(jnp.asarray(qx), jnp.asarray(qw),
                                         wbits, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.einsum("bsk,nk->bsn", qx.astype(np.int64),
                               qw.astype(np.int64)))


def test_transitive_matmul_grouped_ref_equals_reference(rng):
    xg = _codes(rng, (5, 4, 16), 8)
    wg = _codes(rng, (12, 4, 16), 4)
    got = ref.transitive_matmul_grouped_ref(torch.from_numpy(xg),
                                            torch.from_numpy(wg), 4, 8)
    want = ref_ref.transitive_matmul_grouped_ref(jnp.asarray(xg),
                                                 jnp.asarray(wg), 4, 8)
    assert got.shape == (5, 4, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# a subset of tests/test_kernels.py's sweep: one ragged case, every
# (w_bits, T) pair of the reference sweep
@pytest.mark.parametrize("m,n,k", [(8, 8, 16), (130, 70, 512), (1, 8, 64)])
@pytest.mark.parametrize("wbits,t", [(8, 8), (4, 8), (8, 4), (2, 8)])
def test_ops_transitive_gemm_equals_reference(m, n, k, wbits, t, rng):
    qx = _codes(rng, (m, k), 8)
    qw = _codes(rng, (n, k), wbits)
    got = ops.transitive_gemm(torch.from_numpy(qx), torch.from_numpy(qw),
                              w_bits=wbits, t=t)
    want = np.asarray(ref_ops.transitive_gemm(jnp.asarray(qx),
                                              jnp.asarray(qw),
                                              w_bits=wbits, t=t))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_transitive_gemm_batched_and_validation(rng):
    qx = _codes(rng, (2, 5, 32), 8)
    qw = _codes(rng, (12, 32), 4)
    got = ops.transitive_gemm(torch.from_numpy(qx), torch.from_numpy(qw),
                              w_bits=4, t=8)
    want = np.asarray(ref_ops.transitive_gemm(jnp.asarray(qx),
                                              jnp.asarray(qw), w_bits=4,
                                              t=8))
    assert got.shape == (2, 5, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="divisible by T=8"):
        ops.transitive_gemm(torch.zeros((2, 12), dtype=torch.int8),
                            torch.zeros((3, 12), dtype=torch.int8))


@pytest.mark.parametrize("wbits,t", [(4, 8), (8, 4), (2, 8)])
def test_ops_transitive_gemm_grouped_equals_reference(wbits, t, rng):
    xg = _codes(rng, (2, 3, 4, 32), 8)
    wg = _codes(rng, (20, 4, 32), wbits)
    got = ops.transitive_gemm_grouped(torch.from_numpy(xg),
                                      torch.from_numpy(wg), w_bits=wbits,
                                      t=t)
    want = np.asarray(ref_ops.transitive_gemm_grouped(
        jnp.asarray(xg), jnp.asarray(wg), w_bits=wbits, t=t))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,k,g", [(8, 16, 256, 64), (130, 200, 384, 128),
                                     (3, 24, 96, 32)])
def test_w4a8_gemm_matches_reference(m, n, k, g, rng):
    qx = _codes(rng, (m, k), 8)
    sx = rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
    qw = _codes(rng, (n, k), 4)
    sg = rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)
    pt = [torch.from_numpy(a) for a in (qx, sx, qw, sg)]
    jx = [jnp.asarray(a) for a in (qx, sx, qw, sg)]
    want_ref = np.asarray(ref_ref.w4a8_matmul_ref(*jx))
    got_ref = ref.w4a8_matmul_ref(*pt)
    assert got_ref.dtype == torch.float32 and got_ref.shape == (m, n)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, rtol=2e-3,
                               atol=1e-2)
    got = ops.w4a8_gemm(*pt, group=g)
    want = np.asarray(ref_ops.w4a8_gemm(*jx, group=g))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-2)


@pytest.mark.parametrize("b,s,d", [(1, 64, 32), (2, 256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_lru_matches_reference(b, s, d, dtype, rng):
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    a = rng.uniform(0.8, 0.999, (b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(v, jdt) for v in (x, a, h0)]
    pt = [torch.from_numpy(v).to(tdt) for v in (x, a, h0)]
    tol = 3e-2 if dtype == "bfloat16" else 3e-4
    got_ref = ref.rg_lru_ref(*pt)
    assert got_ref.dtype == tdt and got_ref.shape == (b, s, d)
    np.testing.assert_allclose(
        got_ref.float().numpy(),
        np.asarray(ref_ref.rg_lru_ref(*jx), np.float32), rtol=tol, atol=tol)
    got = ops.rg_lru(*pt)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref_ops.rg_lru(*jx), np.float32),
        rtol=tol, atol=tol)


def test_wrappers_take_the_plain_version_on_cpu_without_launching(rng):
    qx = torch.from_numpy(_codes(rng, (4, 64), 8))
    qw = torch.from_numpy(_codes(rng, (8, 64), 4))
    sg = torch.ones((8, 2))
    x = torch.randn((1, 5, 3))
    before = (transitive_gemm_cuda.launches, w4a8_gemm_cuda.launches,
              rg_lru_cuda.launches)
    out = transitive_gemm_cuda(qx, qw, w_bits=4, groups=2)
    assert out.shape == (4, 2, 8) and out.dtype == torch.int32
    w4a8_gemm_cuda(qx, torch.ones((4, 1)), qw, sg, group=32)
    rg_lru_cuda(x, x, x[:, 0])
    assert (transitive_gemm_cuda.launches, w4a8_gemm_cuda.launches,
            rg_lru_cuda.launches) == before
