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
    k_split, lut_width, transitive_gemm_cuda)
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


@pytest.mark.parametrize("t", [1, 2, 3, 5, 6, 7, 9, 12])
@pytest.mark.parametrize("wbits", [2, 4, 8])
def test_transitive_gemm_any_t_equals_reference_pallas(t, wbits, rng):
    """T outside {4, 8}: the wrapper (its plain version on CPU tensors;
    on the card the one kernel, at the width ``lut_width`` picks) against
    the reference's ``transitive_gemm_pallas`` in interpret mode, which
    takes any T with bk % T == 0, and the int64 GEMM: exact, one group and
    three."""
    from repro.kernels.transitive_gemm import transitive_gemm_pallas
    m, n, bk = 8, 16, 4 * t
    qx = _codes(rng, (m, 2 * bk), 8)
    qw = _codes(rng, (n, 2 * bk), wbits)
    want = np.asarray(transitive_gemm_pallas(
        jnp.asarray(qx), jnp.asarray(qw), w_bits=wbits, t=t, bm=m, bn=n,
        bk=bk, interpret=True))
    np.testing.assert_array_equal(
        want, qx.astype(np.int64) @ qw.astype(np.int64).T)
    got = transitive_gemm_cuda(torch.from_numpy(qx), torch.from_numpy(qw),
                               w_bits=wbits, t=t)
    assert got.dtype == torch.int32 and got.shape == (m, 1, n)
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    xg = _codes(rng, (5, 3 * t * 2), 8)
    wg = _codes(rng, (7, 3 * t * 2), wbits)
    got = transitive_gemm_cuda(torch.from_numpy(xg), torch.from_numpy(wg),
                               w_bits=wbits, t=t, groups=3)
    want = np.stack([xg[:, i * 2 * t:(i + 1) * 2 * t].astype(np.int64)
                     @ wg[:, i * 2 * t:(i + 1) * 2 * t].astype(np.int64).T
                     for i in range(3)], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t,k,groups,want", [
    (6, 576, 1, (8, True)), (3, 576, 1, (8, True)), (16, 576, 1, (8, True)),
    (32, 576, 1, (8, True)), (4, 576, 1, (8, True)), (6, 1536, 4, (8, True)),
    (9, 36, 1, (4, True)), (3, 12, 1, (4, True)), (2, 12, 3, (4, True)),
    (5, 575, 1, (4, False)), (7, 574, 1, (4, False)), (5, 30, 3, (4, False)),
    (3, 18, 2, (4, False)), (1, 6, 3, (4, False)), (7, 42, 3, (4, False))])
def test_transitive_gemm_lut_width(t, k, groups, want):
    """The kernel's subtile width and instance from K and groups alone
    (T only has to divide K / groups, the reference's contract): 8 where
    K / groups is a multiple of 8, 4 where it is one of 4, else the
    unaligned instance at 4 (K % 4 != 0 at one group; groups of 5, 9, 2
    and 14 bytes; a row stride of 18 bytes)."""
    assert (k // groups) % t == 0
    assert lut_width(k, groups) == want


# The B3 kernel's packed-pair arithmetic (csrc/transitive_gemm.cu), in
# int64 with each 16-bit half kept apart, so the overflow argument runs
# without a card.
_BIAS, _ENTRY_MAX, _HALF, _CH = 512, 1020, 1 << 16, 8


def _flush_every(per_subtile):
    f = 1
    while 2 * f <= _CH and 2 * f * per_subtile < _HALF:
        f *= 2
    return f


def _packed_schedule(w_bits, t):
    """``Schedule<T, S>`` of the kernel: planes in the low segment, and
    subtiles per flush of the low and the high segment."""
    gmax = t // 4 * _ENTRY_MAX
    pa = 6 if gmax * 63 < _HALF else 5
    sa = min(w_bits, pa)
    sb = w_bits - sa
    fa = _flush_every(gmax * ((1 << sa) - 1))
    fb = _flush_every(gmax * ((1 << sb) - 1)) if sb else _CH
    return sa, fa, fb


def _packed_pair_gemm(qx, qw, w_bits, t):
    """int32 qx @ qw^T as the kernel computes it at subtile width ``t``:
    biased nibble LUTs built by doubling, two rows per word, offset-binary
    top plane, planes added into packed segments flushed on the schedule;
    a ragged last subtile (K % t != 0: the unaligned instance) zero-filled
    in x and w. Returns (out, the largest half seen); asserts every half
    stays in [0, 2^16)."""
    m, k = qx.shape
    n = qw.shape[0]
    nl, nj = t // 4, -(-k // t)
    sa, fa, fb = _packed_schedule(w_bits, t)
    pad = nj * t - k
    x = torch.nn.functional.pad(qx.long(), (0, pad))
    qw = torch.nn.functional.pad(qw.long(), (0, pad))
    k += pad
    if m % 2:
        x = torch.cat([x, torch.zeros((1, k), dtype=torch.long)])
    pairs = x.reshape(-1, 2, nj, nl, 4)                 # (P, 2, J, NL, 4)
    lut = torch.full(pairs.shape[:-1] + (1,), _BIAS, dtype=torch.long)
    for b in range(4):                                   # doubling
        lut = torch.cat([lut, lut + pairs[..., b:b + 1]], dim=-1)
    assert 0 <= int(lut.min()) and int(lut.max()) <= _ENTRY_MAX
    u = (qw.long() & ((1 << w_bits) - 1)) ^ (1 << (w_bits - 1))
    planes = (u[None] >> torch.arange(w_bits)[:, None, None]) & 1
    pat = (planes.reshape(w_bits, n, nj, nl, 4)
           << torch.arange(4)).sum(-1)                   # (S, N, J, NL)
    acc = torch.zeros((pairs.shape[0], 2, n), dtype=torch.long)
    seg_a, seg_b = torch.zeros_like(acc), torch.zeros_like(acc)
    top = 0
    for j in range(nj):
        for s in range(w_bits):
            g = sum(lut[:, :, j, h][:, :, pat[s, :, j, h]]
                    for h in range(nl))
            if s < sa:
                seg_a += g << s
            else:
                seg_b += g << (s - sa)
            top = max(top, int(seg_a.max()), int(seg_b.max()))
            assert int(seg_a.min()) >= 0 and int(seg_b.min()) >= 0
            assert top < _HALF, (w_bits, t, j, s, top)
        last = j == nj - 1
        if (j + 1) % fa == 0 or last:
            acc += seg_a
            seg_a.zero_()
        if (j + 1) % fb == 0 or last:
            acc += seg_b << sa
            seg_b.zero_()
    acc -= nl * _BIAS * ((1 << w_bits) - 1) * nj
    acc -= pairs.sum((2, 3, 4))[..., None] << (w_bits - 1)
    out = acc.reshape(-1, n)[:m]
    return ((out + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32), top


@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("wbits", [2, 3, 4, 5, 6, 7, 8])
def test_transitive_gemm_packed_pairs_stay_in_range(wbits, t, rng):
    """No packed half leaves [0, 2^16) under the kernel's flush schedule,
    for random and extreme inputs, and unpacked the result equals the
    plain version and the exact GEMM. Activations 127 against weights
    2^(S-1) - 1 gather the largest entry at every plane, so they reach
    the schedule's bound exactly. At width 4 also K = 79, whose last
    subtile the unaligned instance zero-fills (held against the plain
    version at T = 1, which divides any K)."""
    m, n = 5, 6
    lo, hi = -(1 << (wbits - 1)), (1 << (wbits - 1)) - 1
    sa, fa, fb = _packed_schedule(wbits, t)
    gmax = t // 4 * _ENTRY_MAX
    bound = max(fa * gmax * ((1 << sa) - 1),
                fb * gmax * ((1 << (wbits - sa)) - 1))
    for k in (t * 20, t * 20 - 1) if t == 4 else (t * 20,):  # 2.5 chunks
        inputs = [(_codes(rng, (m, k), 8), _codes(rng, (n, k), wbits))]
        inputs += [(np.full((m, k), a, np.int8),
                    np.full((n, k), b, np.int8))
                   for a in (-128, 127) for b in (lo, hi)]
        tops = []
        for qx, qw in inputs:
            got, top = _packed_pair_gemm(torch.from_numpy(qx),
                                         torch.from_numpy(qw), wbits, t)
            tops.append(top)
            want = ref.transitive_matmul_ref(
                torch.from_numpy(qx), torch.from_numpy(qw), wbits,
                t if k % t == 0 else 1)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            np.testing.assert_array_equal(
                got.numpy(), qx.astype(np.int64) @ qw.astype(np.int64).T)
        assert tops[4] == bound < _HALF     # activations 127, weights hi


@pytest.mark.parametrize("m,n,k,groups,want", [
    (4, 1536, 576, 1, 5), (1, 576, 1536, 1, 8), (4, 576, 1536, 12, 2),
    (64, 192, 576, 1, 5), (512, 1536, 576, 1, 1), (4, 1536, 575, 1, 6)])
def test_transitive_gemm_k_split(m, n, k, groups, want):
    """The cluster split at the serving shapes on a 132-SM card, counted
    in chunks of 8 subtiles of the kernel's width (K=576 at width 8: 9
    chunks -> 5 blocks of 2; K=1536: 24 -> 8 of 3; 12 groups of 128: 2 ->
    2; K=575 at width 4: 144 subtiles, the last ragged, 18 chunks -> 6 of
    3), and for every shape: at most 8 blocks, none of them empty."""
    assert k_split(m, n, k, groups, lut_width(k, groups)[0], 132) == want
    for mm in (1, 4, 8, 9, 64, 512):
        for nn in (8, 192, 576, 1536):
            for kk, gg in ((64, 1), (576, 1), (1536, 1), (1536, 12),
                           (575, 1), (30, 3)):
                width = lut_width(kk, gg)[0]
                chunks = -(-(-(-(kk // gg) // width)) // 8)
                split = k_split(mm, nn, kk, gg, width, 132)
                per_block = -(-chunks // split)
                assert 1 <= split <= min(8, chunks)
                assert (split - 1) * per_block < chunks


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


def test_w4a8_gemm_group_not_a_multiple_of_4_matches_reference(rng):
    """Group 6 over K=576 (the kernel's byte-wise dots): the plain
    version against the reference's ``w4a8_gemm_pallas`` (interpret, one
    K block), at the reference's tolerance, rtol 2e-3 and atol 1e-2."""
    from repro.kernels.w4a8_gemm import w4a8_gemm_pallas
    m, n, k, g = 8, 16, 576, 6
    qx = _codes(rng, (m, k), 8)
    sx = rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
    qw = _codes(rng, (n, k), 4)
    sg = rng.uniform(0.5, 2.0, (n, k // g)).astype(np.float32)
    want = np.asarray(w4a8_gemm_pallas(
        *(jnp.asarray(a) for a in (qx, sx, qw, sg)), group=g, bm=m, bn=n,
        bk=k, interpret=True))
    got = w4a8_gemm_cuda(*(torch.from_numpy(a) for a in (qx, sx, qw, sg)),
                         group=g)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-2)


@pytest.mark.parametrize("xdt,adt,tol", [("float16", "float16", 1e-2),
                                         ("float32", "bfloat16", 3e-4)])
def test_rg_lru_mixed_dtypes_match_reference(xdt, adt, tol, rng):
    """x and a in other dtypes than f32/f32 and bf16/bf16: the output takes
    x's dtype in both packages. Tolerance: the reference's f32 3e-4 where
    the output is f32 (both widen the same a values to f32); in float16
    one output ulp (2^-10 relative) of |h| up to ~10, 1e-2."""
    b, s, d = 2, 256, 64
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    a = rng.uniform(0.8, 0.999, (b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    jx = [jnp.asarray(x, getattr(jnp, xdt)), jnp.asarray(a, getattr(jnp, adt)),
          jnp.asarray(h0, getattr(jnp, xdt))]
    pt = [torch.from_numpy(x).to(getattr(torch, xdt)),
          torch.from_numpy(a).to(getattr(torch, adt)),
          torch.from_numpy(h0).to(getattr(torch, xdt))]
    from repro.kernels.rg_lru import rg_lru_pallas
    want = rg_lru_pallas(*jx, interpret=True)
    got = rg_lru_cuda(*pt)
    assert got.dtype == getattr(torch, xdt)
    assert str(want.dtype) == xdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("adt", ["float64", "float32", "bfloat16"])
def test_rg_lru_float64_matches_reference(adt, rng):
    """float64 x (the reference under 64-bit types): both packages round
    x and a to f32, scan in f32 and give h in float64. Tolerance: the
    reference's f32 3e-4 (its doubling scan rounds otherwise); the plain
    version equals its own f32 run widened, bit for bit."""
    import jax
    b, s, d = 2, 256, 64
    x = rng.standard_normal((b, s, d))
    a = rng.uniform(0.8, 0.999, (b, s, d))
    h0 = rng.standard_normal((b, d))
    from repro.kernels.rg_lru import rg_lru_pallas
    with jax.enable_x64(True):
        want = rg_lru_pallas(jnp.asarray(x), jnp.asarray(a, getattr(
            jnp, adt)), jnp.asarray(h0), interpret=True)
        assert str(want.dtype) == "float64"
        want = np.asarray(want)
    pt = [torch.from_numpy(x), torch.from_numpy(a).to(getattr(torch, adt)),
          torch.from_numpy(h0)]
    got = rg_lru_cuda(*pt)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    f32 = rg_lru_cuda(pt[0].float(), pt[1].float(), pt[2].float())
    torch.testing.assert_close(got, f32.double(), rtol=0, atol=0)


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
