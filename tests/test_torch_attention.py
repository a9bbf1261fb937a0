"""Port parity: attention of ``repro_torch`` against the JAX reference.

The paged decode attention (the plain version of the port's CUDA kernel,
which is what a CPU tensor runs) is held against the reference's Pallas
``paged_attention`` in interpret mode and against its gather +
``attend_cached`` oracle in all four pool layouts: the int8 pool with int8
attention over page sizes 2, 4 and 8, the other three in f32 and bf16
over page sizes 8 and 16, with ragged live page counts. Norms, RoPE and
the prefill attention are held to the float tolerances stated at each
check.
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
from repro_torch.kernels.paged_attention import (  # noqa: E402
    ROW_BUDGET, agreement, paged_attention)
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


def _layout_case(rng, page_size, int8_pool, dtype, b=4, kv=2, g=2, hd=32,
                 max_len=48):
    """A random pool in one layout (int8 with f32 scales, or exact in
    ``dtype``), q in ``dtype``, ragged steps (1, 1, 2 and 3 live pages) and
    a page table whose dead entries point at the null page 0, which holds
    data too (so the exact pool's |V| max over the gathered extent has to
    fold it in)."""
    pps = max_len // page_size
    n_pages = b * pps + 1
    shp = (n_pages, page_size, kv, hd)
    if int8_pool:
        pool = {"k": rng.integers(-128, 128, size=shp, dtype=np.int8),
                "v": rng.integers(-128, 128, size=shp, dtype=np.int8),
                "ks": (rng.random(shp[:-1] + (1,)) * 0.02 + 1e-3)
                .astype(np.float32),
                "vs": (rng.random(shp[:-1] + (1,)) * 0.02 + 1e-3)
                .astype(np.float32)}
    else:
        pool = {"k": rng.standard_normal(shp).astype(np.float32),
                "v": (rng.standard_normal(shp) * 2).astype(np.float32)}
    steps = np.array([0, 1, page_size, 3 * page_size - 1], np.int32)[:b]
    table = np.zeros((b, pps), np.int32)
    nxt = 1
    for s in range(b):
        for p in range(steps[s] // page_size + 1):
            table[s, p], nxt = nxt, nxt + 1
    q = rng.standard_normal((b, 1, kv * g, hd)).astype(np.float32)
    return q, pool, table, steps


def _both(a, dtype):
    """One numpy array as a torch tensor and a jax array, floats cast to
    ``dtype`` from f32 in both (round to nearest even: the same bits)."""
    if a.dtype == np.float32 and dtype == "bfloat16":
        return T(a).to(torch.bfloat16), jnp.asarray(a).astype(jnp.bfloat16)
    return T(a), jnp.asarray(a)


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant,int8_pool", [(True, False), (False, False),
                                             (False, True)],
                         ids=["exact-int8attn", "exact-float",
                              "int8pool-float"])
def test_paged_attention_other_layouts_match_reference(quant, int8_pool,
                                                       dtype, page_size,
                                                       cfgs, rng):
    """The paged attention's three other pool layouts (the plain version
    on CPU tensors) against the reference's Pallas ``paged_attention``
    (interpret mode) and its gather + ``attend_cached`` oracle, in f32 and
    bf16, with ragged steps and dead table entries at page 0.

    Tolerances. Float attention (the exact pool's and the int8 pool's):
    the two packages' f32 dots and softmax sum in other orders, rtol 1e-5
    and atol 1e-5 on O(1) outputs in f32. In bf16 the exact pool's score
    dot and P.V are rounded to bf16 in both, so a different f32 sum order
    can move a rounded value by one bf16 ulp: atol 2^-7 of max|v| (two
    ulps of the largest output). Int8 attention over the exact pool: the
    K codes, the V codes and their scales are equal to the reference's
    (exact; checked below on the gathered extent), the int32 products are
    exact, and the softmax ulps can move a P code by one step: atol one
    P step, max(sv) * 128 / 127."""
    pt_cfg, ref_cfg = cfgs
    pt_cfg = pt_cfg.replace(quant_attention=quant)
    ref_cfg = ref_cfg.replace(quant_attention=quant)
    q, pool, table, steps = _layout_case(rng, page_size, int8_pool, dtype)
    tq, jq = _both(q, dtype)
    tpool, jpool = {}, {}
    for n, a in pool.items():
        tpool[n], jpool[n] = _both(a, dtype)
    scale = 32 ** -0.5
    got = paged_attention(tq, tpool, T(table), T(steps), pt_cfg, scale)
    want_kernel = ref_paged_attention(jq, jpool, jnp.asarray(table),
                                      jnp.asarray(steps), ref_cfg, scale,
                                      interpret=True)
    size = table.shape[1] * page_size
    valid = np.arange(size)[None, :] < np.minimum(steps + 1, size)[:, None]
    gather = {n: RA._gather_pages(a, jnp.asarray(table))
              for n, a in jpool.items()}
    want_oracle = RA.attend_cached(jq, gather["k"], gather["v"],
                                   gather.get("ks"), gather.get("vs"),
                                   jnp.asarray(valid), ref_cfg, scale)
    assert got.shape == q.shape
    assert str(got.dtype).removeprefix("torch.") == str(want_kernel.dtype)
    got32 = got.float().numpy()
    if quant:
        # the codes attend_cached makes over the gathered extent, port
        # against reference: K per token, V against the |V| max
        ck_t = PA._gather_pages(tpool["k"], T(table))
        cv_t = PA._gather_pages(tpool["v"], T(table))
        kk_t, sk_t = PA.quantize_per_token(ck_t)
        kk_j, sk_j = RA.quantize_per_token(gather["k"])
        np.testing.assert_array_equal(kk_t.numpy(), np.asarray(kk_j))
        np.testing.assert_array_equal(sk_t.float().numpy(),
                                      np.asarray(sk_j.astype(jnp.float32)))
        sv_t = cv_t.abs().amax(dim=1, keepdim=True) / 127. + 1e-8
        sv_j = jnp.max(jnp.abs(gather["v"]), axis=1, keepdims=True) \
            / 127. + 1e-8
        np.testing.assert_array_equal(sv_t.float().numpy(),
                                      np.asarray(sv_j.astype(jnp.float32)))
        qv_t = torch.clamp(torch.round(cv_t / sv_t), -128, 127)
        qv_j = jnp.clip(jnp.round(gather["v"] / sv_j), -128, 127)
        np.testing.assert_array_equal(qv_t.float().numpy(),
                                      np.asarray(qv_j.astype(jnp.float32)))
        atol = float(sv_t.float().max()) * 128 / 127
        rtol = 0
    elif dtype == "bfloat16" and not int8_pool:
        atol, rtol = float(np.abs(pool["v"]).max()) * 2 ** -7, 0
    else:
        atol, rtol = 1e-5, 1e-5
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(
            got32, np.asarray(want.astype(jnp.float32)), rtol=rtol,
            atol=atol)
        # and within the bounds the CUDA kernel is held to
        agree = agreement(got, T(np.array(want.astype(jnp.float32))),
                          tpool, T(table), T(steps), pt_cfg, q=tq,
                          scale=scale)
        assert agree["rows_beyond"] <= ROW_BUDGET, agree
        assert agree["worst_loose"] <= 1, agree
    # the live-page walk never reads a dead lane's K, nor (but under int8
    # attention over the exact pool, whose |V| max is taken over whole
    # pages, as the reference's is) its V: scribbling over them leaves
    # the result unchanged
    scribbled = {n: a.clone() for n, a in tpool.items()}
    for s, st in enumerate(steps):
        for lane in range(st + 1, (st // page_size + 1) * page_size):
            pid, off = table[s, lane // page_size], lane % page_size
            scribbled["k"][pid, off] = 127
            if not (quant and not int8_pool):
                scribbled["v"][pid, off] = -128
    again = paged_attention(tq, scribbled, T(table), T(steps), pt_cfg,
                            scale)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("g,hd,kv", [(16, 32, 1), (2, 256, 2), (1, 72, 2),
                                     (4, 72, 1), (1, 320, 2), (4, 320, 1)],
                         ids=["G16-hd32", "G2-hd256", "G1-hd72", "G4-hd72",
                              "G1-hd320", "G4-hd320"])
@pytest.mark.parametrize("quant,int8_pool", [(True, True), (True, False),
                                             (False, False), (False, True)],
                         ids=["int8pool-int8attn", "exact-int8attn",
                              "exact-float", "int8pool-float"])
def test_paged_attention_wide_groups_and_heads_match_reference(
        quant, int8_pool, g, hd, kv, cfgs, rng):
    """The shapes the CUDA kernel takes since its head blocks and wide
    heads (G > 8 query heads per KV head, as chatglm3-6b's 16; hd = 256,
    as recurrentgemma-9b's) and since it takes any head dimension (hd = 72,
    not a multiple of 16; hd = 320, above 256): the port's plain version
    against the
    reference's Pallas ``paged_attention`` (interpret mode) in all four
    layouts, f32, with ragged steps and dead table entries at page 0.
    Tolerances as the layout tests above: int8 attention one P step times
    the V scale (int8 pool: max vs * 128 / 127; exact pool: max sv * 128
    / 127, sv the |V| max over the gathered extent / 127); float attention
    rtol and atol 1e-5 (f32 sums in other orders). The two agree within
    the bounds the CUDA kernel is held to (``agreement``) as well."""
    pt_cfg = cfgs[0].replace(quant_attention=quant)
    ref_cfg = cfgs[1].replace(quant_attention=quant)
    q, pool, table, steps = _layout_case(rng, 8, int8_pool, "float32",
                                         kv=kv, g=g, hd=hd)
    tpool = {n: T(a) for n, a in pool.items()}
    scale = hd ** -0.5
    got = paged_attention(T(q), tpool, T(table), T(steps), pt_cfg, scale)
    want = np.array(ref_paged_attention(
        jnp.asarray(q), {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(table), jnp.asarray(steps), ref_cfg, scale,
        interpret=True))
    assert got.shape == q.shape == want.shape
    rtol = 0
    if quant and int8_pool:
        atol = float(pool["vs"].max()) / 127 * 128
    elif quant:
        cv = PA._gather_pages(tpool["v"], T(table))
        atol = float((cv.abs().amax(1) / 127. + 1e-8).max()) * 128 / 127
    else:
        atol = rtol = 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    agree = agreement(got, T(want), tpool, T(table), T(steps), pt_cfg,
                      q=T(q), scale=scale)
    assert agree["rows_beyond"] <= ROW_BUDGET, agree
    assert agree["worst_loose"] <= 1, agree


def test_paged_attention_refuses_a_head_dim_off_the_kernel(cfgs):
    """No head dimension is off the kernel any more: as the reference's, it
    takes any, and ``launch_plan`` sizes a block for hd = 8, 24, 72, 272,
    320 and 512 in every layout within 227 KiB of shared memory. The
    wrapper still raises, before it builds or launches anything, for what
    the reference refuses too: more than one query position, and heads
    that are not whole groups per KV head. On the CPU the plain version
    takes any hd."""
    from repro_torch.kernels import paged_attention as K
    for hd in (8, 24, 72, 272, 320, 512):
        for itemsize, int8_pool, quant in ((1, True, True), (2, False, True),
                                           (4, False, False),
                                           (1, True, False)):
            plan = K.launch_plan(16, 16, 16, hd, itemsize, int8_pool, quant)
            assert plan.chunk_rows >= 1 and plan.smem <= K.SMEM_LIMIT
    pool = {"k": torch.zeros((3, 4, 2, 72), dtype=torch.int8, device="meta")}
    for q, match in ((torch.zeros((1, 2, 4, 72), device="meta"), "Sq == 1"),
                     (torch.zeros((1, 1, 3, 72), device="meta"),
                      "whole query heads")):
        with pytest.raises(ValueError, match=match):
            K.paged_attention(q, pool, None, None, cfgs[0], 1.0)
    q, pool, table, steps = _layout_case(np.random.default_rng(0), 8, True,
                                         "float32", hd=24)
    out = K.paged_attention(T(q), {n: T(a) for n, a in pool.items()},
                            T(table), T(steps), cfgs[0], 24 ** -0.5)
    assert out.shape == q.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("fault", ["page 0 left out", "live lanes only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_agreement_flags_a_v_max_over_too_few_lanes(fault, dtype, cfgs,
                                                     rng):
    """``agreement`` (the check that holds the CUDA kernel against its
    plain version) catches a kernel whose |V| max, under int8 attention
    over the exact pool, leaves out page 0 (read by dead table entries) or
    every dead lane. Such a kernel computes what the plain version
    computes on a pool whose left-out V rows are zero: those lanes' P is
    exactly 0, so only the V scale moves. The plain version agrees with
    itself exactly."""
    pt_cfg = cfgs[0].replace(quant_attention=True)
    q, pool, table, steps = _layout_case(rng, 16, False, dtype)
    tq = _both(q, dtype)[0]
    tpool = {n: _both(a, dtype)[0] for n, a in pool.items()}
    args = (T(table), T(steps), pt_cfg)
    want = paged_attention(tq, tpool, *args, 32 ** -0.5)
    same = agreement(want, want, tpool, *args)
    assert same["rows_beyond"] == 0 and same["worst_loose"] == 0, same
    left_out = {n: a.clone() for n, a in tpool.items()}
    left_out["v"][0] = 0
    if fault == "live lanes only":
        for s, st in enumerate(steps):
            for lane in range(st + 1, (st // 16 + 1) * 16):
                left_out["v"][table[s, lane // 16], lane % 16] = 0
    bad = paged_attention(tq, left_out, *args, 32 ** -0.5)
    agree = agreement(bad, want, tpool, *args)
    assert agree["rows_beyond"] > ROW_BUDGET, agree


@pytest.mark.parametrize("ambiguous", [True, False],
                         ids=["ambiguous-lane", "unambiguous-lane"])
def test_agreement_takes_an_ambiguous_p_rounding_flip(ambiguous, cfgs, rng):
    """The bf16 float layout: the plain version with one lane's P rounded
    to its other bf16 neighbour, in a row whose output element d = 0
    nearly cancels (V at the row's largest-P lane set so that sum_j P_j
    v_j0 is about 0), so the flip moves that element by more than one bf16
    ulp and the f32 P·V sums' order term together. Where the lane's
    rounding is ambiguous (its f32 value may lie on either side of the
    bf16 midpoint: ``float_roundings``) the kernel may round it so, and
    ``agreement`` leaves no row beyond; where it is not, in a row with no
    ambiguous lane, the row is beyond. q and K hold small
    integers, so every score is exact in bf16 and only P's roundings can
    be ambiguous."""
    from repro_torch.kernels.paged_attention import (bf16_neighbours,
                                                     float_roundings)
    pt_cfg = cfgs[0].replace(quant_attention=False)
    b, kv, g, hd, ps, max_len = 8, 1, 8, 32, 16, 256
    shp = (b * max_len // ps + 1, ps, kv, hd)
    tpool = {"k": T(rng.integers(-2, 3, shp).astype(np.float32)),
             "v": T((rng.standard_normal(shp) * 2).astype(np.float32))}
    tpool = {n: a.to(torch.bfloat16) for n, a in tpool.items()}
    tq = T(rng.integers(-2, 3, (b, 1, kv * g, hd)).astype(np.float32)).to(
        torch.bfloat16)
    steps = T(np.full(b, max_len - 1, np.int32))
    table = T(np.arange(1, shp[0], dtype=np.int32).reshape(b, -1))
    scale = hd ** -0.5
    r = float_roundings(tq, tpool, table, steps, scale)
    assert not r["s_amb"].any()
    p, P, amb = r["p"][:, 0], r["P"][:, 0], r["p_amb"][:, 0]   # (B, G, S)
    lo, ulp = bf16_neighbours(p)
    if ambiguous:
        pick = amb.clone()
    else:
        pick = ((p - lo - ulp / 2).abs() > ulp / 4) & ~amb.any(
            -1, keepdim=True)
    pick &= (p > 1e-3) & (P < P.amax(-1, keepdim=True))
    # the lane whose flip moves element 0 most
    moves = torch.where(pick, r["p_ulp"][:, 0] * r["v"][:, None, :, 0, 0]
                        .abs(), 0.0)
    sb, gh, j = np.unravel_index(int(moves.argmax()), moves.shape)
    top = int(P[sb, gh].argmax())
    # V at the top lane cancels element 0 of row (sb, gh)
    v0 = tpool["v"][table[sb].long()].reshape(-1, kv, hd)[:, 0, 0].double()
    rest = float((P[sb, gh] * v0).sum() - P[sb, gh, top] * v0[top])
    tpool["v"][table[sb, top // ps], top % ps, 0, 0] = \
        -rest / float(P[sb, gh, top])
    args = (table, steps, pt_cfg)
    want = paged_attention(tq, tpool, *args, scale)
    # the plain version (attend_cached's float bf16 layout) with P_j flipped
    ck = PA._gather_pages(tpool["k"], table)
    cv = PA._gather_pages(tpool["v"], table)
    s32 = torch.einsum("bqkgd,bskd->bkgqs", tq.reshape(b, 1, kv, g, hd),
                       ck).to(torch.float32) * scale
    probs = torch.softmax(s32, dim=-1).to(torch.bfloat16)
    assert torch.equal(torch.einsum("bkgqs,bskd->bqkgd", probs, cv)
                       .reshape(want.shape), want)
    probs[sb, 0, gh, 0, j] = (2 * lo[sb, gh, j] + ulp[sb, gh, j]
                              - probs[sb, 0, gh, 0, j].double())
    got = torch.einsum("bkgqs,bskd->bqkgd", probs, cv).reshape(want.shape)
    moved = float((got - want).float().abs()[sb, 0, gh, 0])
    order = 2 * 255 * 2.0 ** -24 * float(       # 256 live lanes
        (probs[sb, 0, gh, 0].double() * cv[sb, :, 0, 0].double().abs())
        .sum())
    assert moved > 2.0 ** -7 * max(abs(float(got[sb, 0, gh, 0])),
                                   abs(float(want[sb, 0, gh, 0]))) + order
    agree = agreement(got, want, tpool, *args, q=tq, scale=scale)
    assert agree["rows_beyond"] == (0 if ambiguous else 1), agree
    assert agree["worst_loose"] <= 1, agree


@pytest.mark.parametrize("beyond", [False, True],
                         ids=["sum-order", "beyond-sum-order"])
def test_agreement_takes_the_p_v_sum_order(beyond, cfgs, rng):
    """The bf16 float layout: two sides that agree on every rounding to
    bf16 but add the row's f32 products P_j v_jd in other orders (lanes
    forward and backward) differ by more than one bf16 ulp of an element
    that nearly cancels (V at four lanes of one row set so that sum_j P_j
    v_j0 is about 1e-8); ``agreement``'s sum-order term, 2 gamma_(n-1)
    sum_j P_j |v_j0|, takes that, and a change of four times the term
    there is beyond. q and K hold small integers (every score exact in
    bf16), and the row has no ambiguous P rounding."""
    from repro_torch.kernels.paged_attention import float_roundings
    pt_cfg = cfgs[0].replace(quant_attention=False)
    b, kv, g, hd, ps, max_len = 8, 1, 8, 32, 16, 256
    shp = (b * max_len // ps + 1, ps, kv, hd)
    tpool = {"k": T(rng.integers(-2, 3, shp).astype(np.float32)),
             "v": T((rng.standard_normal(shp) * 2).astype(np.float32))}
    tpool = {n: a.to(torch.bfloat16) for n, a in tpool.items()}
    tq = T(rng.integers(-2, 3, (b, 1, kv * g, hd)).astype(np.float32)).to(
        torch.bfloat16)
    steps = T(np.full(b, max_len - 1, np.int32))
    table = T(np.arange(1, shp[0], dtype=np.int32).reshape(b, -1))
    scale = hd ** -0.5
    r = float_roundings(tq, tpool, table, steps, scale)
    assert not r["s_amb"].any()
    sb, gh = (~r["p_amb"][:, 0].any(-1)).nonzero()[0].tolist()
    P = r["P"][sb, 0, gh]                                   # (S,)
    lanes = P.argsort(descending=True)[:4].tolist()
    v = tpool["v"]
    at = [(int(table[sb, j // ps]), j % ps) for j in lanes]
    for page, slot in at:
        v[page, slot, 0, 0] = 0
    for (page, slot), j in zip(at, lanes):    # each cuts the rest ~2^-9
        v0 = PA._gather_pages(v, table)[sb, :, 0, 0].double()
        v[page, slot, 0, 0] = float(-(P * v0).sum() / P[j])
    cv = PA._gather_pages(v, table)
    v0 = cv[sb, :, 0, 0].double()
    assert abs(float((P * v0).sum())) < 1e-7
    probs = r["P"][:, 0].float()                            # (B, G, S)
    cvf = cv[:, :, 0].float()                               # (B, S, hd)

    def f32_sum(order):
        acc = torch.zeros(b, g, hd)
        for j in order:
            acc = acc + probs[:, :, j, None] * cvf[:, None, j]
        return acc.to(torch.bfloat16).reshape(b, 1, kv * g, hd)

    want, got = f32_sum(range(max_len)), f32_sum(reversed(range(max_len)))
    term = 2 * 255 * 2.0 ** -24 * float((P * v0.abs()).sum())
    at0 = (sb, 0, gh, 0)
    diff = abs(float(got[at0]) - float(want[at0]))
    assert diff > 2.0 ** -7 * max(abs(float(got[at0])),
                                  abs(float(want[at0])))
    assert diff <= term
    if beyond:
        got[at0] = float(want[at0]) + 4 * term
    agree = agreement(got, want, tpool, table, steps, pt_cfg, q=tq,
                      scale=scale)
    assert agree["rows_beyond"] == int(beyond), agree
    assert agree["worst_loose"] <= 1, agree


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


@pytest.mark.parametrize("window", [0, 64, 2048])
@pytest.mark.parametrize("sq", [2100, 3072])
@pytest.mark.parametrize("offset", [False, True],
                         ids=["from-0", "q_offset-kv_len"])
def test_attend_chunked_matches_reference(sq, window, offset, rng):
    """``attend_chunked`` (the path above CHUNK_THRESHOLD) in f32: one
    chunk of all 2,100 queries, or three of Q_CHUNK = 1024, causal, with a
    local window or none, from position 0 or at ``q_offset`` 40 over 40
    more keys with the last 7 masked by ``kv_len``: the same masks and a
    softmax in another summation order, within atol 1e-5."""
    b, h, d = 1, 2, 16
    q_off, kv_len = (40, sq + 33) if offset else (0, None)
    sk = sq + q_off
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    got = PA.attend_chunked(T(q), T(k), T(v), d ** -0.5, True, window,
                            q_offset=q_off, kv_len=kv_len)
    want = RA.attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             d ** -0.5, True, window, q_offset=q_off,
                             kv_len=kv_len)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_dense_prefill_past_the_chunk_threshold_matches_reference():
    """ROADMAP A2's gate: the reduced smollm in f32 (float linears and
    attention) prefills 2,100 positions through ``attend_chunked`` in both
    packages, from the reference's weights: last-position logits within
    atol 2e-4 and the cached (RoPE'd) K/V within the RoPE test's rtol
    2e-6 / atol 2e-5 (cos and sin of angles up to 2,100 differ by ulps)."""
    import jax
    from repro.configs import get_reduced as ref_get_reduced
    from repro.models.model import Model as RefModel
    from repro_torch.convert import params_from_reference
    from repro_torch.models.model import Model
    ref_model = RefModel(ref_get_reduced("smollm_135m").replace(
        dtype=jnp.float32))
    raw = ref_model.init(jax.random.PRNGKey(0))
    model = Model(get_reduced("smollm_135m").replace(dtype=torch.float32),
                  device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    toks = np.random.default_rng(3).integers(0, 512, size=(1, 2100))
    want, wc = ref_model.prefill(raw, {"tokens": jnp.asarray(toks)}, 2112)
    got, gc = model.prefill(params, {"tokens": T(toks)}, 2112)
    assert PA.CHUNK_THRESHOLD < 2100
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(gc["body"]["c0"][name].numpy(),
                                   np.asarray(wc["body"]["c0"][name]),
                                   rtol=2e-6, atol=2e-5)


def test_paged_prefill_past_the_chunk_threshold_matches_reference(rng):
    """Per-request paged prefill whose total passes CHUNK_THRESHOLD: a
    1,040-position shared prefix (65 pages of 16, gathered from an exact
    f32 pool) and a 1,060-position suffix take ``attend_chunked`` with
    ``q_offset`` = 1,040 in both packages. The f32 block against the
    reference's ``apply_attn_paged_prefill``: output within atol 2e-4
    and the pool within rtol 1e-5 / atol 1e-6."""
    import jax
    from repro_torch.convert import params_from_reference
    ref_cfg = ref_reduced("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_reduced("smollm_135m").replace(dtype=torch.float32)
    raw = RA.init_attn(jax.random.PRNGKey(2), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    ps, n_pre, ls = 16, 65, 1060
    n_suf = -(-ls // ps)
    n_pages = 1 + n_pre + n_suf
    shape = (n_pages, ps, cfg.n_kv_heads, cfg.hd)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    pre = np.arange(1, 1 + n_pre, dtype=np.int32)
    wp = np.repeat(np.arange(1 + n_pre, n_pages, dtype=np.int32), ps)[:ls]
    wo = np.tile(np.arange(ps, dtype=np.int32), n_suf)[:ls]
    x = rng.standard_normal((1, ls, cfg.d_model)).astype(np.float32)
    assert n_pre * ps + ls > PA.CHUNK_THRESHOLD
    want, wpool = RA.apply_attn_paged_prefill(
        raw, jnp.asarray(x), ref_cfg,
        pool={n: jnp.asarray(a) for n, a in pool.items()},
        prefix_page_ids=jnp.asarray(pre), write_page_ids=jnp.asarray(wp),
        write_offs=jnp.asarray(wo), write_from=0)
    tpool = {n: T(a.copy()) for n, a in pool.items()}
    got, gpool = PA.apply_attn_paged_prefill(
        params, T(x), cfg, pool=tpool, prefix_page_ids=T(pre),
        write_page_ids=T(wp), write_offs=T(wo), write_from=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    for n in pool:
        np.testing.assert_allclose(gpool[n].numpy(), np.asarray(wpool[n]),
                                   rtol=1e-5, atol=1e-6)


def _one_block_smem(g, hd, s):
    """Shared memory of the previous one-block-per-(slot, KV head) design:
    the whole G x s score row (f32 + int8 codes) and its small arrays. It
    ran every shape where this fit 227 KiB; the cluster must too."""
    return 5 * g * s + 512 * g + 128 + 4 * hd + 512 + 5 * g * hd


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("n_pages", [1, 2, 3, 7, 16, 128, 512])
def test_launch_plan_owns_every_page_once_and_fits(n_pages, hd):
    """The B2 launch (``launch_plan``): for every G up to 32, page size
    and layout, each page index of the table belongs to exactly one rank,
    the cluster has at most 8 blocks and divides the launch's grid, whose
    blocks serve every (slot, rank, KV head, query head) once with at most
    8 query heads a block, the chunk of staged rows fits the rank's rows,
    the block's shared memory fits 227 KiB, and every shape the one-block
    design took (at most 8 heads a block) is still taken."""
    from repro_torch.kernels.paged_attention import (SMEM_LIMIT,
                                                     heads_per_block,
                                                     launch_plan, smem_bytes)
    layouts = [(1, True, True), (1, True, False), (2, False, True),
               (4, False, True), (2, False, False), (4, False, False)]
    for g in (1, 3, 5, 8, 9, 16, 32):
        for page_size in (1, 16, 256):
            for itemsize, int8_pool, quant in layouts:
                try:
                    plan = launch_plan(n_pages, page_size, g, hd, itemsize,
                                       int8_pool, quant)
                except ValueError:              # so did the one-block one
                    assert _one_block_smem(
                        heads_per_block(g), hd, n_pages * page_size) \
                        > SMEM_LIMIT
                    continue
                assert 1 <= plan.cluster <= min(8, n_pages)
                assert 1 <= plan.heads <= 8
                for b in (1, 4, 64):        # the grid the wrapper launches
                    grid_x, grid_y = plan.grid(b, 3)
                    assert grid_x % plan.cluster == 0
                    assert sorted((x // plan.cluster, x % plan.cluster)
                                  for x in range(grid_x)) == [
                        (s, r) for s in range(b)
                        for r in range(plan.cluster)]
                    # grid row y: KV head y // head_blocks, its query
                    # heads from heads * (y % head_blocks), as the kernel
                    served = [(y // plan.head_blocks, h) for y in
                              range(grid_y)
                              for h in range((y % plan.head_blocks)
                                             * plan.heads,
                                             min((y % plan.head_blocks + 1)
                                                 * plan.heads, g))]
                    assert sorted(served) == [(kvh, h) for kvh in range(3)
                                              for h in range(g)]
                owned = [p for r in range(plan.cluster)
                         for p in plan.pages(r, n_pages)]
                assert sorted(owned) == list(range(n_pages))
                assert all(len(plan.pages(r, n_pages)) <= plan.pages_per_rank
                           for r in range(plan.cluster))
                lanes = plan.pages_per_rank * page_size
                assert 1 <= plan.chunk_rows <= lanes
                assert plan.smem == smem_bytes(g, hd, itemsize, int8_pool,
                                               quant, lanes, plan.chunk_rows)
                assert plan.smem <= SMEM_LIMIT
                if plan.chunk_rows < lanes:      # the largest that fits
                    assert smem_bytes(g, hd, itemsize, int8_pool, quant,
                                      lanes, plan.chunk_rows + 1) > SMEM_LIMIT
    for page_size in (8, 16, 32, 64):            # long tables, big heads
        for pages in (n_pages * 3, n_pages * 8):
            if _one_block_smem(8, hd, pages * page_size) <= SMEM_LIMIT:
                for g in (8, 16):
                    plan = launch_plan(pages, page_size, g, hd, 4, False,
                                       True)
                    assert plan.smem <= SMEM_LIMIT

