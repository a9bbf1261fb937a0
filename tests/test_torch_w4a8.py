"""B4's launch plan and its plain versions on the CPU:
``repro_torch.kernels.w4a8_gemm``.

``launch_plan`` is a pure function of the shapes and base addresses: it
picks the instance (``w4a8_wgmma`` on the int8 tensor cores for groups
32, 64, 128 and 256 on 16-byte aligned bases, ``w4a8_dot`` elsewhere),
the tile, the ring and the cluster split along K. These tests hold it to
what the kernel needs, walk the kernel's index arithmetic (which k-steps
each group's wgmmas read, which boxes each stage loads) in Python, and
hold ``w4a8_gemm_ordered`` (the kernel's own order of f32 roundings, to
which the kernel is held bit for bit on the card) to the exact function
within its first-order rounding bound and to the reference's
``ops.w4a8_gemm`` (Pallas in interpret mode) within the reference's
tolerance, rtol 2e-3 and atol 1e-2 (``tests/test_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels.w4a8_gemm import (  # noqa: E402
    BOX_K, GPC_SMS, GPCS, GROUPS, KSTEP, MAX_SPLIT, SMEM_LIMIT, SMEM_PER_SM,
    SMEM_RESERVED, SMS, launch_plan, tile_bytes, w4a8_gemm_ordered, w4a8_gemm_plain,
    wgmma_smem, with_split)

MS = (1, 3, 4, 8, 9, 64, 130, 512)
NS = (24, 200, 576, 1536, 11008)
# (K, group): smollm-135m's and llama1_7b's widths, and K up to 32,768
KGS = ((576, 64), (1536, 128), (4096, 128), (11008, 128), (96, 32),
       (1024, 256), (32768, 32), (32768, 256))
ALIGNED = 1 << 20


def _inputs(rng, m, n, k, group):
    qx = rng.integers(-128, 128, (m, k)).astype(np.int8)
    sx = rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
    qw = rng.integers(-8, 8, (n, k)).astype(np.int8)
    sg = rng.uniform(0.5, 2.0, (n, k // group)).astype(np.float32)
    return qx, sx, qw, sg


@pytest.mark.parametrize("k,group", KGS)
@pytest.mark.parametrize("n", NS)
def test_launch_plan_covers_every_output_once_and_fits(n, k, group):
    """Every (m, n) output lies in exactly one tile, every group in exactly
    one rank's contiguous range (ranks in order, none empty), the ring and
    a split's f32 tile fit a block's shared memory, each stage holds whole
    groups, and a split plan keeps all its blocks resident at once."""
    for m in MS:
        plan = launch_plan(m, n, k, group, ALIGNED, ALIGNED)
        assert plan.kernel == "w4a8_wgmma"
        gx, gy, gz = plan.grid
        seen = np.zeros((gx * plan.bt, gy * plan.rows), dtype=np.int64)
        for x in range(gx):            # block (x, y) stores tokens from
            for y in range(gy):        # bt * x and weight rows from rows * y
                seen[x * plan.bt:(x + 1) * plan.bt,
                     y * plan.rows:(y + 1) * plan.rows] += 1
        assert (seen[:m, :n] == 1).all() and seen.sum() == seen.size
        assert gx * plan.bt - m < plan.bt and gy * plan.rows - n < plan.rows
        groups = k // group
        assert gz == plan.split == len(plan.ranges)
        assert 1 <= plan.split <= min(MAX_SPLIT, groups)
        assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == groups
        for (lo, hi), (lo2, _) in zip(plan.ranges, plan.ranges[1:]):
            assert hi == lo2
        sizes = [hi - lo for lo, hi in plan.ranges]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert plan.smem == wgmma_smem(plan.bt, plan.wgs, plan.ns, plan.kb)
        assert plan.smem <= SMEM_LIMIT and plan.ns >= 2
        if plan.split > 1:
            assert tile_bytes(plan.bt, plan.wgs) <= plan.smem - 1024 - \
                16 * plan.ns
            resident = SMEM_PER_SM // (plan.smem + SMEM_RESERVED)
            assert gx * gy * gz <= SMS * resident
        assert 4 * plan.kb % (group // KSTEP) == 0
        assert plan.threads == (plan.wgs + 1) * 128
        assert plan.rows == 64 * plan.wgs


@pytest.mark.parametrize("m,n,k,group", [
    (4, 1536, 576, 6), (4, 576, 32736, 96), (4, 24, 1024, 512),
    (3, 24, 9000, 9000), (5, 40, 4101, 1367), (64, 576, 1536, 48)])
def test_launch_plan_takes_w4a8_dot_elsewhere(m, n, k, group):
    """Groups outside 32, 64, 128, 256 (every group % 32 != 0 among them)
    and bases off 16 bytes go to ``w4a8_dot``: one range, its grid."""
    for ptrs in ((ALIGNED, ALIGNED), (ALIGNED + 4, ALIGNED),
                 (ALIGNED, ALIGNED + 8)):
        plan = launch_plan(m, n, k, group, *ptrs)
        assert plan.kernel == "w4a8_dot"
        assert plan.ranges == ((0, k // group),)
        assert plan.grid == (-(-n // 32), -(-m // 8), 1)
    if group in GROUPS:
        return
    with pytest.raises(ValueError):
        launch_plan(m, n, k + 1, group)


@pytest.mark.parametrize("n,k,group", [(1536, 576, 64), (576, 1536, 128),
                                       (11008, 4096, 128),
                                       (4096, 11008, 128)])
@pytest.mark.parametrize("m", [4, 512])
def test_launch_plan_takes_the_tensor_cores_at_the_timed_shapes(m, n, k,
                                                               group):
    """smollm-135m's and llama1_7b's linears at decode and prefill run the
    new instance; off 16-byte bases they run ``w4a8_dot``; K is split
    exactly where the tiles leave SMs idle (fewer decode tiles than SMs,
    prefill tiles for at most a quarter of them), into ranks of two groups
    or more whose clusters all run in one wave of GPCS GPCs."""
    plan = launch_plan(m, n, k, group, ALIGNED, ALIGNED)
    assert plan.kernel == "w4a8_wgmma"
    assert plan.bt == (8 if m == 4 else 128)
    tiles = plan.grid[0] * plan.grid[1]
    assert (plan.split > 1) == (tiles < (SMS if m == 4 else SMS // 4))
    resident = SMEM_PER_SM // (plan.smem + SMEM_RESERVED)
    if plan.split > 1:
        assert 2 * plan.split <= k // group
        assert GPCS * (GPC_SMS * resident // plan.split) >= tiles
        if plan.split < min(MAX_SPLIT, k // group // 2):   # the most that fit
            assert GPCS * (GPC_SMS * resident // (plan.split + 1)) < tiles
    assert launch_plan(m, n, k, group, ALIGNED + 1,
                       ALIGNED).kernel == "w4a8_dot"


def _walk(plan, k, group):
    """The kernel's index arithmetic in Python, per rank: the K offsets
    the producer's TMA boxes load (stage by stage) and those each group's
    wgmmas read (``issue``: stage q // gps, k-step (q % gps) * KPG + j,
    box step >> 2, 32 * (step & 3) bytes into it)."""
    kpg = group // KSTEP
    gps = 4 * plan.kb // kpg
    for lo, hi in plan.ranges:
        k_lo, k_hi = lo * group, hi * group
        n_st = -(-(k_hi - k_lo) // (plan.kb * BOX_K))
        loaded = []
        for i in range(n_st):
            k0 = k_lo + i * plan.kb * BOX_K
            nb = min(plan.kb, -(-(k_hi - k0) // BOX_K))
            loaded.append([k0 + j * BOX_K for j in range(nb)])
        read = []
        for q in range(hi - lo):
            i, u = divmod(q, gps)
            steps = []
            for j in range(kpg):
                step = u * kpg + j
                box = step >> 2
                assert box < len(loaded[i])        # a box the stage loaded
                steps.append(loaded[i][box] + KSTEP * (step & 3))
            read.append(steps)
        yield lo, hi, loaded, read


@pytest.mark.parametrize("k,group", KGS)
@pytest.mark.parametrize("m", [4, 64, 512])
def test_kernel_walk_reads_each_group_once(m, k, group):
    """Each group's wgmmas read exactly its own K range, 32 bytes a step
    in order, from boxes its stage loaded; the boxes of a rank start at
    its first group and cover its range; every stage holds whole groups."""
    for split in sorted({1, min(MAX_SPLIT, k // group),
                         launch_plan(m, 576, k, group).split}):
        plan = with_split(launch_plan(m, 576, k, group), split)
        for lo, hi, loaded, read in _walk(plan, k, group):
            assert loaded[0][0] == lo * group
            flat = [b for stage in loaded for b in stage]
            assert flat == list(range(lo * group, hi * group, BOX_K))
            for q, steps in enumerate(read):
                g0 = (lo + q) * group
                assert steps == list(range(g0, g0 + group, KSTEP))


def _exact_and_bound(qx, sx, qw, sg, group, ranges):
    """The function in float64 (exact: the group dots are integers and
    each group term is exact) and the first-order bound of the ordered
    f32 evaluation: u (sum over the products of |term|, over each rank's
    additions of |partial sum|, over the rank sums of |running total|)
    |sx| + u |out|, u = 2^-24, times 1.01 for second-order terms."""
    m, k = qx.shape
    n, groups = qw.shape[0], k // group
    part = np.einsum("mgi,ngi->mgn",
                     qx.reshape(m, groups, group).astype(np.float64),
                     qw.reshape(n, groups, group).astype(np.float64))
    assert np.abs(part).max() <= 2 ** 22          # exact as f32
    terms = part * sg.T.astype(np.float64)[None]   # (m, groups, n)
    err = np.abs(terms).sum(1)
    totals = []
    for lo, hi in ranges:
        run = np.cumsum(terms[:, lo:hi], 1)
        err = err + np.abs(run[:, 1:]).sum(1)
        totals.append(run[:, -1])
    err = err + np.abs(np.cumsum(totals, 0)[1:]).sum(0)
    s = sx.astype(np.float64)
    exact = terms.sum(1) * s
    return exact, 1.01 * 2.0 ** -24 * (err * np.abs(s) + np.abs(exact))


@pytest.mark.parametrize("m,n,k,group", [
    (3, 24, 96, 32), (9, 200, 384, 128), (130, 70, 512, 64),
    (4, 40, 1024, 256), (33, 16, 2048, 32), (8, 576, 1536, 128)])
@pytest.mark.parametrize("split", [1, 2, 3, 5, 8])
def test_ordered_equals_exact_within_its_first_order_bound(m, n, k, group,
                                                         split, rng):
    """``w4a8_gemm_ordered`` at each rank split against the exact function:
    within the first-order bound of its own order of roundings."""
    split = min(split, k // group)
    plan = with_split(launch_plan(m, n, k, group), split)
    args = _inputs(rng, m, n, k, group)
    got = w4a8_gemm_ordered(*(torch.from_numpy(a) for a in args),
                            group=group, plan=plan)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    exact, bound = _exact_and_bound(*args, group, plan.ranges)
    diff = np.abs(got.numpy().astype(np.float64) - exact)
    assert (diff <= bound).all(), float((diff / bound).max())


@pytest.mark.parametrize("m,n,k,group", [
    (3, 24, 96, 32), (9, 200, 384, 128), (130, 70, 512, 64),
    (4, 40, 1024, 256), (17, 136, 256, 128), (8, 16, 256, 64)])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_ordered_matches_reference_ops(m, n, k, group, split, rng):
    """The kernel's order against the reference's ``ops.w4a8_gemm``
    (padding wrapper + Pallas kernel in interpret mode) at ragged M and
    N, groups 32 to 256 and several rank splits: within rtol 2e-3, atol
    1e-2; and the plain version (the reference's order) too."""
    split = min(split, k // group)
    plan = with_split(launch_plan(m, n, k, group), split)
    args = _inputs(rng, m, n, k, group)
    want = np.asarray(ref_ops.w4a8_gemm(*(jnp.asarray(a) for a in args),
                                        group=group))
    pt = [torch.from_numpy(a) for a in args]
    got = w4a8_gemm_ordered(*pt, group=group, plan=plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(w4a8_gemm_plain(*pt, group=group).numpy(),
                               want, rtol=2e-3, atol=1e-2)


def test_ordered_refuses_w4a8_dot_and_short_ranges(rng):
    """``w4a8_dot`` has no stated order; a plan whose ranges stop short of
    the groups is refused."""
    args = [torch.from_numpy(a) for a in _inputs(rng, 4, 24, 192, 6)]
    with pytest.raises(ValueError):
        w4a8_gemm_ordered(*args, group=6, plan=launch_plan(4, 24, 192, 6))
    args = [torch.from_numpy(a) for a in _inputs(rng, 4, 24, 256, 64)]
    plan = with_split(launch_plan(4, 24, 256, 64), 2)
    with pytest.raises(ValueError):
        w4a8_gemm_ordered(*args, group=64,
                          plan=plan._replace(ranges=((0, 1), (1, 3))))
