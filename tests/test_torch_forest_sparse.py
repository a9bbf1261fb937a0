"""Port parity: the ``SparseForestPlan`` of the T >= 16 forest kernel
against the JAX reference ``repro``.

``pack_sparse_forest_plan`` keeps only the nodes a plan makes, renumbered
per tile in level order; its plain version ``sparse_forest_plain`` (what
the kernel wrappers run on CPU tensors) must give the reference's
``run_device`` int32 result exactly on the reference's own plan for the
same weights: T = 16 at 16x32 W4, 24x64 W4 in 2 groups and 8x32 W8. The
packer refuses plans the kernel cannot take; the host picks the tiling
and, from the plan's size alone, the two-pass route for plans whose table
does not fit; ``engine_cuda`` attaches the sparse plan and gives the
reference ``engine_pallas`` (interpret) result. T = 16 plans take ~2 s
each to plan, so the three cases are planned once per module, by the port
and by the reference. Inputs are made with numpy from a seed; every
comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core.backend import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.backend import get_backend as ref_backend  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core.backend import EngineConfig, get_backend  # noqa: E402
from repro_torch.kernels import transitive_forest_sparse as tfs  # noqa: E402
from repro_torch.kernels.transitive_forest import (  # noqa: E402
    transitive_forest, transitive_forest_rows)

pack = pt_engine.pack_sparse_forest_plan

# (N, K, weight bits, groups) at T = 16
CASES = [(16, 32, 4, 1), (24, 64, 4, 2), (8, 32, 8, 1)]


def _case_id(case):
    n, k, bits, g = case
    return f"{n}x{k}-W{bits}-G{g}"


@pytest.fixture(scope="module")
def plans():
    """Per case: the weights, the port's ExecutionPlan and the reference's
    DevicePlan for the same weights, T = 16, planned once."""
    out = {}
    rng = np.random.default_rng(16)
    for n, k, bits, g in CASES:
        lo = 1 << (bits - 1)
        w = rng.integers(-lo, lo, size=(n, k))
        plan = pt_engine.BatchedTransitiveEngine(bits, 16).plan(w, groups=g)
        dref = ref_engine.compile_plan(
            ref_engine.BatchedTransitiveEngine(bits, 16).plan(w, groups=g))
        out[(n, k, bits, g)] = (w, plan, dref)
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sparse_plan_equals_reference_run_device(plans, case):
    """``sparse_forest_plain`` on the packed plan equals the port's
    ``run_device`` on its DevicePlan and the reference's ``run_device`` on
    the reference's own plan, exactly; ungrouped, also the integer GEMM.
    Both kernel entries take the plain version on CPU tensors."""
    n, k, bits, g = case
    w, plan, dref = plans[case]
    d = pt_engine.compile_plan(plan)
    s = pack(d)
    x = np.random.default_rng(k + n).integers(-128, 128, size=(k, 6))
    xt = torch.from_numpy(x)
    got = pt_engine.sparse_forest_plain(s, xt)
    want = np.asarray(ref_engine.run_device(dref, jnp.asarray(x)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pt_engine.run_device(d, xt).numpy(), want)
    if g == 1:
        np.testing.assert_array_equal(want, w.astype(np.int64) @ x)
    np.testing.assert_array_equal(transitive_forest(s, xt).numpy(), want)
    rows = transitive_forest_rows(
        s, torch.from_numpy(x.T.astype(np.int8).copy())).numpy()
    np.testing.assert_array_equal(
        rows, want.T if g == 1 else want.transpose(2, 1, 0))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sparse_plan_numbers_made_nodes_in_level_order(plans, case):
    """Each tile's slots are the nodes its DevicePlan makes (level targets
    and direct nodes), slot 0 the empty sum, in level order: a chained
    slot's prefix lies in an earlier level, a direct slot's node has its
    level's popcount, every gathered slot is made; U is what
    ``sparse_forest_slots`` counts without packing, and the plan is far
    smaller than the DevicePlan."""
    n, k, bits, g = case
    _, plan, _ = plans[case]
    d = pt_engine.compile_plan(plan)
    s = pack(d)
    j = k // 16
    assert s.codes.shape == (j, s.slots) and s.codes.dtype == torch.int32
    assert s.bounds.shape == (j, 17) and s.rows.shape == (j, bits, n)
    assert s.rows.dtype == torch.int16 and s.slots % 4 == 0
    assert s.slots == pt_engine.sparse_forest_slots(d)
    made = pt_engine._made(d)
    bounds = s.bounds.numpy()
    assert (bounds[:, 0] == 1).all()
    np.testing.assert_array_equal(bounds[:, -1], made.sum(1) + 1)
    assert s.slots == -(-(int(made.sum(1).max()) + 1) // 4) * 4
    codes = s.codes.numpy().astype(np.int64) & 0xFFFFFFFF
    for jj in range(j):
        for lv in range(1, 17):
            for u in range(bounds[jj, lv - 1], bounds[jj, lv]):
                c = int(codes[jj, u])
                if c & pt_engine.SPARSE_DIRECT:
                    assert bin(c & 0x7FFFFFFF).count("1") == lv
                else:
                    assert (c & 0xFFFF) < bounds[jj, lv - 1]
                    assert (c >> 16) < 16
    assert (s.rows.numpy() < bounds[:, -1][:, None, None]).all()
    assert s.nbytes() * 1000 < d.nbytes()
    pt_engine.check_sparse_forest_plan(s)


def test_stacked_sparse_plans_index_and_share_u(rng):
    """Stacked plans (one per layer of a stacked weight) pad U to the
    largest entry's; each entry equals its own pack but for that padding,
    and runs like it."""
    ws = [rng.integers(-8, 8, size=(12, 32)), np.zeros((12, 32), np.int64)]
    eplans = [pt_engine.BatchedTransitiveEngine(4, 16).plan(w) for w in ws]
    stacked = get_backend("engine_cuda").compile(eplans)
    assert isinstance(stacked, pt_engine.SparseForestPlan)
    assert stacked.lead == (2,)
    x = torch.from_numpy(rng.integers(-128, 128, size=(32, 3)))
    for i, (w, p) in enumerate(zip(ws, eplans)):
        one = pack(pt_engine.compile_plan(p))
        entry = stacked.index(i)
        assert entry.slots == stacked.slots >= one.slots
        for f in ("bounds", "rows", "signs"):
            assert torch.equal(getattr(entry, f), getattr(one, f)), f
        assert torch.equal(entry.codes[:, :one.slots], one.codes)
        assert not entry.codes[:, one.slots:].any()
        np.testing.assert_array_equal(
            pt_engine.sparse_forest_plain(entry, x).numpy(), w @ x.numpy())
    with pytest.raises(ValueError, match="stacked"):
        pt_engine.sparse_forest_plain(stacked, x)


def _packed(plans, case=CASES[0]):
    return pack(pt_engine.compile_plan(plans[case][1]))


@pytest.mark.parametrize("fault", ["gathers_unmade_node", "not_tile_local",
                                   "prefix_in_later_level",
                                   "rows_past_made_slots", "bit_past_t",
                                   "direct_off_level", "too_many_slots",
                                   "t_past_31"])
def test_sparse_pack_refuses_plans_the_kernel_cannot_take(plans, fault):
    """The packer refuses a DevicePlan that reads a node it never makes or
    is not tile-local, or whose made nodes do not fit int16 slots; its
    check (``check_sparse_forest_plan``) refuses a sparse plan whose slot
    reads a prefix in its own or a later level, an activation bit past T,
    a direct node off its level, a gather of a slot never made, or T past
    31."""
    n, k, bits, g = CASES[0]
    d = pt_engine.compile_plan(plans[CASES[0]][1])
    s = pack(d)
    check = pt_engine.check_sparse_forest_plan
    codes = s.codes.numpy().astype(np.int64) & 0xFFFFFFFF
    bounds = s.bounds.numpy()
    lv, jj = next((lv, jj) for lv in range(2, 17) for jj in range(k // 16)
                  if bounds[jj, lv] > bounds[jj, lv - 1])
    first = int(bounds[jj, lv - 1])            # the first slot of level lv

    def with_code(u, code):
        c = s.codes.clone()
        c[jj, u] = int(np.int64(code).astype(np.uint32).view(np.int32))
        return dataclasses.replace(s, codes=c)

    if fault == "gathers_unmade_node":
        made = pt_engine._made(d)[0]
        node = int(np.nonzero(~made)[0][1])
        gather = d.gather_idx.clone()
        gather[0, 0, 0] = node
        with pytest.raises(ValueError, match="never makes"):
            pack(dataclasses.replace(d, gather_idx=gather))
    elif fault == "not_tile_local":
        with pytest.raises(ValueError, match="tile-local"):
            pack(dataclasses.replace(d, tile_local=False))
    elif fault == "prefix_in_later_level":
        with pytest.raises(ValueError, match="earlier level"):
            check(with_code(first, first))     # its own slot, its level
        with pytest.raises(ValueError, match="earlier level"):
            check(with_code(first, int(bounds[jj, -1]) - 1))
    elif fault == "rows_past_made_slots":
        rows = s.rows.clone()
        rows[jj, 0, 0] = int(bounds[jj, -1])
        with pytest.raises(ValueError, match="never makes"):
            check(dataclasses.replace(s, rows=rows))
    elif fault == "bit_past_t":
        with pytest.raises(ValueError, match="bit >= T"):
            check(with_code(first, 16 << 16))
    elif fault == "direct_off_level":
        with pytest.raises(ValueError, match="its own level"):
            check(with_code(first, pt_engine.SPARSE_DIRECT | 1))
    elif fault == "too_many_slots":
        crowded = pt_engine.compile_plan(
            pt_engine.complete_forest_plan(16, 32768, 4))
        with pytest.raises(ValueError, match="fit int16"):
            pack(crowded)
    else:
        with pytest.raises(ValueError, match="T <= 31"):
            check(dataclasses.replace(s, t=32))


@pytest.mark.parametrize("fault", ["codes_uint8", "bounds_int64",
                                   "rows_int32", "rows_strided",
                                   "signs_int64", "two_devices",
                                   "codes_width"])
def test_sparse_plan_refuses_leaves_the_kernel_cannot_read(plans, fault):
    """The kernel reads the leaves through raw pointers and stages a
    tile's codes 16 bytes at a time: a SparseForestPlan whose leaves are
    not contiguous int32 / int32 / int16 / int32 on one device, or whose
    codes' width is not a multiple of 4, is refused when it is made."""
    s = _packed(plans)
    bad = {"codes_uint8": {"codes": s.codes.to(torch.uint8)},
           "bounds_int64": {"bounds": s.bounds.to(torch.int64)},
           "rows_int32": {"rows": s.rows.to(torch.int32)},
           "rows_strided": {"rows": s.rows.transpose(0, 2)},
           "signs_int64": {"signs": s.signs.to(torch.int64)},
           "two_devices": {"signs": s.signs.to("meta")},
           "codes_width": {"codes": s.codes[:, :-1].contiguous()}}[fault]
    with pytest.raises(ValueError, match="SparseForestPlan"):
        dataclasses.replace(s, **bad)


@pytest.mark.parametrize("m,k,want", [
    # the chip_smoke.py shape (1536 x 64, U = 8,720 at most): one round,
    # 4 columns of a 136 KiB table, 512 outputs a block
    (4, 64, (4, 1, 512, 4)), (64, 64, (4, 1, 512, 4)),
    # smollm-135m's K = 576: 36 tiles over 16 ranks, two plan buffers
    (4, 576, (4, 2, 512, 16))])
def test_sparse_tiling_fits_at_the_chip_smoke_shape(m, k, want):
    """``sparse_tiling`` at T = 16, N = 1536, W4 with the largest U the
    port's planner made at 1536 x 64 (8,715 slots a tile, rounded up):
    it fits a block's 227 KiB as the kernel carves it up, and so does
    every tiling it can return; ``sparse_fits`` holds up to ~29,000
    slots (one column and its codes) and never past int16."""
    u = 8720
    tl = tfs.sparse_tiling(16, 4, u, 1536, m, k // 16)
    assert (tl.bm, tl.nbuf, tl.bn, tl.cluster) == want
    assert tl.smem == tfs.sparse_smem(16, 4, u, tl.bm, tl.nbuf, tl.bn)
    assert tl.smem <= tfs._SMEM_LIMIT
    assert tfs.sparse_smem(16, 4, u, 2 * tl.bm, 1, 64) > tfs._SMEM_LIMIT
    assert tfs.sparse_fits(16, 4, 26336) and not tfs.sparse_fits(16, 4,
                                                                 30004)
    assert not tfs.sparse_fits(16, 1, 32772)
    with pytest.raises(ValueError, match="two-pass"):
        tfs.sparse_tiling(16, 4, 30004, 1536, 4, 4)


@pytest.mark.parametrize("count,route", [(100, "sparse"),
                                         (30000, "two-pass"),
                                         (39202, "two-pass")])
def test_route_is_picked_from_the_plans_size(count, route):
    """A T = 16 plan runs as a SparseForestPlan where one column of its
    table fits shared memory, else as its DevicePlan through the two-pass
    kernel (``run_device`` here): picked from the made nodes alone
    (30,000: packs but does not fit; 39,202, every node up to popcount 8:
    does not fit int16), by the forest entries (a DevicePlan packed at
    its first call or never) and by ``engine_cuda``'s compile alike; the
    result is the same."""
    eplan = pt_engine.complete_forest_plan(16, count, 24, seed=count)
    d = pt_engine.compile_plan(eplan)
    x = torch.from_numpy(np.random.default_rng(count).integers(
        -128, 128, size=(16, 5)))
    calls = pack.calls
    got = transitive_forest(d, x)
    rows = transitive_forest_rows(d, x.T.to(torch.int8).contiguous())
    assert pack.calls == calls + (route == "sparse")
    want = pt_engine.run_device(d, x)
    assert torch.equal(got, want) and torch.equal(rows.T, want)
    compiled = get_backend("engine_cuda").compile(eplan)
    assert isinstance(compiled, pt_engine.SparseForestPlan
                      if route == "sparse" else pt_engine.DevicePlan)
    assert torch.equal(transitive_forest(compiled, x), want)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_engine_cuda_t16_equals_reference_engine_pallas(plans, case):
    """``engine_cuda`` at T = 16 attaches a SparseForestPlan, executed by
    the kernel's row entry on int8 codes (its plain version on CPU), and
    its int32 accumulators equal the reference's ``engine_pallas``
    (interpret) on the reference's plan for the same weights."""
    n, k, bits, g = case
    w, plan, dref = plans[case]
    backend = get_backend("engine_cuda")
    splan = backend.compile(plan)
    assert isinstance(splan, pt_engine.SparseForestPlan) and splan.t == 16
    rng = np.random.default_rng(n * k)
    qx = rng.integers(-128, 128, size=(2, 3, k)).astype(np.int8)
    qw = w.astype(np.int8)
    kg = k // g
    xs = qx if g == 1 else qx.reshape(2, 3, g, kg)
    ws = qw if g == 1 else qw.reshape(n, g, kg)
    calls = pack.calls
    got = backend.execute(torch.from_numpy(xs), torch.from_numpy(ws), None,
                          splan, EngineConfig(bits, 16, g))
    assert pack.calls == calls
    want = ref_backend("engine_pallas").execute(
        jnp.asarray(xs), jnp.asarray(ws), None, dref,
        RefEngineConfig(bits, 16, g))
    assert got.dtype == torch.int32 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
