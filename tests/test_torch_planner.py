"""Port parity: the host planner and the device plans of ``repro_torch``
against the JAX reference ``repro``.

Every ``ExecutionPlan`` field and every ``DevicePlan`` leaf the port
builds is ``array_equal`` to the reference's, over random and adversarial
int4/int8 weights, single, padded and stacked; the port's ``run_device``
(the plain version of the CUDA forest kernel) equals the reference's
``run_device`` and the int64 GEMM, ungrouped and grouped. Reference plans
are built with its engine directly (no plan cache, so nothing here routes
through ``repro.analysis``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.core.backend import EngineConfig  # noqa: E402

PATTERNS = ["random", "zeros", "ones", "neg_ones", "single_row",
            "outlier_heavy"]


def _weights(pattern: str, n: int, k: int, bits: int, rng) -> np.ndarray:
    """The reference tests' adversarial weight patterns (test_engine.py)."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if pattern == "random":
        return rng.integers(lo, hi + 1, size=(n, k))
    if pattern == "zeros":
        return np.zeros((n, k), dtype=np.int64)
    if pattern == "ones":
        return np.ones((n, k), dtype=np.int64)
    if pattern == "neg_ones":
        return np.full((n, k), -1, dtype=np.int64)
    if pattern == "single_row":
        w = np.zeros((n, k), dtype=np.int64)
        w[0] = rng.integers(lo, hi + 1, size=k)
        return w
    if pattern == "outlier_heavy":
        return np.where(rng.random((n, k)) < 0.9, hi, lo)
    raise AssertionError(pattern)


def _shape(pattern, t):
    return (3, 4 * t, 5) if pattern == "outlier_heavy" else (11, 6 * t, 7)


def _assert_plans_equal(pt, ref):
    for f in ("t", "bits", "n", "k", "groups"):
        assert getattr(pt, f) == getattr(ref, f), f
    for f in ("rows", "direct_tile", "direct_node", "direct_bits", "signs"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(ref, f),
                                      err_msg=f)
    for f in ("counts", "exec_counts", "bridge", "distance", "prefix",
              "lane", "outlier", "wl_ppe", "wl_ape"):
        np.testing.assert_array_equal(getattr(pt.si, f), getattr(ref.si, f),
                                      err_msg=f"si.{f}")
    assert (pt.si.t, pt.si.n_rows) == (ref.si.t, ref.si.n_rows)
    assert len(pt.steps) == len(ref.steps)
    for a, b in zip(pt.steps, ref.steps):
        for f in ("tile", "node", "prefix", "bit"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _assert_dplans_equal(pt, ref):
    for f in ("t", "bits", "n", "k", "groups"):
        assert getattr(pt, f) == getattr(ref, f), f
    for f in ref_engine.DEVICE_DATA_FIELDS:
        a, b = getattr(pt, f), np.asarray(getattr(ref, f))
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_execution_plan_equals_reference(bits, t, pattern, rng):
    n, k, m = _shape(pattern, t)
    w = _weights(pattern, n, k, bits, rng)
    pt = pt_engine.BatchedTransitiveEngine(bits, t).plan(w)
    ref = ref_engine.BatchedTransitiveEngine(bits, t).plan(w)
    _assert_plans_equal(pt, ref)
    x = rng.integers(-128, 128, size=(k, m))
    want = w.astype(np.int64) @ x.astype(np.int64)
    np.testing.assert_array_equal(
        pt_engine.BatchedTransitiveEngine(bits, t).run(pt, x), want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_device_plan_equals_reference(bits, t, pattern, rng):
    n, k, m = _shape(pattern, t)
    w = _weights(pattern, n, k, bits, rng)
    plan_r = ref_engine.BatchedTransitiveEngine(bits, t).plan(w)
    plan_p = pt_engine.BatchedTransitiveEngine(bits, t).plan(w)
    dref = ref_engine.compile_plan(plan_r)
    dpt = pt_engine.compile_plan(plan_p)
    _assert_dplans_equal(dpt, dref)
    assert dpt.tile_local
    x = rng.integers(-128, 128, size=(k, m))
    want = w.astype(np.int64) @ x.astype(np.int64)
    got = pt_engine.run_device(dpt, torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = ref_engine.run_device_jit(dref, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_groups", [2, 4])
def test_grouped_device_plan_equals_reference(n_groups, rng):
    n, g, m = 6, 16, 5
    w = rng.integers(-8, 8, size=(n, n_groups * g))
    x = rng.integers(-128, 128, size=(n_groups * g, m))
    dref = ref_engine.compile_plan(
        ref_engine.BatchedTransitiveEngine(4, 8).plan(w, groups=n_groups))
    dpt = pt_engine.compile_plan(
        pt_engine.BatchedTransitiveEngine(4, 8).plan(w, groups=n_groups))
    _assert_dplans_equal(dpt, dref)
    want = np.einsum("ngi,gim->ngm",
                     w.reshape(n, n_groups, g).astype(np.int64),
                     x.reshape(n_groups, g, m).astype(np.int64))
    got = pt_engine.run_device(dpt, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(ref_engine.run_device_jit(dref, jnp.asarray(x))))
    from repro_torch.kernels.transitive_forest import transitive_forest
    np.testing.assert_array_equal(
        transitive_forest(dpt, torch.from_numpy(x)).numpy(), want)


def test_stacked_and_padded_plans_equal_reference(rng):
    """compile_plans pads to the widest direct axis and stacks; pad lanes
    are no-ops. Both equal the reference leaf for leaf."""
    ws = [_weights(p, 3, 32, 8, rng)
          for p in ("outlier_heavy", "random", "zeros")]
    ref_plans = [ref_engine.BatchedTransitiveEngine(8, 8).plan(w)
                 for w in ws]
    pt_plans = [pt_engine.BatchedTransitiveEngine(8, 8).plan(w) for w in ws]
    dref = ref_engine.compile_plans(ref_plans)
    dpt = pt_engine.compile_plans(pt_plans)
    assert dpt.lead == (3,) and dpt.tile_local
    _assert_dplans_equal(dpt, dref)
    width = int(dpt.direct_idx.shape[-1]) + 5
    _assert_dplans_equal(pt_engine.pad_device_plan(dpt, width),
                         ref_engine.pad_device_plan(dref, width))
    x = rng.integers(-128, 128, size=(32, 4))
    for i, w in enumerate(ws):
        padded = pt_engine.pad_device_plan(dpt.index(i), width)
        np.testing.assert_array_equal(
            pt_engine.run_device(padded, torch.from_numpy(x)).numpy(),
            w.astype(np.int64) @ x)
    with pytest.raises(ValueError, match="signatures"):
        other = pt_engine.BatchedTransitiveEngine(4, 8).plan(
            rng.integers(-8, 8, size=(3, 32)))
        pt_engine.compile_plans([pt_plans[0], other])


def test_tile_locality_check_rejects_cross_tile_edges(rng):
    """The CUDA kernel's precondition: a level edge that leaves its tile,
    an unsorted direct axis or an out-of-range gather is refused."""
    w = _weights("random", 5, 32, 4, rng)
    d = pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 8)
                               .plan(w))
    leaves = {f: a.numpy().copy() for f, a in d.leaves().items()}

    def local(**over):
        lv = {**leaves, **over}
        return pt_engine.check_tile_local(
            d.t, d.k, lv["level_src"], lv["level_xsrc"], lv["direct_idx"],
            lv["direct_x_idx"], lv["gather_idx"])
    assert local()
    src = leaves["level_src"].copy()
    src[0, 0] = 256                               # row 0 of tile 0 -> tile 1
    assert not local(level_src=src)
    xsrc = leaves["level_xsrc"].copy()
    xsrc[1, 300] = 0                              # tile 1 row reads tile 0
    assert not local(level_xsrc=xsrc)
    g = leaves["gather_idx"].copy()
    g[0, 0, 0] = 4 * 256
    assert not local(gather_idx=g)
    didx = np.array([300, 10, 4 * 256], np.int32)  # unsorted
    dx = np.zeros((3, 8), np.int32)
    assert not local(direct_idx=didx, direct_x_idx=dx)


@pytest.mark.parametrize("backend", ["engine_torch", "engine_cuda"])
def test_attach_device_plans_stacked_equals_reference(backend, rng):
    """Stacked block weights: the port's attached plans equal the
    reference's compile_plans over the same slices (``engine_cuda``
    attaches their compact packing, a ForestPlan), and the plan cache
    builds each distinct weight once."""
    from repro_torch.core import plancache
    from repro_torch.quant import QuantConfig
    qw = rng.integers(-8, 8, size=(3, 24, 64)).astype(np.int8)
    params = {"blocks": {"w": {"qw": torch.from_numpy(qw),
                               "sg": torch.ones((3, 24, 1))}}}
    cfg = QuantConfig(mode="ptq", w_bits=4, group=0, backend=backend)
    cache = plancache.PlanCache(capacity=2)
    stats = plancache.precompile(params, cfg, cache)
    assert stats == {"layers": 1, "plans": 3, "built": 3}
    out = plancache.attach_device_plans(params, cfg, cache)
    assert cache.stats()["misses"] == 3 and cache.stats()["hits"] == 3
    assert cache.stats()["backends"][backend] == {"hits": 3, "misses": 3}
    dref = ref_engine.compile_plans(
        [ref_engine.BatchedTransitiveEngine(4, 8).plan(qw[i].astype(np.int64))
         for i in range(3)])
    attached = out["blocks"]["w"]["dplan"]
    if backend == "engine_cuda":
        from repro_torch.convert import params_from_reference
        want = pt_engine.pack_forest_plan(params_from_reference(dref))
        assert isinstance(attached, pt_engine.ForestPlan)
        assert attached.lead == (3,)
        for f in pt_engine.FOREST_DATA_FIELDS:
            np.testing.assert_array_equal(getattr(attached, f).numpy(),
                                          getattr(want, f).numpy())
    else:
        _assert_dplans_equal(attached, dref)
    assert out["blocks"]["w"]["qw"] is params["blocks"]["w"]["qw"]
    b = get_backend(backend)
    x = rng.integers(-128, 128, size=(7, 64)).astype(np.int8)
    got = b.execute(torch.from_numpy(x), torch.from_numpy(qw[1]), None,
                    attached.index(1), EngineConfig(4, 8))
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ qw[1].T.astype(np.int64))


def test_run_device_rejects_bad_shapes(rng):
    d = pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 8).plan(
        rng.integers(-8, 8, size=(4, 16))))
    with pytest.raises(ValueError, match="K=16"):
        pt_engine.run_device(d, torch.zeros((8, 2), dtype=torch.int32))
    stacked = pt_engine.compile_plans(
        [pt_engine.BatchedTransitiveEngine(4, 8).plan(
            rng.integers(-8, 8, size=(4, 16))) for _ in range(2)])
    with pytest.raises(ValueError, match="stacked"):
        pt_engine.run_device(stacked, torch.zeros((16, 2),
                                                  dtype=torch.int32))
