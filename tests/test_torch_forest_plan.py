"""Port parity: the compact ``ForestPlan`` of the CUDA forest kernel
against the JAX reference ``repro``.

``pack_forest_plan`` repacks the port's ``DevicePlan`` into one byte per
node and per APE gather; its plain version ``forest_plan_plain`` (what the
kernel wrappers run on CPU tensors) must give the reference's
``run_device`` int32 result exactly on the reference's own plan for the
same weights, over the planner tests' weight patterns, T in {4, 8} (uint8
gathers) and {9, 12, 15} (int16 gathers), 4- and 8-bit weights and 1 or 3
groups. Stacked ForestPlans slice per layer like
DevicePlans; plans the kernel cannot take are refused; ``engine_cuda``
serving from attached ForestPlans gives the reference ``engine_pallas``
result and packs nothing while it serves. Reference plans are built with
its engine directly (no plan cache, so nothing here routes through
``repro.analysis``). Inputs are made with numpy from a seed; every
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
from repro.quant import QuantConfig as RefQuantConfig  # noqa: E402
from repro.quant import linear_apply as ref_linear_apply  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import engine as pt_engine  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.core.backend import EngineConfig, get_backend  # noqa: E402
from repro_torch.kernels.transitive_forest import (  # noqa: E402
    transitive_forest, transitive_forest_rows)
from repro_torch.quant import QuantConfig, linear_apply  # noqa: E402

from test_torch_planner import PATTERNS, _weights  # noqa: E402

pack = pt_engine.pack_forest_plan


def _assert_fplans_equal(a, b):
    for f in ("t", "bits", "n", "k", "groups"):
        assert getattr(a, f) == getattr(b, f), f
    for f in pt_engine.FOREST_DATA_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.is_contiguous(), f
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t", [4, 8, 9, 12, 15])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_forest_plan_equals_reference_run_device(pattern, t, bits, groups,
                                                 rng):
    n, m = (3, 5) if pattern == "outlier_heavy" else (11, 7)
    k = 6 * t                                  # 6 tiles: 1 or 3 groups
    w = _weights(pattern, n, k, bits, rng)
    x = rng.integers(-128, 128, size=(k, m))
    plan = pt_engine.BatchedTransitiveEngine(bits, t).plan(w, groups=groups)
    fplan = pack(pt_engine.compile_plan(plan))
    assert fplan.producer.shape == (6, 1 << t)
    assert fplan.rows.shape == (6, bits, n) and fplan.lead == ()
    assert fplan.producer.dtype == torch.uint8
    # a gathered node fits a byte up to T = 8, int16 up to T = 15
    assert fplan.rows.dtype == (torch.uint8 if t <= 8 else torch.int16)
    got = pt_engine.forest_plan_plain(fplan, torch.from_numpy(x))
    assert got.dtype == torch.int32
    dref = ref_engine.compile_plan(
        ref_engine.BatchedTransitiveEngine(bits, t).plan(w, groups=groups))
    want = np.asarray(ref_engine.run_device(dref, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    if groups == 1:
        np.testing.assert_array_equal(want, w.astype(np.int64) @ x)
    # both kernel entries take the plain version on CPU tensors
    np.testing.assert_array_equal(
        transitive_forest(fplan, torch.from_numpy(x)).numpy(), want)
    rows = transitive_forest_rows(
        fplan, torch.from_numpy(x.T.astype(np.int8).copy())).numpy()
    np.testing.assert_array_equal(
        rows, want.T if groups == 1 else want.transpose(2, 1, 0))


def test_forest_plan_codes_cover_direct_and_unused_nodes(rng):
    """The outlier-heavy plan has direct nodes, a zero weight only unused
    ones; the codes say so, and node 0 is never made."""
    t = 8
    heavy = pack(pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(
        4, t).plan(_weights("outlier_heavy", 3, 4 * t, 4, rng))))
    prod = heavy.producer.numpy()
    assert (prod == pt_engine.FOREST_DIRECT).any()
    assert (prod == pt_engine.FOREST_UNUSED).any()
    assert set(np.unique(prod)) <= set(range(t)) | {
        pt_engine.FOREST_DIRECT, pt_engine.FOREST_UNUSED}
    assert (prod[:, 0] == pt_engine.FOREST_UNUSED).all()
    zeros = pack(pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(
        4, t).plan(np.zeros((5, 2 * t), np.int64))))
    assert (zeros.producer == pt_engine.FOREST_UNUSED).all()
    assert (zeros.rows == 0).all()


def test_stacked_forest_plans_index_like_device_plans(rng):
    ws = [_weights(p, 3, 32, 8, rng)
          for p in ("outlier_heavy", "random", "zeros")]
    dplan = pt_engine.compile_plans(
        [pt_engine.BatchedTransitiveEngine(8, 8).plan(w) for w in ws])
    calls = pack.calls
    fplan = pack(dplan)
    assert pack.calls == calls + 1
    assert fplan.lead == dplan.lead == (3,)
    assert fplan.nbytes() == sum(pack(dplan.index(i)).nbytes()
                                 for i in range(3))
    x = torch.from_numpy(rng.integers(-128, 128, size=(32, 4)))
    for i, w in enumerate(ws):
        one = fplan.index(i)
        _assert_fplans_equal(one, pack(dplan.index(i)))
        np.testing.assert_array_equal(
            pt_engine.forest_plan_plain(one, x).numpy(),
            pt_engine.run_device(dplan.index(i), x).numpy())
        np.testing.assert_array_equal(
            pt_engine.forest_plan_plain(one, x).numpy(), w @ x.numpy())
    with pytest.raises(ValueError, match="stacked"):
        pt_engine.forest_plan_plain(fplan, x)


def test_pack_refuses_plans_the_kernel_cannot_take(rng):
    w = _weights("random", 5, 32, 4, rng)
    d = pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 8)
                               .plan(w))
    with pytest.raises(ValueError, match="tile-local"):
        pack(dataclasses.replace(d, tile_local=False))
    wide = pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 16)
                                  .plan(rng.integers(-8, 8, size=(3, 32))))
    assert wide.tile_local
    with pytest.raises(ValueError, match="int16: T <= 15"):
        pack(wide)
    # the dtype of rows follows T: uint8 to T = 8, int16 from T = 9
    w9 = pack(pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 9)
                                     .plan(rng.integers(-8, 8, size=(3, 18)))))
    assert w9.rows.dtype == torch.int16
    with pytest.raises(ValueError, match="rows must be contiguous "
                                         "torch.int16"):
        dataclasses.replace(w9, rows=w9.rows.to(torch.uint8))
    with pytest.raises(ValueError, match="rows must be contiguous "
                                         "torch.uint8"):
        dataclasses.replace(pack(d), rows=pack(d).rows.to(torch.int16))
    # an edge whose activation bit is not the one the node adds
    src = d.level_xsrc.clone()
    r = int(torch.nonzero(src[1] != d.k)[0, 0])
    src[1, r] = (r // 256) * 8 + (int(src[1, r]) + 1) % 8
    with pytest.raises(ValueError, match="one bit"):
        pack(dataclasses.replace(d, level_xsrc=src))
    heavy = pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 8)
                                   .plan(_weights("outlier_heavy", 3, 32, 4,
                                                  rng)))
    bits = heavy.direct_bits.clone()
    bits[0] = 1 - bits[0]
    with pytest.raises(ValueError, match="direct_bits"):
        pack(dataclasses.replace(heavy, direct_bits=bits))
    # an APE gather of a node the plan never makes (the kernel leaves
    # unused nodes unwritten)
    unused = torch.nonzero(pack(d).producer[0] == pt_engine.FOREST_UNUSED)
    node = int(unused[unused > 0][0])
    gather = d.gather_idx.clone()
    gather[0, 0, 0] = node
    with pytest.raises(ValueError, match="never makes"):
        pack(dataclasses.replace(d, gather_idx=gather))


@pytest.mark.parametrize("groups", [1, 4])
def test_engine_cuda_forest_plan_equals_reference_engine_pallas(groups,
                                                                rng):
    """The ``test_torch_quant`` accumulator case, with the plan attached as
    ``engine_cuda`` attaches it: a ForestPlan, executed by the kernel's
    row entry (its plain version on CPU), no packing per call."""
    n, k = 24, 128
    qw = rng.integers(-8, 8, size=(n, k)).astype(np.int8)
    qx = rng.integers(-128, 128, size=(2, 3, k)).astype(np.int8)
    backend = get_backend("engine_cuda")
    fplan = backend.compile(pt_engine.BatchedTransitiveEngine(4, 8).plan(
        qw.astype(np.int64), groups=groups))
    assert isinstance(fplan, pt_engine.ForestPlan)
    dref = ref_engine.compile_plan(ref_engine.BatchedTransitiveEngine(
        4, 8).plan(qw.astype(np.int64), groups=groups))
    _assert_fplans_equal(fplan, pack(params_from_reference(dref)))
    g = k // groups
    xs = qx if groups == 1 else qx.reshape(2, 3, groups, g)
    ws = qw if groups == 1 else qw.reshape(n, groups, g)
    calls = pack.calls
    got = backend.execute(torch.from_numpy(xs), torch.from_numpy(ws), None,
                          fplan, EngineConfig(4, 8, groups))
    assert pack.calls == calls
    want = ref_backend("engine_pallas").execute(
        jnp.asarray(xs), jnp.asarray(ws), None, dref,
        RefEngineConfig(4, 8, groups))
    assert got.dtype == torch.int32 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group", [0, 32])
def test_linear_apply_from_attached_forest_plans(group, rng):
    """Stacked PTQ weights with ForestPlans attached by the plan cache:
    every slice's ``linear_apply`` equals the reference's ``engine_pallas``
    output (per-channel to 1 ulp, grouped within the tolerance of
    ``test_torch_quant``), and nothing is packed while applying."""
    n, k, lead = 20, 128, 2
    qw = rng.integers(-8, 8, size=(lead, n, k)).astype(np.int8)
    g = k if group == 0 else group
    sg = (rng.random((lead, n, k // g)) * 0.1 + 0.01).astype(np.float32)
    cfg = QuantConfig(mode="ptq", w_bits=4, group=group,
                      backend="engine_cuda")
    params = {"w": {"qw": torch.from_numpy(qw), "sg": torch.from_numpy(sg)}}
    out = plancache.attach_device_plans(params, cfg, plancache.PlanCache())
    fplan = out["w"]["dplan"]
    assert isinstance(fplan, pt_engine.ForestPlan) and fplan.lead == (lead,)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    ref_cfg = RefQuantConfig(mode="ptq", w_bits=4, group=group,
                             backend="engine_pallas")
    calls = pack.calls
    for i in range(lead):
        got = linear_apply({"qw": torch.from_numpy(qw[i]),
                            "sg": torch.from_numpy(sg[i]),
                            "dplan": fplan.index(i)},
                           torch.from_numpy(x), cfg)
        dref = ref_engine.compile_plan(ref_engine.BatchedTransitiveEngine(
            4, 8).plan(qw[i].astype(np.int64), groups=k // g))
        want = np.asarray(ref_linear_apply(
            {"qw": jnp.asarray(qw[i]), "sg": jnp.asarray(sg[i]),
             "dplan": dref}, jnp.asarray(x), ref_cfg))
        if group == 0:
            np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    assert pack.calls == calls


@pytest.mark.parametrize("fault", ["producer_int32", "rows_strided",
                                   "signs_int64", "two_devices"])
def test_forest_plan_refuses_leaves_the_kernel_cannot_read(fault, rng):
    """The kernel reads the leaves through raw pointers: a ForestPlan
    whose leaves are not contiguous uint8 / uint8 / int32 on one device is
    refused when it is made (also through ``dataclasses.replace``)."""
    fplan = pack(pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(
        4, 8).plan(_weights("random", 6, 32, 4, rng))))
    bad = {"producer_int32": {"producer": fplan.producer.to(torch.int32)},
           "rows_strided": {"rows": fplan.rows.transpose(0, 2)},
           "signs_int64": {"signs": fplan.signs.to(torch.int64)},
           "two_devices": {"signs": fplan.signs.to("meta")}}[fault]
    with pytest.raises(ValueError, match="ForestPlan"):
        dataclasses.replace(fplan, **bad)


def test_dense_plan_is_packed_once(rng):
    """A DevicePlan handed to the kernel entries (the route of
    ``kernels.ops``) or to ``engine_cuda`` is packed at its first call and
    the packing kept: later calls pack nothing and give the same exact
    result as the reference's ``run_device``."""
    n, k = 10, 64
    w = _weights("random", n, k, 4, rng)
    x = rng.integers(-128, 128, size=(k, 3))
    dplan = pt_engine.compile_plan(pt_engine.BatchedTransitiveEngine(4, 8)
                                   .plan(w))
    want = np.asarray(ref_engine.run_device(
        ref_engine.compile_plan(ref_engine.BatchedTransitiveEngine(4, 8)
                                .plan(w)), jnp.asarray(x)))
    calls = pack.calls
    first = transitive_forest(dplan, torch.from_numpy(x))
    assert pack.calls == calls + 1
    again = transitive_forest(dplan, torch.from_numpy(x))
    rows = transitive_forest_rows(
        dplan, torch.from_numpy(x.T.astype(np.int8).copy()))
    backend = get_backend("engine_cuda").execute(
        torch.from_numpy(x.T.astype(np.int8).copy()), torch.from_numpy(w),
        None, dplan, EngineConfig(4, 8, 1))
    assert pack.calls == calls + 1
    for got in (first, again, rows.T, backend.T):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t", [9, 10])
def test_engine_cuda_runs_plans_wider_than_a_byte(t, rng):
    """T > 8 on ``engine_cuda``: a reduced smollm whose linears' K are
    multiples of 9 and 10 (d_model 180, 3 heads of 30, d_ff 360) with
    ``transrow_t=t``. The attached plans are ForestPlans with int16
    gathers (a byte cannot hold the node), each layer packed once while
    attaching and nothing packed while executing; every linear's int32
    accumulators through the backend equal the reference's
    ``engine_pallas`` (interpret) on its own plan for the same weights,
    exactly; the model's prefill logits equal the port's ``int_dot``."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model, _index
    base = get_reduced("smollm_135m").replace(
        n_layers=1, d_model=180, n_heads=3, n_kv_heads=1, head_dim=30,
        d_ff=360, dtype=torch.float32)
    cfg = serve_config(base, backend="engine_cuda")
    cfg = cfg.replace(quant=cfg.quant.with_(transrow_t=t))
    model = Model(cfg, device="cpu")
    raw = model.init(0)
    calls = pack.calls
    params = plancache.attach_device_plans(raw, cfg.quant,
                                           plancache.PlanCache())
    block = _index(params["blocks"], 0)
    layers = {f"{b}.{n}": layer for b, blk in block.items()
              for n, layer in blk.items()
              if isinstance(layer, dict) and "qw" in layer}
    assert len(layers) == 7
    assert pack.calls == calls + len(layers)         # once per layer
    calls = pack.calls
    backend = get_backend("engine_cuda")
    for name, layer in layers.items():
        fplan = layer["dplan"]
        assert isinstance(fplan, pt_engine.ForestPlan) and fplan.t == t
        assert fplan.rows.dtype == torch.int16
        qw = layer["qw"].numpy()
        qx = rng.integers(-128, 128, size=(3, qw.shape[1])).astype(np.int8)
        got = backend.execute(torch.from_numpy(qx), layer["qw"], None,
                              fplan, EngineConfig(4, t, 1))
        dref = ref_engine.compile_plan(ref_engine.BatchedTransitiveEngine(
            4, t).plan(qw.astype(np.int64)))
        want = ref_backend("engine_pallas").execute(
            jnp.asarray(qx), jnp.asarray(qw), None, dref,
            RefEngineConfig(4, t, 1))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 5)))
    logits, _ = model.prefill(params, {"tokens": toks}, 8)
    assert pack.calls == calls
    dense = Model(cfg.replace(quant=cfg.quant.with_(backend="int_dot")),
                  device="cpu")
    want_logits, _ = dense.prefill(raw, {"tokens": toks}, 8)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)


def test_dense_forest_kernel_states_its_shared_memory_bound():
    """The dense kernel's pass-1 block holds two 2^T x bm int32 tables:
    bm shrinks from 16 until they fit 227 KiB, so T = 14 keeps them in
    shared memory (one column per block); from T = 15, where one column's
    do not fit, they go to a global workspace at bm = min(16, M)."""
    from repro_torch.kernels import transitive_forest_dense as tfd
    assert tfd._columns_per_block(9, 64) == (16, True)
    assert tfd._columns_per_block(12, 64) == (4, True)
    assert tfd._columns_per_block(14, 64) == (1, True)
    assert tfd._table_bytes(14, 1) <= tfd._SMEM_LIMIT
    assert tfd._table_bytes(15, 1) > tfd._SMEM_LIMIT
    assert tfd._columns_per_block(15, 64) == (16, False)
    assert tfd._columns_per_block(15, 4) == (4, False)
    assert tfd._columns_per_block(20, 3) == (3, False)


@pytest.mark.parametrize("t,s,n,m,jg,groups,want", [
    # smollm-135m's MLP up/gate at decode: 16 ranks of 4 tables, one round
    (9, 4, 1536, 4, 64, 1, (4, 4, 2, 256, 16)),
    # T = 12: 64 KiB tables, two a round over 16 ranks; the down
    # projection (128 tiles) takes 2-column tables to fit four
    (12, 4, 1536, 4, 48, 1, (4, 2, 2, 256, 16)),
    (12, 4, 576, 4, 128, 1, (2, 4, 2, 256, 16)),
    # prefill: 8 columns, one 128 KiB table a round
    (12, 4, 1536, 512, 48, 1, (8, 1, 2, 256, 16)),
    # T = 14: two columns fit (128 KiB) with two buffers
    (14, 4, 16, 4, 2, 1, (2, 1, 2, 256, 2)),
    # T = 15: one column (128 KiB) and one buffer; 8 planes leave no room
    # for bn = 256
    (15, 8, 576, 4, 4, 1, (1, 1, 1, 128, 4)),
    (15, 4, 16, 4, 2, 1, (1, 1, 1, 256, 2))])
def test_fused16_tiling_fits_and_fills_the_card(t, s, n, m, jg, groups,
                                                want):
    """The fused kernel for 9 <= T <= 15 (``forest_fused16``): the tiling
    ``wide_tiling`` picks for 132 SMs (its cost model, fitted on an H100)
    fits a block's shared memory as the kernel carves it up, keeps every
    rank of a cluster (<= 16, one group) busy in the first round, holds
    bm to the power of two >= M and no more than 8 columns, and at T = 15
    leaves room for one column only."""
    from repro_torch.kernels import transitive_forest_dense as tfd
    tl = tfd.wide_tiling(t, s, n, m, jg, groups, 132)
    assert (tl.bm, tl.jb, tl.nbuf, tl.bn, tl.cluster) == want
    assert tl.smem == tfd.fused16_smem(t, s, tl.bm, tl.jb, tl.nbuf, tl.bn)
    assert tl.smem <= tfd._SMEM_LIMIT
    assert tl.jb * t * tl.bm <= 4 * tfd._WNT      # activations in flight
    assert tl.bm <= min(8, 1 << (m - 1).bit_length())
    assert tl.cluster <= 16 and (tl.cluster - 1) * tl.jb < jg
    if t == 15:
        assert tfd.fused16_smem(t, s, 2, 1, 1, 64) > tfd._SMEM_LIMIT


@pytest.mark.parametrize("t", [9, 12, 15])
def test_fused16_level_order_is_by_popcount_then_value(t):
    """``forest_fused16`` builds each level from the order table the
    wrapper hands it: every node once, level L (popcount L) in C(T, L)
    consecutive places, in increasing value, so a node's prefix (one bit
    fewer) lies in an earlier level; as int16 it keeps every value
    (nodes < 2^15)."""
    from math import comb

    from repro_torch.kernels import transitive_forest_dense as tfd
    order = tfd.level_order(t)
    assert order.dtype == np.uint16 and sorted(order) == list(range(1 << t))
    pop = np.array([bin(int(v)).count("1") for v in order])
    off = 0
    for lv in range(t + 1):
        level = order[off:off + comb(t, lv)]
        assert (pop[off:off + comb(t, lv)] == lv).all()
        assert (np.diff(level.astype(np.int64)) > 0).all()
        off += comb(t, lv)
    assert (order.view(np.int16) >= 0).all()
