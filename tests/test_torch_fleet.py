"""Port parity: the live-weight fleet (``repro_torch.fleet``, plan
persistence in ``repro_torch.core.engine`` and ``ServeEngine`` hot swap)
against ``repro.fleet`` and ``tests/test_fleet.py``'s behaviours.

Both packages run the reduced float32 smollm with 2 layers
(``tests/test_fleet.py``'s ``jit_cell``: seed-0 and seed-1234 weights),
the port on the reference's weights through
``convert.params_from_reference``. Held here:

* ``ExecutionPlan.save`` files load in both packages bit for bit, and
  ``load_bundle`` refuses as the reference does (config, shape even
  forced, fingerprint);
* ``pad_device_plan`` and ``build_generation`` / ``align_device_plans``
  give the reference's DevicePlans leaf for leaf, padded widths included;
* ``fingerprint_params`` equals the reference's digest;
* ``ReplanWorker`` builds, coalesces, supersedes and rolls back;
  ``WeightWatcher`` picks up checkpoints the reference's
  ``checkpoint.save`` wrote;
* the swap under load: every request's tokens equal the reference's
  ``ServeEngine`` drill on the same weights, per generation, on
  ``int_dot``, ``lut``, ``engine_torch`` and ``engine_cuda`` (its plain
  route on the CPU); through the worker, no plan is built or packed on
  the serving thread; structure mismatches, malformed plans and
  superseded stagings leave the serving generation untouched;
* bundles the reference's ``write_bundles`` wrote load with zero plan
  builds into plans equal to the port's own attach, and stale weights,
  config, backend, damaged files (even forced) and model shape drift are
  refused.

The reference's int32 accumulators do not depend on its backend, so one
reference drill (``engine_jit``) is the oracle for every port backend.
Worker tests wait on events and tickets with timeouts, never on sleeps.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
import repro.core.engine as RE  # noqa: E402
import repro.fleet as RF  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.core.plancache import PlanCache as RefPlanCache  # noqa: E402
from repro.core.plancache import (  # noqa: E402
    set_default_cache as ref_set_default_cache)
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
import repro_torch.core.backend as PB  # noqa: E402
import repro_torch.core.engine as PE  # noqa: E402
import repro_torch.fleet.replan as PR  # noqa: E402
from repro_torch.analysis import PlanVerificationError  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.backend import EngineConfig  # noqa: E402
from repro_torch.core.engine import BundleMismatchError  # noqa: E402
from repro_torch.core.plancache import (PlanCache, _canonical,  # noqa: E402
                                        _iter_ptq_layers, set_default_cache,
                                        weight_fingerprint)
from repro_torch.fleet import (ReplanSuperseded, ReplanWorker,  # noqa: E402
                               WeightWatcher, align_device_plans,
                               build_generation, fingerprint_params,
                               load_bundles, read_manifest, write_bundles)
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import SwapMismatchError  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("int_dot", "lut", "engine_torch", "engine_cuda")
PLANNED = ("engine_torch", "engine_cuda")
# the reference's names for the port's planned backends
REF_NAME = {"engine_torch": "engine_jit", "engine_cuda": "engine_pallas"}
PLEN, GEN, MAX_LEN, PAGE = 8, 4, 16, 4


def _ref_cfg(backend="engine_jit", **kw):
    return ref_serve_config(ref_reduced("smollm_135m"), backend=backend,
                            **kw).replace(dtype=jnp.float32)


def _cfg(backend, **kw):
    return serve_config(get_reduced("smollm_135m"), backend=backend,
                        **kw).replace(dtype=torch.float32)


@pytest.fixture
def cache():
    """A fresh process-default plan cache for each test (both packages)."""
    c = PlanCache(capacity=128)
    prev = set_default_cache(c)
    prev_ref = ref_set_default_cache(RefPlanCache(capacity=128))
    yield c
    set_default_cache(prev)
    ref_set_default_cache(prev_ref)


@pytest.fixture(scope="module")
def ref():
    """The reference's model and its two weight generations (JAX and
    numpy trees)."""
    model = RefModel(_ref_cfg())
    raw = [model.init(jax.random.PRNGKey(s)) for s in (0, 1234)]
    return model, raw, [jax.tree.map(np.asarray, r) for r in raw]


def _port(ref, backend, **kw):
    """(model, gen-0 params, gen-1 params) of the port on the reference's
    weights."""
    return (Model(_cfg(backend, **kw), device="cpu"),
            *(params_from_reference(r, "cpu") for r in ref[2]))


def _prompts(n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=PLEN).tolist() for _ in range(n)]


def _drive(eng, pending):
    """Submit ``pending`` one per step and run the engine dry."""
    submitted = 0
    while submitted < len(pending) or eng.queue or eng.active:
        if submitted < len(pending):
            eng.submit(pending[submitted], GEN)
            submitted += 1
        eng.step()


def _drill(eng, swap):
    """The swap under load: two requests in flight on generation 0, the
    swap staged, two more requests driven onto generation 1."""
    prompts = _prompts()
    for p in prompts[:2]:
        eng.submit(p, GEN)
    eng.step()
    assert swap() == 1
    _drive(eng, prompts[2:])
    return {r.rid: (r.gen, list(map(int, r.tokens))) for r in eng.finished}


@pytest.fixture(scope="module")
def ref_drill(ref):
    """The reference's drill on engine_jit: {rid: (generation, tokens)}."""
    prev = ref_set_default_cache(RefPlanCache(capacity=128))
    try:
        model = ref[0]
        gen0 = RF.build_generation(model, ref[1][0], gen=0)
        gen1 = RF.build_generation(model, ref[1][1], ref=gen0.params, gen=1)
        eng = RefServeEngine(model, gen0.params, n_slots=2, max_len=MAX_LEN,
                             page_size=PAGE)
        out = _drill(eng, lambda: eng.swap_params(gen1.params, tag="swap"))
    finally:
        ref_set_default_cache(prev)
    assert sorted(g for g, _ in out.values()) == [0, 0, 1, 1]
    return out, gen0, gen1


def _greedy(model, params, prompt, n=GEN):
    batch = {"tokens": torch.tensor([list(prompt)])}
    return greedy_generate(model, params, batch, max_len=MAX_LEN,
                           n_steps=n)[0].tolist()


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _assert_plans_equal(a, b):
    """Two ExecutionPlans (either package) equal field for field."""
    for f in ("t", "bits", "n", "k", "groups"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("rows", "direct_tile", "direct_node", "direct_bits", "signs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(a.steps) == len(b.steps)
    for sa, sb in zip(a.steps, b.steps):
        for f in ("tile", "node", "prefix", "bit"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    for f in ("counts", "exec_counts", "bridge", "distance", "prefix",
              "lane", "outlier", "wl_ppe", "wl_ape"):
        np.testing.assert_array_equal(getattr(a.si, f), getattr(b.si, f))
    assert (a.si.t, a.si.n_rows) == (b.si.t, b.si.n_rows)


def _assert_dplans_equal(a, b):
    """Two device plans (either package, any kind) equal leaf for leaf."""
    assert type(a).__name__ == type(b).__name__
    assert (a.t, a.bits, a.n, a.k, a.groups) == (b.t, b.bits, b.n, b.k,
                                                  b.groups)
    fields = (PE.DEVICE_DATA_FIELDS if type(a).__name__ == "DevicePlan"
              else tuple(a.leaves()))
    for f in fields:
        x, y = _host(getattr(a, f)), _host(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _layers(params):
    """{path: layer dict} of every PTQ layer."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            if "qw" in tree and "sg" in tree:
                out[path] = tree
                return
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
    walk(params, "")
    return out


# -- plan files: ExecutionPlan.save / load / load_bundle ---------------------

def _w(seed=0, n=9, k=32):
    return np.random.default_rng(seed).integers(-8, 8, size=(n, k))


def _plan_file(tmp_path, writer, w, *, fingerprint="auto", device=True):
    """Plan ``w`` and save it with ``writer``'s package; returns (path,
    the writer's plan)."""
    path = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        plan = PlanCache().get_or_build(w, EngineConfig(4, 8))
        fp = weight_fingerprint(_canonical(w))
        dev = PE.compile_plan(plan) if device else None
        backend = "engine_torch" if device else None
    else:
        plan = RE.BatchedTransitiveEngine(4, 8).plan(w)
        from repro.core.plancache import _canonical as rc, \
            weight_fingerprint as rfp
        fp = rfp(rc(w))
        dev = RE.compile_plan(plan) if device else None
        backend = "engine_jit" if device else None
    plan.save(path, device=dev, backend=backend,
              fingerprint=fp if fingerprint == "auto" else fingerprint)
    return path, plan


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_files_load_in_both_packages(tmp_path, writer):
    """A plan file either package writes loads in both, plan and
    DevicePlan bit for bit, with the same fingerprint and backend tag."""
    w = _w(0)
    path, plan = _plan_file(tmp_path, writer, w)
    mine = PE.ExecutionPlan.load_bundle(path)
    theirs = RE.ExecutionPlan.load_bundle(path)
    for b in (mine, theirs):
        _assert_plans_equal(b.plan, plan)
    _assert_plans_equal(PE.ExecutionPlan.load(path), plan)
    _assert_dplans_equal(mine.device, theirs.device)
    assert mine.device.tile_local
    assert mine.fingerprint == theirs.fingerprint == weight_fingerprint(
        _canonical(w))
    assert mine.backend == theirs.backend
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -128, 128, size=(32, 3)))
    assert torch.equal(PE.run_device(mine.device, x).long(),
                       torch.from_numpy(w) @ x)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", ["ok", "wrong_weights", "wrong_config",
                                  "shape_even_forced", "fingerprintless"])
def test_load_bundle_validation(tmp_path, writer, case):
    """The reference's load_bundle matrix, on files either package
    wrote, loaded by the port."""
    load = PE.ExecutionPlan.load_bundle
    w = _w(3 if case == "fingerprintless" else 0)
    path, plan = _plan_file(
        tmp_path, writer, w,
        fingerprint=None if case == "fingerprintless" else "auto")
    if case == "ok":
        b = load(path, qw=w, cfg=EngineConfig(w_bits=4, t=8, groups=1))
        assert b.device is not None and b.backend is not None
        assert b.fingerprint == weight_fingerprint(_canonical(w))
        assert (b.plan.n, b.plan.k) == (plan.n, plan.k)
    elif case == "wrong_weights":
        w2 = w.copy()
        w2[0, 0] ^= 1                     # same shape, other bits
        with pytest.raises(BundleMismatchError, match="stale plan"):
            load(path, qw=w2)
        assert load(path, qw=w2, force=True).plan
    elif case == "wrong_config":
        cfg8 = EngineConfig(w_bits=8, t=8, groups=1)
        with pytest.raises(BundleMismatchError, match="serving config"):
            load(path, cfg=cfg8)
        assert load(path, cfg=cfg8, force=True).plan
    elif case == "shape_even_forced":
        with pytest.raises(BundleMismatchError, match="n, k"):
            load(path, qw=_w(2, n=5, k=64), force=True)
    else:
        with pytest.raises(BundleMismatchError,
                           match="no weight fingerprint"):
            load(path, qw=w)
        assert load(path, qw=w, force=True).plan
        assert load(path).fingerprint is None


def test_pad_device_plan_is_bit_exact():
    """The port pads a DevicePlan to the reference's leaves, and the
    padded plan computes the same."""
    w = _w(4)
    dplan = PE.compile_plan(PlanCache().get_or_build(w, EngineConfig(4, 8)))
    rplan = RE.compile_plan(RE.BatchedTransitiveEngine(4, 8).plan(w))
    d = int(dplan.direct_idx.shape[-1])
    padded = PE.pad_device_plan(dplan, d + 7)
    _assert_dplans_equal(padded, RE.pad_device_plan(rplan, d + 7))
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -128, 128, size=(32, 3)))
    assert torch.equal(PE.run_device(padded, x), PE.run_device(dplan, x))
    with pytest.raises(ValueError):
        PE.pad_device_plan(dplan, d - 1)
    assert PE.pad_device_plan(dplan, d) is dplan


# -- generations: build_generation, align_device_plans, fingerprints --------

def test_build_generation_equals_the_reference(cache, ref):
    """engine_torch's generations are the reference's engine_jit ones leaf
    for leaf: cold-start pads (power-of-two widths) and gen 1 aligned to
    gen 0's widths."""
    model, p0, p1 = _port(ref, "engine_torch")
    gen0 = build_generation(model, p0, gen=0)
    gen1 = build_generation(model, p1, ref=gen0.params, gen=1)
    r0 = RF.build_generation(ref[0], ref[1][0], gen=0)
    r1 = RF.build_generation(ref[0], ref[1][1], ref=r0.params, gen=1)
    for mine, theirs in ((gen0, r0), (gen1, r1)):
        got, want = _layers(mine.params), _layers(theirs.params)
        assert got.keys() == want.keys() and len(got) == 7
        for path in got:
            _assert_dplans_equal(got[path]["dplan"], want[path]["dplan"])
        assert mine.fingerprint == theirs.fingerprint
        assert mine.plans_built == theirs.plans_built == 14
    widths0 = {p: int(lay["dplan"].direct_idx.shape[-1])
               for p, lay in _layers(gen0.params).items()}
    assert all(d >= 8 and d & (d - 1) == 0 for d in widths0.values())
    assert fingerprint_params(gen1.params) == fingerprint_params(p1)
    again = align_device_plans(gen1.params, gen0.params)
    for path, lay in _layers(again).items():
        _assert_dplans_equal(lay["dplan"], _layers(gen1.params)[path]["dplan"])


def test_align_passes_forest_plans_through(cache, ref):
    """engine_cuda's ForestPlans depend on the layer signature only: a
    generation's leaf shapes equal the previous one's, and alignment
    returns the very plans it was given."""
    model, p0, p1 = _port(ref, "engine_cuda")
    gen0 = build_generation(model, p0, gen=0)
    gen1 = build_generation(model, p1, ref=gen0.params, gen=1)
    l0, l1 = _layers(gen0.params), _layers(gen1.params)
    for path in l0:
        assert isinstance(l1[path]["dplan"], PE.ForestPlan)
        assert [a.shape for a in l0[path]["dplan"].leaves().values()] == \
            [a.shape for a in l1[path]["dplan"].leaves().values()]
    again = _layers(align_device_plans(gen1.params, gen0.params))
    assert all(again[p]["dplan"] is l1[p]["dplan"] for p in l1)


@pytest.mark.parametrize("tree", ["raw0", "raw1", "attached", "fp"])
def test_fingerprint_params_equals_the_reference(cache, ref, tree):
    """The digest of the reference's pytree walk: qw leaves only where the
    tree has them (attached plans skipped), else every leaf (bfloat16
    ones included)."""
    if tree == "fp":
        raw = RefModel(ref_reduced("smollm_135m")).init(
            jax.random.PRNGKey(0))
        mine = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
        assert str(mine["embed"].dtype) == "torch.bfloat16"
    elif tree == "attached":
        raw = RF.build_generation(ref[0], ref[1][0]).params
        model, p0, _ = _port(ref, "engine_cuda")
        mine = build_generation(model, p0).params
    else:
        i = int(tree[-1])
        raw, mine = ref[1][i], params_from_reference(ref[2][i], "cpu")
    assert fingerprint_params(mine) == RF.fingerprint_params(raw)


# -- ReplanWorker and WeightWatcher ------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_replan_worker_builds_and_notifies(cache, ref, backend):
    model, _, p1 = _port(ref, backend)
    ready = []
    with ReplanWorker(model, on_ready=ready.append) as w:
        t = w.submit(p1, tag="step-1")
        assert t.wait(timeout=120) and t.error is None
    g = t.generation
    assert ready == [g]
    assert g.fingerprint == fingerprint_params(p1) == RF.fingerprint_params(
        ref[1][1])
    assert g.tag == "step-1" and g.gen == 1
    assert g.plans_built == (14 if backend in PLANNED else 0)
    assert w.counters["built"] == 1 and w.counters["failed"] == 0


def test_replan_worker_coalesces_and_supersedes(cache, ref, monkeypatch):
    """Same-fingerprint submits share a ticket (in flight, queued, last
    completed); a queued, never started build is superseded by newer
    weights (depth-1 queue, newest wins)."""
    model, p0, p1 = _port(ref, "engine_cuda")
    gate, entered = threading.Event(), threading.Event()
    real = PR.build_generation

    def gated(model, params, **kw):
        entered.set()
        assert gate.wait(timeout=120)
        return real(model, params, **kw)
    monkeypatch.setattr(PR, "build_generation", gated)
    w = ReplanWorker(model)
    try:
        t0 = w.submit(p0)
        assert entered.wait(timeout=120)    # p0's build is parked
        assert w.submit(p0) is t0           # in-flight coalesce
        t1 = w.submit(p1)                   # queued
        assert w.submit(p1) is t1           # queued coalesce
        p2 = model.init(99)
        t2 = w.submit(p2)                   # supersedes the queued p1
        assert t1.done and isinstance(t1.error, ReplanSuperseded)
        gate.set()
        assert t0.wait(timeout=120) and t2.wait(timeout=120)
        assert t0.error is None and t2.error is None
        assert t2.generation.gen > t0.generation.gen
        assert w.submit(p2) is t2           # last-completed coalesce
        assert w.counters["coalesced"] == 3
        assert w.counters["superseded"] == 1
    finally:
        gate.set()
        w.stop()


@pytest.mark.parametrize("failure", ["injected", "bad_weights"])
def test_replan_worker_failure_is_rollback(cache, ref, monkeypatch,
                                           failure):
    """A failed build resolves its ticket with the error and fires
    on_error; on_ready never sees it."""
    model, p0, p1 = _port(ref, "engine_cuda")
    if failure == "injected":
        monkeypatch.setattr(PR, "build_generation",
                            lambda *a, **k: (_ for _ in ()).throw(
                                RuntimeError("scoreboard build exploded")))
    else:                                   # values outside int8
        p1 = {**p1, "blocks": {**p1["blocks"], "b0": {
            **p1["blocks"]["b0"], "wq": {
                **p1["blocks"]["b0"]["wq"],
                "qw": p1["blocks"]["b0"]["wq"]["qw"].to(torch.int32)
                * 1000}}}}
    ready, errs = [], []
    with ReplanWorker(model, on_ready=ready.append,
                      on_error=errs.append) as w:
        t = w.submit(p1)
        assert t.wait(timeout=120)
    assert t.error is not None and t.generation is None
    assert ready == [] and errs == [t.error]
    assert w.counters["failed"] == 1 and w.counters["built"] == 0


def test_weight_watcher_reads_reference_checkpoints(cache, ref, tmp_path):
    """Checkpoints the reference's checkpoint.save wrote feed the port's
    watcher: the restored generation is the new weights, planned."""
    from repro.distributed import checkpoint as ref_checkpoint
    model, p0, p1 = _port(ref, "engine_cuda")
    ckpt = str(tmp_path / "weights")
    with ReplanWorker(model) as w:
        watcher = WeightWatcher(ckpt, p0, w)
        assert watcher.poll() is None       # empty dir: nothing to do
        ref_checkpoint.save(ckpt, 1, ref[1][1])
        t = watcher.poll()
        assert t is not None and t.wait(timeout=120) and t.error is None
        assert watcher.poll() is None       # the same step: not resubmitted
    g = t.generation
    assert g.tag == 1 and g.plans_built == 14
    assert g.fingerprint == RF.fingerprint_params(ref[1][1])
    got, want = _layers(g.params), _layers(p1)
    for path in want:
        assert torch.equal(got[path]["qw"], want[path]["qw"])
        assert isinstance(got[path]["dplan"], PE.ForestPlan)


# -- hot swap under load ------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_under_load_equals_the_reference_drill(cache, ref, ref_drill,
                                                    backend):
    """Two requests in flight when the swap lands finish on generation 0,
    two admitted after it run on generation 1: every request's tokens
    equal the reference's ServeEngine drill and the port's own greedy
    path on that generation's weights."""
    model, p0, p1 = _port(ref, backend)
    gen0 = build_generation(model, p0, gen=0)
    gen1 = build_generation(model, p1, ref=gen0.params, gen=1)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, device="cpu")
    got = _drill(eng, lambda: eng.swap_params(gen1.params, tag="swap"))
    assert got == ref_drill[0]
    gparams = {0: gen0.params, 1: gen1.params}
    for r in eng.finished:
        assert r.tokens == _greedy(model, gparams[r.gen], r.prompt), r.rid
    s = eng.stats()
    assert s["generation"] == 1 and s["in_flight_prev_gen"] == 0
    assert (s["swaps"], s["swaps_staged"], s["swap_shape_drift"],
            s["generations_retired"]) == (1, 1, 0, 1)
    assert eng.swap_steps == [1] and eng.cell.tag == "swap"


def test_swap_via_replan_worker_off_the_serving_thread(cache, ref,
                                                        monkeypatch):
    """The whole wiring on engine_cuda: the worker plans and packs
    generation 1 while the engine decodes, on_ready stages the swap, the
    engine applies it at a step boundary. Every plan build and every pack
    after the warm-up ran on the worker's thread."""
    model, p0, p1 = _port(ref, "engine_cuda")
    gen0 = build_generation(model, p0, gen=0)
    threads = []
    real_plan, real_pack = PE.BatchedTransitiveEngine.plan, \
        PB.pack_forest_plan

    def plan(self, w, groups=1):
        threads.append(threading.current_thread())
        return real_plan(self, w, groups=groups)

    def pack(dplan, **kw):
        threads.append(threading.current_thread())
        return real_pack(dplan, **kw)
    monkeypatch.setattr(PE.BatchedTransitiveEngine, "plan", plan)
    monkeypatch.setattr(PB, "pack_forest_plan", pack)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, device="cpu")
    staged = threading.Event()

    def on_ready(g):
        eng.swap_params(g.params, tag=g.tag)
        staged.set()
    prompts = _prompts(3)
    with ReplanWorker(model, reference=gen0.params, on_ready=on_ready) as w:
        eng.submit(prompts[0], GEN)
        eng.step()
        t = w.submit(p1, tag="ckpt-1")
        while eng.active:                   # decode goes on meanwhile
            eng.step()
        assert t.wait(timeout=120) and t.error is None
        assert staged.wait(timeout=120)
        _drive(eng, prompts[1:])
    assert eng.generation == 1 and eng.counters["swaps"] == 1
    assert threads and all(th is w._thread for th in threads)
    assert len(threads) == 14 + 7           # 14 plans, 7 stacked packs
    gparams = {0: gen0.params, 1: t.generation.params}
    assert sorted(r.gen for r in eng.finished) == [0, 1, 1]
    for r in eng.finished:
        assert r.tokens == _greedy(model, gparams[r.gen], r.prompt), r.rid


@pytest.mark.parametrize("wrong", ["fewer_layers", "other_plan_kind",
                                   "malformed_plan"])
def test_refused_swap_leaves_generation_zero_serving(cache, ref, wrong):
    """A structurally different tree (SwapMismatchError) or a plan that
    fails its checks (ValueError) is refused before staging; the engine
    keeps serving generation 0, tokens unchanged."""
    model, p0, p1 = _port(ref, "engine_torch")
    gen0 = build_generation(model, p0, gen=0)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, device="cpu")
    if wrong == "fewer_layers":
        small = _cfg("engine_torch").replace(n_layers=1)
        bad, err = Model(small, device="cpu").init(5), SwapMismatchError
    elif wrong == "other_plan_kind":
        cuda_model = Model(_cfg("engine_cuda"), device="cpu")
        bad = build_generation(cuda_model, p1).params
        err = SwapMismatchError
    else:
        bad = build_generation(model, p1, ref=gen0.params).params
        dp = bad["blocks"]["b0"]["wq"]["dplan"]
        src = dp.level_src.clone()
        src[..., 0] = src.shape[-1] - 1     # reads another tile's row
        bad["blocks"]["b0"]["wq"] = {
            **bad["blocks"]["b0"]["wq"],
            "dplan": dataclasses.replace(dp, level_src=src)}
        err = ValueError
    with pytest.raises(err):
        eng.swap_params(bad)
    assert eng.generation == 0 and eng.counters["swaps_staged"] == 0
    p = _prompts(1)[0]
    _drive(eng, [p])
    assert eng.counters["swaps"] == 0
    assert eng.finished[0].tokens == _greedy(model, gen0.params, p)


def test_superseding_swap_drops_staged_generation(cache, ref):
    """Two swaps staged between the same pair of steps: only the newest is
    attached."""
    model, p0, p1 = _port(ref, "engine_cuda")
    gen0 = build_generation(model, p0, gen=0)
    gen1 = build_generation(model, p1, ref=gen0.params, gen=1)
    gen2 = build_generation(model, model.init(77), ref=gen0.params, gen=2)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, device="cpu")
    eng.swap_params(gen1.params, tag="a")
    final = eng.swap_params(gen2.params, tag="b")
    eng.step()
    assert eng.generation == final == 1
    assert eng.counters["swaps_superseded"] == 1
    assert eng.counters["swaps"] == 1
    assert eng.cell.tag == "b" and eng.params is gen2.params


def test_post_swap_equals_a_cold_started_process(cache, ref, tmp_path):
    """Requests admitted after the swap equal a cold-started process that
    serves the new weights alone (the weights reach it as a checkpoint)."""
    from repro_torch.distributed import checkpoint
    model, p0, p1 = _port(ref, "engine_cuda")
    gen0 = build_generation(model, p0, gen=0)
    gen1 = build_generation(model, p1, ref=gen0.params, gen=1)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, device="cpu")
    got = _drill(eng, lambda: eng.swap_params(gen1.params))
    post = {tuple(r.prompt): got[r.rid][1] for r in eng.finished
            if r.gen == 1}
    assert len(post) == 2
    ckpt = str(tmp_path / "new")
    checkpoint.save(ckpt, 1, p1)
    code = f"""
import json, torch
from repro_torch.configs import get_reduced
from repro_torch.distributed import checkpoint
from repro_torch.launch.specs import serve_config
from repro_torch.models.model import Model
from repro_torch.train.serve_step import greedy_generate
cfg = serve_config(get_reduced("smollm_135m"), backend="engine_cuda"
                   ).replace(dtype=torch.float32)
model = Model(cfg, device="cpu")
params = checkpoint.restore({ckpt!r}, 1, model.init(0))
params = model.attach_device_plans(params)
out = {{}}
for prompt in {[list(p) for p in post]!r}:
    toks = greedy_generate(model, params, {{"tokens": torch.tensor([prompt])}},
                           max_len={MAX_LEN}, n_steps={GEN})
    out[json.dumps(prompt)] = toks[0].tolist()
print("COLD " + json.dumps(out))
"""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("COLD "))
    cold = {tuple(json.loads(k)): v
            for k, v in json.loads(line[5:]).items()}
    assert cold == post


# -- plan bundles -------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle_dirs(ref, tmp_path_factory):
    """Bundles of the gen-0 weights: {(writer, backend): directory}."""
    out = {}
    prev = ref_set_default_cache(RefPlanCache(capacity=128))
    try:
        for backend in PLANNED:
            d = str(tmp_path_factory.mktemp(f"port_{backend}"))
            write_bundles(_port(ref, backend)[1], _cfg(backend).quant, d,
                          cache=PlanCache(capacity=128))
            out[("port", backend)] = d
            d = str(tmp_path_factory.mktemp(f"ref_{backend}"))
            RF.write_bundles(ref[1][0], _ref_cfg().quant, d,
                             backend=REF_NAME[backend])
            out[("reference", backend)] = d
    finally:
        ref_set_default_cache(prev)
    return out


def _count_builds(monkeypatch):
    builds = []
    real = PE.BatchedTransitiveEngine.plan
    monkeypatch.setattr(PE.BatchedTransitiveEngine, "plan",
                        lambda self, w, groups=1: builds.append(1) or real(
                            self, w, groups=groups))
    return builds


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("backend", PLANNED)
def test_bundles_load_with_zero_builds(cache, ref, bundle_dirs,
                                       monkeypatch, writer, backend):
    """A fresh server attaches bundles (the reference's too) with no plan
    build and no cache lookup; its plans equal its own attach leaf for
    leaf (ForestPlans packed from the stored DevicePlans for
    engine_cuda), and it generates the same tokens."""
    model, p0, _ = _port(ref, backend)
    bdir = bundle_dirs[(writer, backend)]
    m = read_manifest(bdir)
    assert m["weights_fingerprint"] == fingerprint_params(p0)
    assert (m["n_layers"], m["n_files"]) == (7, 14)
    builds = _count_builds(monkeypatch)
    attached = load_bundles(p0, model.cfg.quant, bdir)
    assert builds == [] and cache.stats()["hits"] + \
        cache.stats()["misses"] == 0 and len(cache) == 0
    own = model.attach_device_plans(p0)
    got, want = _layers(attached), _layers(own)
    assert got.keys() == want.keys()
    for path in got:
        _assert_dplans_equal(got[path]["dplan"], want[path]["dplan"])
    p = _prompts(1)[0]
    assert _greedy(model, attached, p) == _greedy(model, own, p)


@pytest.mark.parametrize("case", ["stale_weights", "config", "backend",
                                  "corrupted", "corrupted_forced",
                                  "model_shape", "missing_manifest",
                                  "non_device_backend"])
def test_bundles_refusals(cache, ref, bundle_dirs, tmp_path, case):
    model, p0, p1 = _port(ref, "engine_cuda")
    bdir = bundle_dirs[("reference", "engine_cuda")]
    q = model.cfg.quant
    if case == "stale_weights":
        with pytest.raises(BundleMismatchError, match="stale bundle"):
            load_bundles(p1, q, bdir)
        assert load_bundles(p1, q, bdir, force=True) is not None
    elif case == "config":
        with pytest.raises(BundleMismatchError, match="engine_config"):
            load_bundles(p0, _cfg("engine_cuda", w_bits=8).quant, bdir)
    elif case == "backend":
        with pytest.raises(BundleMismatchError, match="backend"):
            load_bundles(p0, _cfg("engine_torch").quant, bdir)
    elif case.startswith("corrupted"):
        import shutil
        bad = str(tmp_path / "bundles")
        shutil.copytree(bdir, bad)
        victim = next(iter(read_manifest(bad)["layers"].values()))
        path = os.path.join(bad, victim["files"][0]["file"])
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        # as in the reference: damaged bytes are refused structurally
        # (the plan verifier, before the hash) or, where the flip survives
        # parsing, by the hash; force= bypasses neither
        refused = (BundleMismatchError, PlanVerificationError)
        with pytest.raises(refused, match="hash mismatch|refused|planlint"):
            load_bundles(p0, q, bad, force=case.endswith("forced"))
    elif case == "model_shape":
        small = Model(_cfg("engine_cuda").replace(n_layers=1),
                      device="cpu").init(0)
        with pytest.raises(BundleMismatchError):
            load_bundles(small, q, bdir, force=True)
    elif case == "missing_manifest":
        with pytest.raises(FileNotFoundError, match="manifest"):
            read_manifest(str(tmp_path / "nope"))
    else:
        for backend in ("int_dot", "lut", "lut_cuda"):
            with pytest.raises(ValueError, match="device plans"):
                write_bundles(p0, _cfg(backend).quant,
                              str(tmp_path / backend))


def test_loaded_plans_pass_the_port_checks(cache, ref, bundle_dirs):
    """Every plan a bundle load attaches passes the plan verifier's device
    rules (the forest rules on engine_cuda's ForestPlans); a DevicePlan
    that is not a compile_plan lowering does not."""
    from repro_torch.analysis import planlint
    for backend in PLANNED:
        model, p0, _ = _port(ref, backend)
        for lay in _iter_ptq_layers(load_bundles(
                p0, model.cfg.quant, bundle_dirs[("port", backend)])):
            assert planlint.verify_device_plan(lay["dplan"]) == []
    dp = PE.compile_plan(PlanCache().get_or_build(_w(0), EngineConfig(4, 8)))
    xsrc = dp.level_xsrc.clone()
    lv, r = (int(i) for i in torch.nonzero(xsrc != dp.k)[0])
    xsrc[lv, r] = ((r >> dp.t) + 1) % (dp.k // dp.t) * dp.t   # next tile
    with pytest.raises(PlanVerificationError, match="tile-local"):
        planlint.gate_device(dataclasses.replace(dp, level_xsrc=xsrc),
                             where="bundle-load")
