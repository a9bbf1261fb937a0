"""Port parity: the plan verifier (``repro_torch.analysis.planlint``)
against ``repro.analysis.planlint`` and ``tests/test_planlint.py``.

Three layers of evidence:

* **twins of the reference's corpus**: the same weights (numpy, from a
  seed) are planned by both packages and the same corruption is applied
  to both packages' artifacts (the plan IR, the DevicePlan, a truncated
  bundle npz, the manifest); the findings must be equal on rule,
  severity, path, primitive and message, and clean artifacts verify to
  ``[]`` in both. The three gates are run in both packages on the same
  weights (the port's on ``params_from_reference``) with the same
  ``where`` and findings; the ``REPRO_PLANLINT=0`` switch, the loud
  registry and ``lint_plans`` (``engine_torch`` beside ``engine_jit``,
  the same artifact labels) too;
* **a corpus for the port's five forest rules**: ForestPlans at T = 4, 8
  (grouped, and stacked) and 12, SparseForestPlans at T = 16 (grouped,
  and stacked); each corruption gives exactly one finding of the rule
  that guards it, and every content corruption makes the kernels' plain
  version (``forest_plan_plain`` / ``sparse_forest_plain``) differ from
  the exact integer GEMM, which the clean plan equals;
* **the gates on the CPU** for ``engine_torch`` and ``engine_cuda``
  (cache publish and lowering, bundle load before the hash, swap
  staging) and the launcher's ``--lint`` on the reduced model.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
import repro.analysis.planlint as RL  # noqa: E402
import repro.core.engine as RE  # noqa: E402
import repro.fleet as RF  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.core.backend import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.backend import get_backend as ref_backend  # noqa: E402
from repro.core.plancache import PlanCache as RefPlanCache  # noqa: E402
from repro.core.plancache import (  # noqa: E402
    set_default_cache as ref_set_default_cache)
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
import repro_torch.analysis.planlint as PL  # noqa: E402
import repro_torch.core.engine as PE  # noqa: E402
import repro_torch.fleet.bundles as PBundles  # noqa: E402
from repro_torch.analysis import PlanVerificationError  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.backend import EngineConfig, get_backend  # noqa: E402
from repro_torch.core.plancache import (PlanCache,  # noqa: E402
                                        set_default_cache)
from repro_torch.fleet import build_generation, load_bundles  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

PLANNED = ("engine_torch", "engine_cuda")
# the reference's names for the port's planned backends
REF_NAME = {"engine_torch": "engine_jit", "engine_cuda": "engine_pallas"}


def _w(seed, shape=(8, 16), lo=-8):
    return np.random.default_rng(seed).integers(lo, -lo, shape)


@pytest.fixture(scope="module")
def pair():
    """(reference plan, its engine_jit DevicePlan, port plan, its
    engine_torch DevicePlan) of one seeded W4 weight at T = 4."""
    w = _w(0)
    rplan = RE.BatchedTransitiveEngine(bits=4, t=4).plan(w)
    pplan = PE.BatchedTransitiveEngine(bits=4, t=4).plan(w)
    return (rplan, ref_backend("engine_jit").compile(rplan), pplan,
            get_backend("engine_torch").compile(pplan))


@pytest.fixture()
def cache():
    """Fresh process-default plan caches (both packages)."""
    c = PlanCache(capacity=32)
    prev = set_default_cache(c)
    prev_ref = ref_set_default_cache(RefPlanCache(capacity=32))
    yield c
    set_default_cache(prev)
    ref_set_default_cache(prev_ref)


def _fields(findings):
    return [(f.rule, f.severity, f.path, f.primitive, f.message)
            for f in findings]


def _one(findings, rule, field_sub=""):
    """The corpus contract: exactly one error finding, right rule, and a
    path that names the corrupted field."""
    assert len(findings) == 1, [f.format() for f in findings]
    f = findings[0]
    assert f.severity == "error" and f.rule == rule, f.format()
    assert field_sub in f.path, f.format()
    return f


def _twin(ref_findings, port_findings, rule=None, field_sub=""):
    """Both packages report the same findings; with ``rule``, exactly one
    of it."""
    assert _fields(port_findings) == _fields(ref_findings)
    if rule is None:
        assert port_findings == []
    else:
        _one(port_findings, rule, field_sub)


def _np(x):
    return np.array(x, dtype=np.int64)


def _mut_step(plan, i, **arrays):
    """Replace selected arrays of ``plan.steps[i]`` (either package)."""
    s = plan.steps[i]
    new = type(s)(**{k: arrays.get(k, getattr(s, k))
                     for k in ("tile", "node", "prefix", "bit")})
    return dataclasses.replace(plan, steps=plan.steps[:i] + (new,)
                               + plan.steps[i + 1:])


def _leaf(dev, name):
    a = getattr(dev, name)
    return _np(a.numpy() if isinstance(a, torch.Tensor) else a)


def _with(dev, **arrays):
    """``dev`` with some leaves replaced by int64 arrays (tensors in the
    port's DevicePlan, numpy in the reference's, as its tests do)."""
    conv = torch.from_numpy if isinstance(dev, PE.DevicePlan) else _np
    return dataclasses.replace(dev, **{k: conv(v) for k, v in arrays.items()})


# -- the healthy artifacts verify clean --------------------------------------

def test_clean_plan_and_device(pair):
    rplan, rdev, pplan, pdev = pair
    _twin(RL.verify_plan(rplan), PL.verify_plan(pplan))
    _twin(RL.verify_device_plan(rdev, rplan),
          PL.verify_device_plan(pdev, pplan))


def test_clean_padded_and_stacked(pair):
    rplan, rdev, pplan, pdev = pair
    d = int(pdev.direct_idx.shape[-1])
    _twin(RL.verify_device_plan(RE.pad_device_plan(rdev, d + 3), rplan),
          PL.verify_device_plan(PE.pad_device_plan(pdev, d + 3), pplan))
    _twin(RL.verify_device_plan(RE.compile_plans([rplan, rplan])),
          PL.verify_device_plan(PE.compile_plans([pplan, pplan])))


# -- mutation corpus: plan IR ------------------------------------------------

def _cycle(plan):
    """A level-1 edge whose prefix is a LATER-level node."""
    s = plan.steps[0]
    nd = int(s.node[0])
    b = next(bb for bb in range(plan.t) if not (nd >> bb) & 1)
    prefix = _np(s.prefix)
    prefix[0] = nd | (1 << b)
    bit = _np(s.bit)
    bit[0] = b
    return _mut_step(plan, 0, prefix=prefix, bit=bit)


def _duplicate(plan):
    s = plan.steps[1]
    arrays = {k: _np(getattr(s, k)) for k in ("tile", "node", "prefix", "bit")}
    for a in arrays.values():          # edge 1 := copy of edge 0
        a[1] = a[0]
    return _mut_step(plan, 1, **arrays)


def _oob_step_node(plan):
    node = _np(plan.steps[0].node)
    node[0] = 1 << plan.t
    return _mut_step(plan, 0, node=node)


def _oob_rows(plan):
    rows = _np(plan.rows)
    rows[0, 0, 0] = 1 << plan.t
    return dataclasses.replace(plan, rows=rows)


PLAN_MUTATIONS = {
    "cycle_spliced_into_reuse_graph": (_cycle, "plan-schedule-dag",
                                       "steps[0].prefix[0]"),
    "reordered_level": (lambda p: dataclasses.replace(
        p, steps=(p.steps[1], p.steps[0]) + p.steps[2:]),
        "plan-schedule-levels", "steps[0].node"),
    "duplicate_production": (_duplicate, "plan-schedule-dag",
                             "steps[1].node[1]"),
    "oob_step_node": (_oob_step_node, "plan-bounds", "node"),
    "oob_rows": (_oob_rows, "plan-bounds", "rows[0, 0, 0]"),
    "groups_mismatch": (lambda p: dataclasses.replace(p, groups=3),
                        "plan-shape", "groups"),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_dag_finds_the_reference_walks_first_fault(seed):
    """The port's ``plan-schedule-dag`` finds a violation with array ops
    where the reference walks every edge in order: on seeded plans and
    random edits of their steps (a prefix, a node or a tile moved, an
    edge copied over another) and of their direct dispatch, both report
    the same first finding, or none."""
    rng = np.random.default_rng(seed)
    rule, ref_rule = (PL.get_plan_rule("plan-schedule-dag"),
                      RL.get_plan_rule("plan-schedule-dag"))
    found = 0
    for _ in range(25):
        t = int(rng.choice([3, 4, 8]))
        k = t * int(rng.integers(1, 5))
        w = rng.integers(-8, 8, (int(rng.integers(2, 16)), k))
        rplan = RE.BatchedTransitiveEngine(bits=4, t=t).plan(w)
        pplan = PE.BatchedTransitiveEngine(bits=4, t=t).plan(w)
        edits = [(rplan, pplan)]
        for _ in range(4):
            i = int(rng.integers(len(pplan.steps)))
            arrays = {f: _np(getattr(pplan.steps[i], f))
                      for f in ("tile", "node", "prefix", "bit")}
            e, e2 = rng.integers(arrays["node"].size, size=2)
            kind = int(rng.integers(4))
            if kind == 3:
                for a in arrays.values():
                    a[e2] = a[e]
            else:
                f, hi = (("prefix", 1 << t), ("node", 1 << t),
                         ("tile", k // t))[kind]
                arrays[f][e] = rng.integers(0, hi)
            edits.append((_mut_step(rplan, i, **arrays),
                          _mut_step(pplan, i, **arrays)))
        if pplan.direct_tile.size > 1:
            dt, dn = _np(pplan.direct_tile), _np(pplan.direct_node)
            dt[1], dn[1] = dt[0], dn[0]
            edits.append(tuple(dataclasses.replace(
                p, direct_tile=dt, direct_node=dn) for p in (rplan, pplan)))
        for rp, pp in edits:
            want = ref_rule.check(RL.PlanArtifact(kind="plan", name="p",
                                                  plan=rp))
            got = rule.check(PL.PlanArtifact(kind="plan", name="p", plan=pp))
            assert _fields(got) == _fields(want)
            found += bool(got)
    assert found >= 25


@pytest.mark.parametrize("case", list(PLAN_MUTATIONS))
def test_plan_mutation_twin(pair, case):
    """``test_mut_cycle_spliced_into_reuse_graph``, ``_reordered_level``,
    ``_duplicate_production``, ``_oob_step_node``, ``_oob_rows`` and
    ``_groups_mismatch`` on both packages' plans."""
    rplan, _, pplan, _ = pair
    mutate, rule, field = PLAN_MUTATIONS[case]
    _twin(RL.verify_plan(mutate(rplan)), PL.verify_plan(mutate(pplan)),
          rule, field)


# -- mutation corpus: device plan --------------------------------------------

def _oob_gather(plan, dev):
    gi = _leaf(dev, "gather_idx")
    gi[0, 0, 0] = plan.n_tiles << plan.t
    return _with(dev, gather_idx=gi)


def _identity_reads_real_row(plan, dev):
    ls, lx = _leaf(dev, "level_src"), _leaf(dev, "level_xsrc")
    lv, row = np.argwhere(ls == np.arange(ls.shape[-1])[None, :])[0]
    lx[lv, row] = 0
    return _with(dev, level_xsrc=lx)


def _monotone_broken(plan, dev):
    ls = _leaf(dev, "level_src")
    r = np.arange(ls.shape[-1])
    lvl1 = np.flatnonzero(ls[0] != r)
    lvl2 = np.flatnonzero(ls[1] != r)
    ls[0, lvl1[0]] = lvl2[0]
    return _with(dev, level_src=ls)


def _non_dead_pad(plan, dev):
    d = int(_leaf(dev, "direct_idx").shape[-1])
    pad = (RE.pad_device_plan if isinstance(dev, RE.DevicePlan)
           else PE.pad_device_plan)(dev, d + 2)
    db = _leaf(pad, "direct_bits")
    db[-1, 0] = 1
    return _with(pad, direct_bits=db)


def _content(plan, dev):
    """A last-level lane gathering a never-executed row: in bounds,
    identity-consistent, monotone, one writer — only the recompile
    comparison can see it."""
    ls = _leaf(dev, "level_src")
    r = np.arange(ls.shape[-1])
    never_exec = np.flatnonzero((ls == r[None, :]).all(0))
    direct = set(_leaf(dev, "direct_idx").tolist())
    gathered = set(ls[ls != r[None, :]].tolist())
    lanes = [int(rr) for rr in never_exec
             if rr not in direct and rr not in gathered]
    srcs = [int(rr) for rr in never_exec
            if rr not in direct and rr != lanes[0]]
    lv = ls.shape[0] - 1
    ls[lv, lanes[0]] = srcs[0]
    lx = _leaf(dev, "level_xsrc")
    lx[lv, lanes[0]] = 0
    return _with(dev, level_src=ls, level_xsrc=lx)


DEVICE_MUTATIONS = {
    "oob_gather_index": (_oob_gather, "device-bounds", "gather_idx[0, 0, 0]"),
    "identity_lane_reads_real_row": (_identity_reads_real_row,
                                     "device-identity-lanes", "level_xsrc"),
    "level_monotonicity_broken": (_monotone_broken, "device-level-monotone",
                                  "level_src[0, "),
    "non_dead_pad_lane": (_non_dead_pad, "device-direct-dispatch",
                          "direct_bits["),
    "content_corruption_caught_by_agreement": (
        _content, "plan-device-agreement", "level_src"),
}


@pytest.mark.parametrize("case", list(DEVICE_MUTATIONS))
def test_device_mutation_twin(pair, case):
    """``test_mut_oob_gather_index``, ``_identity_lane_reads_real_row``,
    ``_level_monotonicity_broken``, ``_non_dead_pad_lane`` and
    ``_content_corruption_caught_by_agreement`` on both packages'
    DevicePlans (the port's leaves are torch tensors)."""
    rplan, rdev, pplan, pdev = pair
    mutate, rule, field = DEVICE_MUTATIONS[case]
    _twin(RL.verify_device_plan(mutate(rplan, rdev), rplan),
          PL.verify_device_plan(mutate(pplan, pdev), pplan), rule, field)


# -- mutation corpus: persisted bundles --------------------------------------

def test_mut_truncated_bundle_npz(tmp_path, pair):
    """One file, written by the reference and truncated: both packages
    refuse it with the same finding (the port's loader reads the
    reference's npz)."""
    rplan, rdev, _, _ = pair
    p = str(tmp_path / "layer0.npz")
    rplan.save(p, device=rdev, backend="engine_jit")
    _twin(RL.verify_bundle_file(p), PL.verify_bundle_file(p))
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:len(blob) // 2])
    f = _one(PL.verify_bundle_file(p), "bundle-file", "layer0.npz")
    assert "refused before any hash comparison" in f.message
    _twin(RL.verify_bundle_file(p), PL.verify_bundle_file(p), "bundle-file")


def _manifest():
    files = [{"file": "l0.npz", "index": [], "sha256": "0" * 64}]
    return {"format": 1, "backend": "engine_jit",
            "engine_config": {"w_bits": 4, "t": 4},
            "weights_fingerprint": "f" * 16, "n_layers": 1,
            "n_files": 1,
            "layers": {"blocks/0/qlin": {"lead": [], "groups": 1,
                                         "files": files}}}


def _missing_key(m):
    del m["weights_fingerprint"]
    return m


def _duplicate_slice(m):
    meta = m["layers"]["blocks/0/qlin"]
    meta["lead"] = [2]
    meta["files"] = [
        {"file": "a.npz", "index": [0], "sha256": "0" * 64},
        {"file": "b.npz", "index": [0], "sha256": "1" * 64}]
    m["n_files"] = 2
    return m


@pytest.mark.parametrize("case, mutate, rule, field", [
    ("clean", lambda m: m, None, ""),
    ("missing_key", _missing_key, "bundle-manifest", "weights_fingerprint"),
    ("duplicate_slice_index", _duplicate_slice, "bundle-manifest",
     "files[1].index"),
])
def test_manifest_twin(case, mutate, rule, field):
    """``test_clean_manifest``, ``test_mut_manifest_missing_key`` and
    ``test_mut_manifest_duplicate_slice_index``."""
    _twin(RL.verify_manifest(mutate(_manifest())),
          PL.verify_manifest(mutate(_manifest())), rule, field)


# -- the gates, twinned ------------------------------------------------------

def _corrupting_planner(real):
    def corrupt(self, w, groups=1):
        p = real(self, w, groups=groups)
        rows = np.array(p.rows, np.int64)
        rows[0, 0, 0] = 1 << p.t
        return dataclasses.replace(p, rows=rows)
    return corrupt


@pytest.mark.parametrize("backend", PLANNED)
def test_gate_cache_publish_refuses_corrupt_plan(cache, monkeypatch,
                                                 backend):
    """A planner bug (injected in both packages) is stopped at publish with
    the same finding; the port's cache publishes nothing, and a healthy
    rebuild is a miss, not a hit."""
    w = _w(3)
    errors = []
    for engine, get in (
            (RE.BatchedTransitiveEngine, lambda: RefPlanCache(8).get_or_build(
                w, RefEngineConfig(w_bits=4, t=4))),
            (PE.BatchedTransitiveEngine, lambda: cache.get_or_build_device(
                w, EngineConfig(w_bits=4, t=4), backend=backend,
                device="cpu"))):
        real = engine.plan
        monkeypatch.setattr(engine, "plan", _corrupting_planner(real))
        with pytest.raises(ValueError) as ei:
            get()
        monkeypatch.setattr(engine, "plan", real)
        errors.append(ei.value)
    ref_err, err = errors
    assert isinstance(err, PlanVerificationError)
    assert (err.where, ref_err.where) == ("cache-publish",) * 2
    _twin(ref_err.findings, err.findings, "plan-bounds", "rows[0, 0, 0]")
    assert len(cache) == 0
    out = cache.get_or_build_device(w, EngineConfig(w_bits=4, t=4),
                                    backend=backend, device="cpu")
    assert PL.verify_device_plan(out) == []
    assert (cache.stats()["hits"], cache.stats()["misses"]) == (0, 2)


def _corrupt_forest(fp, plan_w=None):
    """A copy of an unstacked ForestPlan whose first gathered made node
    that no other node is made from becomes FOREST_UNUSED (the silent
    fault), with the tile and node."""
    prod = fp.producer.numpy().copy()
    rows = fp.rows.numpy().astype(np.int64)
    t = fp.t
    for j in range(prod.shape[0]):
        p = prod[j].astype(np.int64)
        chained = np.flatnonzero(p < t)
        prefixes = set((chained ^ (1 << p[chained])).tolist())
        for v in np.unique(rows[j]):
            if v and int(v) not in prefixes:
                prod[j, v] = PE.FOREST_UNUSED
                return dataclasses.replace(
                    fp, producer=torch.from_numpy(prod)), j, int(v)
    raise AssertionError("no gathered leaf node")


def _lowering_corrupter(backend):
    """A compile hook that corrupts its lowering: an out-of-table gather
    (DevicePlan) or the silent fault (ForestPlan)."""
    real = type(get_backend(backend)).compile

    def compile(self, plan, device=None):
        out = real(self, plan, device=device)
        if isinstance(out, PE.ForestPlan):
            return _corrupt_forest(out)[0]
        gi = out.gather_idx.clone()
        gi[0, 0, 0] = out.n_tiles << out.t
        return dataclasses.replace(out, gather_idx=gi)
    return real, compile


@pytest.mark.parametrize("backend, rule", [
    ("engine_torch", "device-bounds"), ("engine_cuda", "forest-gathers")])
def test_gate_cache_lowering_refuses_corrupt_lowering(cache, monkeypatch,
                                                      backend, rule):
    """A corrupting lowering is refused at ``cache-lowering`` before it is
    memoized; the healthy lowering then memoizes and verifies."""
    w, cfg = _w(4), EngineConfig(w_bits=4, t=4)
    real, corrupt = _lowering_corrupter(backend)
    monkeypatch.setattr(type(get_backend(backend)), "compile", corrupt)
    with pytest.raises(PlanVerificationError) as ei:
        cache.get_or_build_device(w, cfg, backend=backend, device="cpu")
    assert ei.value.where == "cache-lowering"
    _one(ei.value.findings, rule)
    assert all(not e.device for e in cache._plans.values())
    monkeypatch.setattr(type(get_backend(backend)), "compile", real)
    out = cache.get_or_build_device(w, cfg, backend=backend, device="cpu")
    plan = cache.get_or_build(w, cfg)
    assert PL.verify_device_plan(out, plan) == []


def _ref_cfg(backend):
    return ref_serve_config(ref_reduced("smollm_135m").replace(n_layers=1),
                            backend=backend)


def _cfg(backend):
    return serve_config(get_reduced("smollm_135m").replace(n_layers=1),
                        backend=backend)


@pytest.fixture(scope="module")
def ref_raw():
    """The reduced 1-layer smollm's seed-0 and seed-9 weights (the
    reference's JAX trees and numpy copies)."""
    model = RefModel(_ref_cfg("engine_jit"))
    raw = [model.init(jax.random.PRNGKey(s)) for s in (0, 9)]
    return raw, [jax.tree.map(np.asarray, r) for r in raw]


@pytest.mark.parametrize("backend", PLANNED)
def test_gate_bundle_load_refuses_before_sha256(cache, tmp_path, monkeypatch,
                                                ref_raw, backend):
    """The reference writes the bundles; one file is truncated. Both
    loaders refuse the directory at ``bundle-load`` with the same
    finding, and the port's ``_sha256`` never reads the file."""
    cfg = _ref_cfg(REF_NAME[backend])
    bdir = str(tmp_path / "b")
    manifest = RF.write_bundles(ref_raw[0][0], cfg.quant, bdir)
    victim = next(iter(manifest["layers"].values()))["files"][0]["file"]
    vpath = os.path.join(bdir, victim)
    blob = open(vpath, "rb").read()
    open(vpath, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(RL.PlanVerificationError) as ref_ei:
        RF.load_bundles(ref_raw[0][0], cfg.quant, bdir)

    hashed = []
    real_sha = PBundles._sha256
    monkeypatch.setattr(PBundles, "_sha256",
                        lambda p: hashed.append(str(p)) or real_sha(p))
    params = params_from_reference(ref_raw[1][0], "cpu")
    with pytest.raises(PlanVerificationError) as ei:
        load_bundles(params, _cfg(backend).quant, bdir)
    assert (ei.value.where, ref_ei.value.where) == ("bundle-load",) * 2
    _twin(ref_ei.value.findings, ei.value.findings, "bundle-file", victim)
    assert vpath not in hashed, \
        "sha256 ran on the corrupted file before planlint refused it"


def _corrupt_params(tree, fn):
    if isinstance(tree, dict):
        return {k: _corrupt_params(v, fn) for k, v in tree.items()}
    return fn(tree)


def _bad_gather(tree):
    if isinstance(tree, (RE.DevicePlan, PE.DevicePlan)):
        gi = _leaf(tree, "gather_idx")
        gi[(0,) * gi.ndim] = -1
        return _with(tree, gather_idx=gi)
    return tree


def _unused_gathered_node(tree):
    """A stacked ForestPlan with the silent fault in entry 0."""
    if not isinstance(tree, PE.ForestPlan):
        return tree
    one, _, _ = _corrupt_forest(tree.index(0))
    prod = tree.producer.clone()
    prod[0] = one.producer
    return dataclasses.replace(tree, producer=prod)


@pytest.mark.parametrize("backend", PLANNED)
def test_gate_swap_staging_refuses_corrupt_dplan(cache, ref_raw, backend):
    """A malformed plan in a hot-swap generation is refused at staging —
    nothing is staged — and the healthy swap then stages. On
    ``engine_torch`` the finding equals the reference's on the same
    corruption of its own generation; on ``engine_cuda`` a stacked
    ForestPlan with a gathered node set to FOREST_UNUSED is refused by
    ``forest-gathers``."""
    model = Model(_cfg(backend), device="cpu")
    raw = [params_from_reference(r, "cpu") for r in ref_raw[1]]
    gen0 = build_generation(model, raw[0], gen=0)
    gen1 = build_generation(model, raw[1], ref=gen0.params, gen=1)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=16,
                      page_size=4, device="cpu")
    fault = _bad_gather if backend == "engine_torch" else \
        _unused_gathered_node
    with pytest.raises(PlanVerificationError) as ei:
        eng.swap_params(_corrupt_params(gen1.params, fault))
    assert ei.value.where == "swap-staging"
    assert eng.stats()["swaps_staged"] == 0
    if backend == "engine_torch":
        rmodel = RefModel(_ref_cfg("engine_jit"))
        r0 = RF.build_generation(rmodel, ref_raw[0][0], gen=0)
        r1 = RF.build_generation(rmodel, ref_raw[0][1], ref=r0.params,
                                 gen=1)
        reng = RefServeEngine(rmodel, r0.params, n_slots=2, max_len=16,
                              page_size=4)
        with pytest.raises(RL.PlanVerificationError) as ref_ei:
            reng.swap_params(_corrupt_params(r1.params, _bad_gather))
        assert ref_ei.value.where == "swap-staging"
        _twin(ref_ei.value.findings, ei.value.findings, "device-bounds")
    else:
        _one(ei.value.findings, "forest-gathers", "rows[")
    eng.swap_params(gen1.params)
    assert eng.stats()["swaps_staged"] == 1


def test_gates_disabled_by_env(pair, monkeypatch):
    monkeypatch.setenv("REPRO_PLANLINT", "0")
    rplan, _, pplan, pdev = pair
    RL.gate_plan(dataclasses.replace(rplan, groups=3), where="anywhere")
    PL.gate_plan(dataclasses.replace(pplan, groups=3), where="anywhere")
    PL.gate_device(_oob_gather(pplan, pdev), where="anywhere")
    PL.gate_params({"dplan": _oob_gather(pplan, pdev)}, where="anywhere")
    monkeypatch.setenv("REPRO_PLANLINT", "1")
    with pytest.raises(PlanVerificationError, match="plan-shape"):
        PL.gate_plan(dataclasses.replace(pplan, groups=3), where="anywhere")


# -- registry ----------------------------------------------------------------

def test_plan_rule_registry_is_loud():
    class Dummy(PL.PlanRule):
        name = "plan-shape"                    # collides

    with pytest.raises(ValueError, match="already registered"):
        PL.register_plan_rule(Dummy())
    with pytest.raises(KeyError, match="unknown plan rule"):
        PL.unregister_plan_rule("no-such-rule")
    assert "plan-schedule-dag" in PL.list_plan_rules()
    # the reference's twelve, in its order, then the DevicePlan's port
    # rule and the compact plans' five
    assert PL.list_plan_rules() == RL.list_plan_rules() + (
        "device-tile-local", "forest-shape", "forest-producers",
        "forest-gathers", "sparse-forest", "plan-forest-agreement")
    assert [r for r in PL.list_plan_rules()
            if PL.get_plan_rule(r).guards_kernel] == [
        "device-tile-local", "forest-shape", "sparse-forest"]


# -- lint_plans driver -------------------------------------------------------

def test_lint_plans_clean_beside_the_reference(cache):
    """``engine_torch`` gives the reference's ``engine_jit`` artifact labels
    and no finding; ``engine_cuda`` adds its T = 16 SparseForestPlan;
    ``int_dot`` is skipped. Under a mesh, the lowering is placed before
    it is verified (two ranks: still clean, the ``device`` artifact's
    leaves replicated DTensors); the lint CLI refuses a ``model`` axis,
    naming A10.2."""
    ref_report, ref_findings = RL.lint_plans(["engine_jit"])
    report, findings = PL.lint_plans(["engine_torch", "engine_cuda",
                                      "int_dot"], device="cpu")
    assert ref_findings == [] and findings == [], \
        [f.format() for f in findings]
    assert report[0]["artifacts"] == ref_report[0]["artifacts"]
    assert report[1]["artifacts"] == ref_report[0]["artifacts"][:-1] + [
        "device-sparse", "bundle-roundtrip"]
    assert "skipped" in report[2]
    from _mesh_ranks import lint_plans_on_mesh
    from repro_torch.launch.mesh import run_ranks
    for rank in run_ranks(2, lint_plans_on_mesh, "data=2", threads=1):
        assert rank["findings"] == []
        assert rank["artifacts"] == [r["artifacts"] for r in report[:2]]
        assert rank["placed"] == [("R",)]
    from repro_torch.analysis.lint import main as lint_main
    with pytest.raises(SystemExit) as e:
        lint_main(["--plans", "--mesh", "data=2,model=2", "--device", "cpu"])
    assert e.value.code == 2


# -- the forest rules' corpus ------------------------------------------------

# (T, N, K, groups, stacked): ForestPlans to T = 15, SparseForestPlans from
# T = 16
FOREST_CFGS = {"T4": (4, 8, 16, 1, False), "T8-G2": (8, 16, 64, 2, False),
               "T8-stacked": (8, 16, 32, 1, True),
               "T12": (12, 16, 48, 1, False)}
SPARSE_CFGS = {"T16-G2": (16, 24, 64, 2, False),
               "T16-stacked": (16, 12, 32, 1, True)}


def _build(cfg):
    """(the compact plan of ``engine_cuda``, the entry corrupted (``()`` or
    ``(1,)``), the weight of that entry, its ExecutionPlan)."""
    t, n, k, g, stacked = cfg
    ws = [_w(t + n + i, (n, k)) for i in range(1 + stacked)]
    plans = [PE.BatchedTransitiveEngine(4, t).plan(w, groups=g) for w in ws]
    b = get_backend("engine_cuda")
    fp = b.compile(plans if stacked else plans[0])
    return fp, ((1,) if stacked else ()), ws[-1], plans[-1]


@pytest.fixture(scope="module")
def forests():
    return {name: _build(cfg) for name, cfg in
            {**FOREST_CFGS, **SPARSE_CFGS}.items()}


def _exact(w, x, g):
    n, k = w.shape
    if g == 1:
        return w @ x
    return np.einsum("ngk,gkm->ngm", w.reshape(n, g, k // g),
                     x.reshape(g, k // g, x.shape[1]))


def _plain(fp, x):
    run = (PE.sparse_forest_plain if isinstance(fp, PE.SparseForestPlan)
           else PE.forest_plan_plain)
    return run(fp, torch.from_numpy(x)).numpy()


def _made(prod, t):
    """Per tile: (the made nonzero nodes, the nodes other nodes are made
    from)."""
    out = []
    for p in prod.astype(np.int64):
        chained = np.flatnonzero(p < t)
        made = set(np.flatnonzero(p != PE.FOREST_UNUSED).tolist()) - {0}
        out.append((made, set((chained ^ (1 << p[chained])).tolist()) - {0}))
    return out


def _first_nonzero_gather(rows, j):
    s, n = np.argwhere(rows[j] != 0)[0]
    return int(s), int(n)


def _forest_fault(case, fp, e):
    """The corrupted copy of ForestPlan ``fp`` (entry ``e``) for ``case``."""
    t = fp.t
    prod = fp.producer.numpy().copy()
    rows = fp.rows.numpy().copy()
    p, r = prod[e], rows[e]                    # views into the copies
    made = _made(p, t)
    gathered = [set(np.unique(r[j]).tolist()) - {0}
                for j in range(r.shape[0])]
    if case == "shape":
        return dataclasses.replace(fp, rows=fp.rows[..., :-1].contiguous())
    if case == "dtype":
        bad = copy.copy(fp)
        object.__setattr__(bad, "rows", fp.rows.to(torch.int32))
        return bad
    j = 0
    if case == "node0_produced":
        p[j, 0] = PE.FOREST_DIRECT
    elif case == "bad_code":
        p[j, min(gathered[j])] = 100
    elif case == "bit_not_held":
        v = next(v for v in sorted(gathered[j]) if v != (1 << t) - 1)
        p[j, v] = next(b for b in range(t) if not (v >> b) & 1)
    elif case == "unused_prefix":
        j, pre = next((jj, min(m[1])) for jj, m in enumerate(made) if m[1])
        p[j, pre] = PE.FOREST_UNUSED
    elif case == "unused_gathered":
        j, v = next((jj, min(g - made[jj][1])) for jj, g in
                    enumerate(gathered) if g - made[jj][1])
        p[j, v] = PE.FOREST_UNUSED
    elif case == "rows_past_table":
        s, n = _first_nonzero_gather(r, j)
        r[j, s, n] = 1 << t
    elif case == "rows_unmade":
        s, n = _first_nonzero_gather(r, j)
        r[j, s, n] = min(set(range(1, 1 << t)) - made[j][0])
    elif case == "rows_swapped":
        s, n1 = _first_nonzero_gather(r, j)
        n2 = int(np.flatnonzero(r[j, s] != r[j, s, n1])[0])
        r[j, s, [n1, n2]] = r[j, s, [n2, n1]]
    return dataclasses.replace(fp, producer=torch.from_numpy(prod),
                               rows=torch.from_numpy(rows))


def _sparse_fault(case, sp, e):
    """The corrupted copy of SparseForestPlan ``sp`` (entry ``e``)."""
    t = sp.t
    codes = sp.codes.numpy().copy()
    bounds = sp.bounds.numpy().copy()
    rows = sp.rows.numpy().copy()
    c, bd, r = codes[e], bounds[e], rows[e]
    j = 0
    lv = next(lv for lv in range(2, t + 1) if bd[j, lv] > bd[j, lv - 1])
    first = int(bd[j, lv - 1])                 # first slot of level lv
    if case == "shape":
        return dataclasses.replace(sp, bounds=sp.bounds[..., :-1].contiguous())
    if case == "prefix_same_level":
        c[j, first] = first                    # its own slot, bit 0
    elif case == "direct_off_level":
        c[j, first] = np.int64(PE.SPARSE_DIRECT | 1).astype(
            np.uint32).view(np.int32)
    elif case == "bounds_end":                 # the last made slot drops
        bd[j, bd[j] == bd[j, -1]] -= 1         # out of every level
    elif case == "rows_past_made":
        s, n = _first_nonzero_gather(r, j)
        r[j, s, n] = bd[j, -1]
    elif case == "rows_swapped":
        s, n1 = _first_nonzero_gather(r, j)
        n2 = int(np.flatnonzero(r[j, s] != r[j, s, n1])[0])
        r[j, s, [n1, n2]] = r[j, s, [n2, n1]]
    return dataclasses.replace(sp, codes=torch.from_numpy(codes),
                               bounds=torch.from_numpy(bounds),
                               rows=torch.from_numpy(rows))


# case -> (the rule that must catch it, whether it is a content corruption
# whose effect on the GEMM the plain version shows). node0_produced is a
# contract check only: node 0 is the empty sum, and neither the kernel nor
# its plain version visits level 0.
FOREST_CASES = {
    "shape": ("forest-shape", False), "dtype": ("forest-shape", False),
    "node0_produced": ("forest-producers", False),
    "bad_code": ("forest-producers", True),
    "bit_not_held": ("forest-producers", True),
    "unused_prefix": ("forest-producers", True),
    "unused_gathered": ("forest-gathers", True),
    "rows_past_table": ("forest-gathers", True),
    "rows_unmade": ("forest-gathers", True),
    "rows_swapped": ("plan-forest-agreement", True),
}
SPARSE_CASES = {
    "shape": ("forest-shape", False),
    "prefix_same_level": ("sparse-forest", True),
    "direct_off_level": ("sparse-forest", True),
    "bounds_end": ("sparse-forest", True),
    "rows_past_made": ("sparse-forest", True),
    "rows_swapped": ("plan-forest-agreement", True),
}


def _corpus():
    out = []
    for name, cfg in FOREST_CFGS.items():
        for case in FOREST_CASES:
            # uint8 rows cannot hold 2^8; agreement needs an unstacked plan
            if (case == "rows_past_table" and cfg[0] == 8) or (
                    case == "rows_swapped" and cfg[4]):
                continue
            out.append((name, case))
    for name, cfg in SPARSE_CFGS.items():
        for case in SPARSE_CASES:
            if not (case == "rows_swapped" and cfg[4]):
                out.append((name, case))
    return out


@pytest.mark.parametrize("cfg, case", _corpus())
def test_forest_rule_catches_its_corruption(forests, cfg, case):
    """Each corruption of ``engine_cuda``'s compact plan gives exactly one
    finding of the rule that guards it (with the host plan supplied where
    the plan is unstacked); each content corruption makes the plain
    version differ from the exact integer GEMM, which the clean plan
    equals."""
    fp, e, w, plan = forests[cfg]
    sparse = isinstance(fp, PE.SparseForestPlan)
    rule, content = (SPARSE_CASES if sparse else FOREST_CASES)[case]
    host = None if e else plan
    assert PL.verify_device_plan(fp, host) == []
    bad = (_sparse_fault if sparse else _forest_fault)(case, fp, e)
    _one(PL.verify_device_plan(bad, host), rule)
    if content:
        x = np.random.default_rng(5).integers(-128, 128, size=(fp.k, 3))
        want = _exact(w, x, fp.groups)
        entry = (lambda f: f.index(e[0])) if e else (lambda f: f)
        np.testing.assert_array_equal(_plain(entry(fp), x), want)
        assert not np.array_equal(_plain(entry(bad), x), want)


def test_gate_device_refuses_what_the_forest_plan_admits(forests):
    """A ForestPlan whose dtypes, contiguity and device are sound (its own
    ``__post_init__`` admits it) but which gathers a node it never makes
    is refused by ``gate_device`` with ``forest-gathers``."""
    fp, e, _, _ = forests["T8-G2"]
    PL.gate_device(fp, where="anywhere")
    bad, _, _ = _corrupt_forest(fp)
    bad.__post_init__()
    with pytest.raises(PlanVerificationError, match="forest-gathers"):
        PL.gate_device(bad, where="anywhere")


def _cross_tile(dev):
    """A copy of an int32 DevicePlan whose first executed lane adds an
    activation row of another tile (in range, the identity contract
    kept): not tile-local, and past every reference rule without the
    host plan."""
    t, size = dev.t, 1 << dev.t
    lx = dev.level_xsrc.clone()
    flat = lx.reshape(-1, lx.shape[-1])
    lv, r = (int(i) for i in torch.nonzero(flat != dev.k)[0])
    tile = r // size
    flat[lv, r] = ((tile + 1) % (dev.k // t)) * t
    return dataclasses.replace(dev, level_xsrc=lx)


@pytest.mark.parametrize("case", ["int64_leaf", "cross_tile",
                                  "cross_tile_stacked"])
def test_device_tile_local_catches_its_corruption(case):
    """``device-tile-local`` holds a DevicePlan to what the packers and
    kernels read: int32 leaves and tile-local edges. Each corruption gives
    exactly its one finding; the reference's rules pass the cross-tile
    plan, and the sparse packer refuses it."""
    w = _w(6, (16, 32))
    plan = PE.BatchedTransitiveEngine(4, 8).plan(w)
    dev = PE.compile_plan(plan)
    if case == "int64_leaf":
        bad = dataclasses.replace(dev, signs=dev.signs.to(torch.int64))
        _one(PL.verify_device_plan(bad), "device-tile-local", "signs")
        return
    stacked = case.endswith("stacked")
    if stacked:
        dev = PE.compile_plans([plan, plan])
    bad = _cross_tile(dev)
    assert PL.verify_device_plan(dev) == []
    _one(PL.verify_device_plan(bad), "device-tile-local", "tile_local")
    rbad = RE.DevicePlan(**{
        **{f: getattr(bad, f) for f in ("t", "bits", "n", "k", "groups")},
        **{f: a.numpy() for f, a in bad.leaves().items()}})
    assert RL.verify_device_plan(rbad) == []
    if not stacked:
        flagged = dataclasses.replace(bad, tile_local=True)
        with pytest.raises(ValueError):
            PE.pack_sparse_forest_plan(flagged)


def _cut_rows(tree):
    """A stacked ForestPlan whose rows lost their last output column
    (contiguous, the right dtype: only its shape is wrong)."""
    if isinstance(tree, PE.ForestPlan):
        return dataclasses.replace(tree,
                                   rows=tree.rows[..., :-1].contiguous())
    return tree


def _cross_tile_tree(tree):
    return _cross_tile(tree) if isinstance(tree, PE.DevicePlan) else tree


@pytest.mark.parametrize("backend, rule", [
    ("engine_torch", "device-tile-local"), ("engine_cuda", "forest-shape")])
def test_kernel_guards_run_with_the_switch_off(cache, ref_raw, monkeypatch,
                                               tmp_path, backend, rule):
    """``REPRO_PLANLINT=0`` turns the verifier off, not the checks a
    kernel's raw-pointer reads rely on: at swap staging and at bundle
    load a plan that breaks a ``guards_kernel`` rule is refused all the
    same (nothing staged), while a content fault the other rules catch
    passes, as the gates are off."""
    model = Model(_cfg(backend), device="cpu")
    raw = params_from_reference(ref_raw[1][0], "cpu")
    gen0 = build_generation(model, raw, gen=0)
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=16,
                      page_size=4, device="cpu")
    bdir = str(tmp_path / "b")
    PBundles.write_bundles(raw, model.cfg.quant, bdir)
    monkeypatch.setenv("REPRO_PLANLINT", "0")
    corrupt = _cross_tile_tree if backend == "engine_torch" else _cut_rows
    with pytest.raises(PlanVerificationError) as ei:
        eng.swap_params(_corrupt_params(gen0.params, corrupt))
    assert ei.value.where == "swap-staging"
    _one(ei.value.findings, rule)
    assert eng.stats()["swaps_staged"] == 0
    if backend == "engine_cuda":           # content: the gates are off
        eng.swap_params(_corrupt_params(gen0.params, _unused_gathered_node))
        assert eng.stats()["swaps_staged"] == 1
        b = get_backend(backend)
        real = type(b).lower
        monkeypatch.setattr(type(b), "lower", lambda self, d, device=None:
                            _cut_rows(real(self, d, device=device)))
    else:
        real = PBundles._stack
        monkeypatch.setattr(PBundles, "_stack", lambda devices, lead:
                            _cross_tile(real(devices, lead)))
    with pytest.raises(PlanVerificationError) as ei:
        load_bundles(raw, model.cfg.quant, bdir)
    assert ei.value.where == "bundle-load"
    _one(ei.value.findings, rule)


# -- the launcher's --lint ---------------------------------------------------

SMALL = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
         "--prompt-len", "8", "--gen", "4", "--page-size", "4",
         "--continuous"]


def _tokens(eng):
    return {r.rid: r.tokens for r in eng.finished}


@pytest.mark.parametrize("backend", PLANNED)
def test_lint_preflight_serves_with_zero_findings(capsys, backend):
    """``--lint`` lints the backend's serving programs and verifies its
    plan artifacts before serving, prints zero findings for both halves,
    and the served tokens equal the run without it."""
    toks = []
    for extra in ([], ["--lint"]):
        prev = set_default_cache(PlanCache())
        try:
            toks.append(_tokens(serve.main(SMALL + ["--backend", backend]
                                           + extra)))
        finally:
            set_default_cache(prev)
    out = capsys.readouterr().out
    assert f"[planlint] preflight {backend}: 0 finding(s)" in out
    assert f"[tracelint] preflight {backend}: 0 finding(s)" in out
    assert toks[0] == toks[1]


def test_lint_preflight_refuses_on_an_error_finding(capsys, monkeypatch):
    rule = PL.get_plan_rule("plan-direct-pattern")
    monkeypatch.setattr(type(rule), "check", lambda self, art: [
        self._finding(art, "forced", path="direct_bits")])
    with pytest.raises(SystemExit) as e:
        serve.main(SMALL + ["--backend", "engine_torch", "--lint"])
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert "[planlint] [error] plan-direct-pattern" in captured.out
    assert "serve refused" in captured.err
