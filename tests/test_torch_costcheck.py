"""Port parity: the static cost certifier (``repro_torch.analysis.costcheck``
and its ``budgets.json``) and the baseline format against
``repro.analysis``.

The plan half (``plan_cost``, ``crosscheck_costmodel``), the budget file
loader and the baseline file are host code: they are held equal to the
reference's on the same inputs. The trace half is held by its controls:
the oracle paged decode's pool reads grow with ``max_len`` (it fails the
live-page budget by construction), the forest's level loop is
scatter-free, and the packed decode keeps one signature across an
aligned hot swap and two across a widened one.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import repro.analysis.baseline as RB  # noqa: E402
import repro.analysis.costcheck as RC  # noqa: E402
import repro.analysis.rules as RR  # noqa: E402
import repro.core.engine as RE  # noqa: E402
from repro_torch.analysis import baseline as PB  # noqa: E402
from repro_torch.analysis import costcheck as C  # noqa: E402
from repro_torch.analysis import rules as R  # noqa: E402
from repro_torch.analysis import walker as W  # noqa: E402
from repro_torch.analysis.programs import build_programs  # noqa: E402
import repro_torch.core.engine as PE  # noqa: E402

# (bits, t, groups, shape): several T, groupings and shapes
CASES = [(4, 4, 1, (8, 16)), (4, 8, 1, (16, 32)), (8, 4, 2, (12, 32)),
         (4, 8, 4, (24, 64)), (2, 2, 1, (5, 6)), (8, 6, 1, (7, 36))]


def _w(seed, shape, bits):
    hi = 1 << (bits - 1)
    return np.random.default_rng(seed).integers(-hi, hi, shape)


def _plans(case, seed=0):
    bits, t, groups, shape = case
    w = _w(seed, shape, bits)
    ref = RE.BatchedTransitiveEngine(bits=bits, t=t).plan(w, groups=groups)
    ours = PE.BatchedTransitiveEngine(bits=bits, t=t).plan(w, groups=groups)
    return ref, ours


@pytest.mark.parametrize("case", CASES)
def test_plan_cost_equals_the_reference(case):
    ref, ours = _plans(case)
    want = RC.plan_cost(ref)
    assert C.plan_cost(ours) == want
    assert C.plan_cost(ref) == want          # the same arithmetic


@pytest.mark.parametrize("case", CASES)
def test_crosscheck_costmodel_clean_on_real_plans(case):
    ref, ours = _plans(case, seed=1)
    assert RC.crosscheck_costmodel(ref) == []
    assert C.crosscheck_costmodel(ours, backend="engine_torch") == []


def _as_dict(findings):
    return [dataclasses.asdict(f) for f in findings]


@pytest.mark.parametrize("corrupt", ["drop-level", "direct-bit",
                                     "plane-count"])
def test_crosscheck_costmodel_findings_equal_the_reference(corrupt):
    """The same corruption of both packages' plans gives equal findings:
    the PPE count (a level dropped, a direct lane added) or the APE
    count (one weight plane more than the scoreboard saw)."""
    ref, ours = _plans((4, 4, 1, (8, 16)), seed=2)

    def broken(plan):
        if corrupt == "drop-level":
            return dataclasses.replace(plan, steps=plan.steps[:-1])
        if corrupt == "direct-bit":          # a direct lane more
            extra = np.ones((1, plan.t), dtype=plan.direct_bits.dtype)
            return dataclasses.replace(plan, direct_bits=np.concatenate(
                [plan.direct_bits, extra]))
        return dataclasses.replace(plan, bits=plan.bits + 1)

    want = RC.crosscheck_costmodel(broken(ref), backend="b", name="p")
    got = C.crosscheck_costmodel(broken(ours), backend="b", name="p")
    assert want and _as_dict(got) == _as_dict(want)


def test_budgets_hold_the_reference_four():
    ref = RC.load_budgets()["budgets"]
    ours = C.load_budgets()["budgets"]
    assert [(b["name"], b["program"], b["metric"], b["max"]) for b in ours] \
        == [(b["name"], b["program"], b["metric"], b["max"]) for b in ref]
    pinned = {b["name"]: b["backend"] for b in ours}
    assert pinned == {"live-page-decode": None,
                      "swap-trace-count": "engine_torch",
                      "forest-scatter-in-loop": None,
                      "decode-while-free": None}
    assert {b["name"]: b["backend"] for b in ref}["swap-trace-count"] == \
        "engine_jit"
    assert all("Port:" in b["note"] for b in ours)
    assert [f.name for f in dataclasses.fields(C.CostMetrics)] == \
        [f.name for f in dataclasses.fields(RC.CostMetrics)]


@pytest.mark.parametrize("doc", [
    {"format": 2, "budgets": []},
    {"budgets": []},
    {"format": 1, "budgets": [{"name": "x", "program": "decode",
                               "metric": "eqns"}]},
    {"format": 1, "budgets": [{"max": 1}]},
])
def test_load_budgets_refuses_bad_files_like_the_reference(tmp_path, doc):
    p = tmp_path / "budgets.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as want:
        RC.load_budgets(str(p))
    with pytest.raises(ValueError) as got:
        C.load_budgets(str(p))
    assert str(got.value) == str(want.value)


def test_peak_live_bytes_follows_storage_lifetimes():
    def f(x):
        y = x * 2.0            # x dies after its last use
        z = y + 1.0
        return z.view(2, 2)    # a view: no new storage

    trace = W.record(f, torch.ones(4))
    m = C.trace_cost(trace)
    assert m.eqns == 3 and m.peak_live_bytes == 2 * 16
    # a storage that outlives its last use because the result holds it
    assert C.trace_cost(W.record(lambda x: (x * 2.0, x + 1.0),
                                 torch.ones(4))).peak_live_bytes == 3 * 16


def test_pool_gathers_and_growth_fail_the_oracle_by_construction():
    """The oracle paged decode gathers every slot's whole page extent:
    doubling max_len doubles its pool reads (> the 1.25 budget)."""
    ratio, values = C.growth_ratio("int_dot", "paged-decode",
                                   "pool_gather_bytes", device="cpu")
    assert ratio > 1.25, values
    lo = values["max_len=16"]
    assert lo > 0 and values["max_len=32"] == 2 * lo
    (prog,) = build_programs("int_dot", device="cpu",
                             programs=("paged-decode",))
    m = C.program_metrics(prog)
    assert m.pool_gathers == 4 * 2           # k, v, ks, vs in 2 layers
    assert m.pool_gather_bytes == lo and m.gathers > m.pool_gathers
    assert m.while_loops == 0 and m.scatter_in_loop == 0
    with pytest.raises(C.NotBuilt, match="B2 kernel"):
        C.growth_ratio("int_dot", "paged-attention", "pool_gather_bytes",
                       device="cpu")


def test_forest_scatter_in_loop_reads_zero_on_engine_torch():
    (prog,) = build_programs("engine_torch", device="cpu",
                             programs=("forest",))
    m = C.program_metrics(prog)
    assert m.scatter_in_loop == 0 and m.scatter_in_loop_dynamic == 0
    assert m.scatters == 1                 # the direct dispatch, outside
    assert m.gathers_dynamic == m.gathers > 0


@pytest.mark.parametrize("aligned,want", [(True, 1), (False, 2)])
def test_swap_trace_count(aligned, want):
    assert C.swap_trace_count(backend="engine_torch", device="cpu",
                              aligned=aligned) == want


def test_check_budgets_reports_skips_never_findings():
    report, findings = C.check_budgets(["lut_cuda"], device="cpu")
    assert findings == []
    rows = {r["budget"]: r for r in report}
    assert rows["swap-trace-count"]["skipped"] == \
        "budget pinned to engine_torch"
    assert "B2 kernel" in rows["live-page-decode"]["skipped"]
    assert rows["decode-while-free"]["ok"] and \
        rows["decode-while-free"]["value"] == 0
    assert rows["forest-scatter-in-loop"]["skipped"] == \
        "backend builds no such program"


def test_check_budgets_finding_on_an_exceeded_budget(tmp_path):
    doc = {"format": 1, "budgets": [{
        "name": "oracle-live-pages", "backend": None,
        "program": "paged-decode", "metric": "pool_gather_bytes_growth",
        "max": 1.25}]}
    p = tmp_path / "b.json"
    p.write_text(json.dumps(doc))
    report, findings = C.check_budgets(["int_dot"], device="cpu",
                                       budgets_path=str(p))
    assert len(findings) == 1 and findings[0].rule == "cost-budget"
    assert findings[0].key() == \
        "cost-budget::int_dot::paged-decode::oracle-live-pages"
    assert report[0]["ok"] is False and report[0]["value"] > 1.25


def test_check_budgets_holds_kernel_pool_reads_by_behaviour(tmp_path,
                                                           monkeypatch):
    """A pool-traffic budget over a program whose pool reads are a kernel
    site is reported held by behaviour: no value, no pass, no finding."""
    pool = {"k": torch.zeros(64, 4)}

    def step(p, table):
        out = torch.empty(2, 4)
        W.note_launch("B2.stub", (p["k"], table), (out,))
        return out

    def fake_program(backend, program, **kw):
        return R.LintProgram(
            name=program, rules=(), backend=backend,
            trace=W.record(step, pool, torch.zeros(2, dtype=torch.int32)),
            donate_expect={"kv-page-pool": {"[0].k": pool["k"]}})
    monkeypatch.setattr(C, "_program", fake_program)
    doc = {"format": 1, "budgets": [{
        "name": "live-page-decode", "backend": None,
        "program": "paged-attention", "metric": "pool_gather_bytes_growth",
        "max": 1.25}]}
    p = tmp_path / "b.json"
    p.write_text(json.dumps(doc))
    report, findings = C.check_budgets(["int_dot"], device="cpu",
                                       budgets_path=str(p))
    assert findings == []
    (row,) = report
    assert "value" not in row and "ok" not in row
    assert row["held_by"].startswith("kernel site kernel:B2 reads the pool")
    assert "phase 21c" in row["held_by"]
    assert C.pool_kernel_reads(fake_program("int_dot", "x")) == \
        ["kernel:B2"]


def test_baseline_files_load_across_packages(tmp_path):
    kw = dict(rule="no-host-callback", severity="error", program="decode",
              backend="engine_cuda", path="7:aten._local_scalar_dense",
              primitive="aten._local_scalar_dense", message="m")
    ref_file, port_file = tmp_path / "ref.txt", tmp_path / "port.txt"
    assert RB.save_baseline(str(ref_file), [RR.Finding(**kw)]) == 1
    assert PB.save_baseline(str(port_file), [R.Finding(**kw)]) == 1
    assert ref_file.read_text() == port_file.read_text()
    keys = PB.load_baseline(str(ref_file))
    assert RB.load_baseline(str(port_file)) == keys
    new, suppressed = PB.split_baselined([R.Finding(**kw)], keys)
    assert new == [] and len(suppressed) == 1
    assert PB.stale_keys(RB.load_baseline(str(port_file)), []) == \
        sorted(keys)
