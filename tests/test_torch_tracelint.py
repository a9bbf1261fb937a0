"""Port parity: the program half of the analysis
(``repro_torch.analysis``: walker, rules, programs, lint CLI) against
``repro.analysis`` and ``tests/test_analysis.py``, case for case.

The reference's tracelint walks jaxprs, which this container's JAX
cannot build (its walker reaches ``jax.core.ClosedJaxpr``), so the rules
are held here by positive and clean controls: each rule fires on a
hand-built bad function and stays silent on a clean one, and every
backend's serving programs lint clean on the CPU. ``Finding`` keys, rule
names and their order are held equal to the reference's.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import repro.analysis.rules as RR  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import rules as R  # noqa: E402
from repro_torch.analysis import walker as W  # noqa: E402
from repro_torch.analysis.baseline import (load_baseline,  # noqa: E402
                                           save_baseline, split_baselined,
                                           stale_keys)
from repro_torch.analysis.lint import main  # noqa: E402
from repro_torch.analysis.programs import (KERNEL_ONLY,  # noqa: E402
                                           build_programs, lint_backend)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backend import get_backend, list_backends  # noqa: E402
from repro_torch.models.attention import rope  # noqa: E402

BACKENDS = ("int_dot", "lut", "lut_cuda", "engine_torch", "engine_cuda")
PROGRAMS = ["prefill", "decode", "paged-decode", "paged-decode-swapped",
            "paged-attention", "prefill-bucketed", "forest"]


def _item(x):
    return x * float(x.sum().item())


# -- registry ----------------------------------------------------------------

class _DummyRule(R.Rule):
    name = "dummy-test-rule"
    description = "registry test fixture"

    def check(self, prog):
        return []


def test_registry_duplicate_is_loud_and_replace_works():
    r1, r2 = _DummyRule(), _DummyRule()
    R.register_rule(r1)
    try:
        with pytest.raises(ValueError, match="already registered"):
            R.register_rule(r2)
        assert R.register_rule(r2, replace=True) is r2
        assert R.get_rule("dummy-test-rule") is r2
    finally:
        R.unregister_rule("dummy-test-rule")
    assert "dummy-test-rule" not in R.list_rules()


def test_registry_unknown_names_list_registry():
    with pytest.raises(KeyError, match="no-host-callback"):
        R.get_rule("no-such-rule")
    with pytest.raises(KeyError, match="registered rules"):
        R.unregister_rule("no-such-rule")


def test_rule_must_declare_name():
    class Nameless(R.Rule):
        def check(self, prog):
            return []
    with pytest.raises(ValueError, match="name"):
        R.register_rule(Nameless())


def test_builtin_rules_all_registered_in_the_reference_order():
    assert R.list_rules() == RR.list_rules() == (
        "no-host-callback", "gather-only-levels", "static-shapes",
        "kv-donation", "dtype-purity", "sharding-integrity")
    assert R.get_rule("sharding-integrity").requires == "arrays"


def test_finding_key_format_and_json_equal_the_reference():
    kw = dict(rule="no-host-callback", severity="error", program="decode",
              backend="int_dot", path="3:aten._local_scalar_dense",
              primitive="aten._local_scalar_dense", message="m")
    ours, ref = R.Finding(**kw), RR.Finding(**kw)
    assert ours.key() == ref.key()
    assert ours.format() == ref.format()
    assert ours.to_json() == ref.to_json()
    bare = dict(kw, backend=None, path="", primitive=None)
    assert R.Finding(**bare).key() == RR.Finding(**bare).key()


# -- walker ------------------------------------------------------------------

def test_walker_paths_and_loop_membership():
    def f(x):
        for _ in range(3):
            with W.scope("level", loop=True):
                x = x.index_select(0, torch.arange(4)) * 2
        return x + 1

    trace = W.record(f, torch.ones(4))
    in_loop = [s for s in trace if s.in_loop]
    assert len(in_loop) >= 6 and all(s.path.startswith("level/")
                                     for s in in_loop)
    top = [s for s in trace if not s.in_loop]
    assert top and all("/" not in s.path for s in top)
    # paths are op-indexed: "<index>:<op packet>", scopes in front
    assert [int(s.path.split("/")[-1].split(":")[0]) for s in trace] == \
        list(range(len(trace)))
    sel = next(s for s in trace if s.packet == "aten.index_select")
    assert sel.path.endswith(":aten.index_select")
    assert sel.op == "aten.index_select.default"
    assert sel.inputs[0].shape == (4,) and sel.outputs[0].dtype == \
        torch.float32 and sel.outputs[0].device.type == "cpu"


def test_walker_inherits_scopes_and_keeps_storages():
    def f(x):
        with W.scope("quantize_kv"):
            with W.scope("level", loop=True):
                y = x * 2.0
            z = y.view(2, 2)
        return z + 1.0

    trace = W.record(f, torch.ones(4))
    mul, view, add = trace.sites
    assert mul.scopes == {"quantize_kv", "level"} and mul.in_loop
    assert view.scopes == {"quantize_kv"} and not view.in_loop
    assert not add.scopes and add.path == "2:aten.add"
    # a view shares its base's storage; an op writes a fresh one
    assert view.outputs[0].storage == mul.outputs[0].storage
    assert add.outputs[0].storage != mul.outputs[0].storage
    assert trace.args[0].storage_nbytes == 16


def test_scope_costs_nothing_outside_a_recorder():
    assert W.scope("a") is W.scope("b", loop=True)      # the null context
    with W.scope("a"):
        pass
    W.note_launch("B3.tgemm_lut", (torch.ones(2),), (torch.ones(2),))


def test_kernel_site_recorded_through_note_launch():
    """A ctypes launch is invisible to the dispatcher; the wrapper's
    note_launch makes it a site with its tensors' storages."""
    def stub_wrapper(qx, qw):
        out = torch.empty((qx.shape[0], qw.shape[0]), dtype=torch.int32)
        W.note_launch("B3.tgemm_lut", (qx, qw), (out,))   # a stub launch
        return out

    qx = torch.ones((4, 8), dtype=torch.int8)
    qw = torch.ones((3, 8), dtype=torch.int8)
    trace = W.record(stub_wrapper, qx, qw)
    assert [s.op for s in trace] == ["aten.empty.memory_format",
                                     "kernel:B3.tgemm_lut"]
    k = trace.sites[1]
    assert k.is_kernel and k.packet == "kernel:B3" and k.path == \
        "1:kernel:B3"
    assert [i.storage for i in k.inputs] == [
        qx.untyped_storage().data_ptr(), qw.untyped_storage().data_ptr()]
    assert k.outputs[0].storage == trace.sites[0].outputs[0].storage
    assert k.outputs[0].shape == (4, 3)


def test_spellings_caught_on_this_torch():
    """Each op spelling the sets name, checked against what this torch
    dispatches (``chip_smoke.py`` phase 21 checks the card's)."""
    report = W.spelling_report("cpu")
    assert {k for k, v in report.items() if not v["caught"]} == set(), report
    assert "aten.lift_fresh.default" in report["torch.tensor"]["ops"]
    assert "aten._local_scalar_dense.default" in report["item"]["ops"]
    assert "aten.gather.default" in report["take_along_dim"]["ops"]


def test_named_tensors_paths_follow_the_result():
    pool = {"body": {"c0": {"k": torch.zeros(2), "v": torch.zeros(2)}}}
    got = W.named_tensors((torch.ones(1), pool))
    assert list(got) == ["[0]", "[1].body.c0.k", "[1].body.c0.v"]
    assert got["[1].body.c0.k"] is pool["body"]["c0"]["k"]


# -- positive controls: each rule fires on a violating program ---------------

def test_control_no_host_callback_fires():
    found = analysis.find_violations(_item, torch.ones(4),
                                     rules=("no-host-callback",))
    assert found and found[0].primitive == "aten._local_scalar_dense"
    assert "aten._local_scalar_dense" in found[0].path
    fresh = analysis.find_violations(
        lambda x: x * torch.tensor(2.0), torch.ones(4),
        rules=("no-host-callback",))
    assert [f.primitive for f in fresh] == ["aten.lift_fresh"]
    assert "host data entering" in fresh[0].message
    assert analysis.find_violations(lambda x: x * 2.0, torch.ones(4),
                                    rules=("no-host-callback",)) == []


def test_control_gather_only_levels_fires_inside_loop_only():
    idx = torch.tensor([0])

    def scatter_in_loop(x):
        for _ in range(3):
            with W.scope("level", loop=True):
                x = x.index_put((idx,), x.sum()[None])
        return x

    found = analysis.find_violations(scatter_in_loop, torch.ones(4),
                                     rules=("gather-only-levels",))
    assert len(found) == 3 and found[0].rule == "gather-only-levels"
    assert found[0].primitive == "aten.index_put"
    assert found[0].path.startswith("level/")

    # the same scatter outside any loop is the legal direct dispatch
    assert analysis.find_violations(
        lambda x: x.index_put((idx,), x.sum()[None]), torch.ones(4),
        rules=("gather-only-levels",)) == []


def test_control_static_shapes_fires_on_value_dependent_shapes():
    found = analysis.find_violations(lambda x: torch.nonzero(x),
                                     torch.ones(4), rules=("static-shapes",))
    assert found and found[0].primitive == "aten.nonzero"
    mask = analysis.find_violations(lambda x: x[x > 0], torch.ones(4),
                                    rules=("static-shapes",))
    assert mask and mask[0].primitive == "aten.index"
    assert analysis.find_violations(lambda x: x.index_select(
        0, torch.arange(2)), torch.ones(4), rules=("static-shapes",)) == []


def test_control_static_shapes_fires_on_a_value_dependent_schedule():
    """The counterpart of a while: a second call of the same signature
    runs another op sequence."""
    def steps(x, n):
        for _ in range(int(n)):
            x = x * 2.0
        return x

    trace = W.record(steps, torch.ones(4), 2)
    found = analysis.find_violations(trace, rules=("static-shapes",),
                                     retrace=W.record(steps, torch.ones(4),
                                                      3))
    assert len(found) == 1 and "depends on input values" in found[0].message
    assert analysis.find_violations(
        trace, rules=("static-shapes",),
        retrace=W.record(steps, torch.full((4,), 5.0), 2)) == []


def test_control_kv_donation_fires_when_the_cache_is_copied():
    idx = torch.tensor([1])

    def copied(pool, row):
        return {"k": pool["k"].index_put((idx,), row)}     # a fresh buffer

    def in_place(pool, row):
        pool["k"].index_put_((idx,), row)
        return pool

    pool = {"k": torch.zeros((4, 8))}
    expect = {"kv-cache": {"k": pool["k"]}}
    found = analysis.find_violations(copied, pool, torch.ones(1, 8),
                                     rules=("kv-donation",),
                                     donate_expect=expect)
    assert {f.rule for f in found} == {"kv-donation"} and len(found) == 2
    assert "NOT updated in place" in found[0].message
    assert "as large as the whole leaf" in found[1].message
    assert analysis.find_violations(in_place, pool, torch.ones(1, 8),
                                    rules=("kv-donation",),
                                    donate_expect=expect) == []
    # reading a slice of the leaf into a tensor of the leaf's size is no
    # copy of it
    small = {"ks": torch.zeros((2, 4, 1))}
    assert analysis.find_violations(
        lambda p: (p["ks"][0] * torch.ones(8, 1, 1), p), small,
        rules=("kv-donation",),
        donate_expect={"kv-cache": {"[1].ks": small["ks"]}}) == []


def test_control_dtype_purity_fires_on_bf16_in_quantize_scope():
    def bad(x):
        with W.scope("quantize_kv"):
            scale = x.abs().amax(-1, keepdim=True).to(torch.bfloat16) / 127.
        return x / scale.to(torch.float32)

    found = analysis.find_violations(bad, torch.ones(4, 8),
                                     rules=("dtype-purity",))
    assert found and "quantize_kv" in found[0].message

    # the clean shape: cast INTO f32 first (attention._quantize_kv)
    def good(x):
        with W.scope("quantize_kv"):
            x32 = x.to(torch.float32)
            return x32 / (x32.abs().amax(-1, keepdim=True) / 127.)
    assert analysis.find_violations(
        good, torch.ones(4, 8, dtype=torch.bfloat16),
        rules=("dtype-purity",)) == []
    # bf16 arithmetic outside a quantize scope is model math
    assert analysis.find_violations(
        lambda x: x * 2, torch.ones(4, dtype=torch.bfloat16),
        rules=("dtype-purity",)) == []


def test_control_dtype_purity_f64_outside_the_exact_products_only():
    found = analysis.find_violations(lambda x: x.to(torch.float64) * 2.0,
                                     torch.ones(4), rules=("dtype-purity",))
    assert found and "float64" in found[0].message

    from repro_torch.core.backend import int_matmul
    from repro_torch.models.attention import _int_einsum
    a = torch.ones((2, 3), dtype=torch.int8)
    for fn in (lambda: int_matmul(a, a.T),
               lambda: _int_einsum("ik,jk->ij", a, a)):
        trace = W.record(fn)
        assert any(o.dtype == torch.float64 for s in trace
                   for o in s.outputs)                    # float64 inside
        assert analysis.find_violations(trace,
                                        rules=("dtype-purity",)) == []


class _Replicate:
    def __init__(self, replicated):
        self.replicated = replicated

    def is_replicate(self):
        return self.replicated


class _Leaf(torch.Tensor):
    pass


class _Mesh:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def _leaf(shape, replicated):
    t = torch.zeros(shape).as_subclass(_Leaf)
    t.placements = (_Replicate(replicated),)
    return t


def test_control_sharding_integrity_fires_on_replicated_cache():
    prog = R.LintProgram(
        name="decode", rules=("sharding-integrity",), mesh=_Mesh(4),
        arrays={"kv-cache": {"k": _leaf((4, 16, 64), True),
                             "v": _leaf((4, 16, 64), False)}})
    found = R.run_rules(prog)
    assert len(found) == 1 and found[0].rule == "sharding-integrity"
    assert found[0].path == "kv-cache.k"
    assert "fully replicated" in found[0].message
    prog.arrays = {"kv-cache": {"step": _leaf((4,), True)}}   # small: exempt
    assert R.run_rules(prog) == []
    prog.arrays = {"kv-cache": {"k": _leaf((4, 16, 64), True)}}
    prog.mesh = _Mesh(1)                 # nothing to shard over
    assert R.run_rules(prog) == []


# -- RoPE: the host copy the rule found, repaired ---------------------------

def _old_freqs(theta, rot_d, device="cpu"):
    exps = -torch.arange(0, rot_d, 2, dtype=torch.float32,
                         device=device) / rot_d
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


@pytest.mark.parametrize("arch", ["smollm_135m", "chatglm3_6b",
                                  "llama1_7b"])
def test_rope_frequencies_unchanged(arch):
    """The repaired RoPE (a Python base: aten.pow.Scalar) gives the old
    formula's frequencies and rotations bit for bit, with no host data
    entering; the old formula is what no-host-callback flags."""
    cfg = get_config(arch)
    hd = cfg.hd
    rot_d = hd // 2 if cfg.rope_2d else hd
    exps = -torch.arange(0, rot_d, 2, dtype=torch.float32) / rot_d
    assert torch.equal(torch.pow(float(cfg.rope_theta), exps),
                       _old_freqs(cfg.rope_theta, rot_d))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 3, hd), generator=g).to(cfg.dtype)
    pos = torch.arange(5).expand(2, 5) + 1000
    trace = W.record(rope, x, pos, cfg.rope_theta, cfg.rope_2d)
    assert analysis.find_violations(trace, rules=("no-host-callback",)) \
        == []
    old = analysis.find_violations(_old_freqs, cfg.rope_theta, rot_d,
                                   rules=("no-host-callback",))
    assert [f.primitive for f in old] == ["aten.lift_fresh"]


# -- public surface ----------------------------------------------------------

def test_assert_clean_passes_and_raises_with_location():
    analysis.assert_clean(lambda x: x * 2, torch.ones(4))
    with pytest.raises(AssertionError, match="no-host-callback") as ei:
        analysis.assert_clean(_item, torch.ones(4))
    assert "aten._local_scalar_dense" in str(ei.value)
    assert ":aten._local_scalar_dense" in str(ei.value)       # the path


def test_assert_clean_baseline_suppresses():
    found = analysis.find_violations(_item, torch.ones(4))
    analysis.assert_clean(_item, torch.ones(4),
                          baseline=tuple(f.key() for f in found))


def test_find_violations_rejects_args_with_ready_trace():
    trace = W.record(lambda x: x + 1, torch.ones(4))
    with pytest.raises(TypeError, match="OpTrace"):
        analysis.find_violations(trace, torch.ones(4))


def test_baseline_roundtrip(tmp_path):
    found = analysis.find_violations(_item, torch.ones(4))
    p = tmp_path / "lint_baseline.txt"
    n = save_baseline(str(p), found)
    assert n == len({f.key() for f in found})
    loaded = load_baseline(str(p))
    new, suppressed = split_baselined(found, loaded)
    assert new == [] and suppressed == found
    p.write_text("# comment\n\n" + found[0].key() + "\n")
    assert load_baseline(str(p)) == {found[0].key()}
    with pytest.raises(FileNotFoundError):
        load_baseline(str(tmp_path / "missing.txt"))
    assert load_baseline(None) == frozenset()


def test_run_rules_honors_exemption_and_skips_missing_evidence():
    prog = R.LintProgram(name="decode",
                         rules=("no-host-callback", "kv-donation"),
                         trace=W.record(_item, torch.ones(4)))
    # kv-donation silently skipped (no donate_expect); the sync found
    assert [f.rule for f in R.run_rules(prog)] == ["no-host-callback"]
    assert R.run_rules(prog, exempt=frozenset({"no-host-callback"})) == []
    assert R.run_rules(prog, only=("kv-donation",)) == []
    prog.skipped = "not built here"
    assert R.run_rules(prog) == []


def test_backends_declare_no_exemption():
    """The reference's one exemption belongs to its host ``engine``
    oracle, which the port does not have."""
    assert set(BACKENDS) == set(list_backends())
    for name in BACKENDS:
        assert get_backend(name).lint_exempt == frozenset()


def test_a_sync_cannot_hide_behind_an_autograd_function():
    """The counterpart of the reference's custom_jvp / custom_vjp
    controls: the dispatcher sees inside an autograd.Function."""
    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * float(x.max())

        @staticmethod
        def backward(ctx, g):
            return g

    found = analysis.find_violations(lambda x: Scaled.apply(x) + 1.0,
                                     torch.ones(4),
                                     rules=("no-host-callback",))
    assert found and found[0].primitive == "aten._local_scalar_dense"


@pytest.mark.parametrize("backend", BACKENDS)
def test_lint_backend_end_to_end_clean(backend):
    """Every backend's whole program set lints clean on the CPU;
    paged-attention is listed as skipped there, with its reason."""
    progs, findings = lint_backend(backend, device="cpu", n_layers=1,
                                   batch=2)
    names = [p.name for p in progs]
    assert names == (PROGRAMS if backend.startswith("engine")
                     else PROGRAMS[:-1])
    skipped = {p.name: p.skipped for p in progs if p.skipped}
    assert skipped == {"paged-attention": KERNEL_ONLY}
    assert findings == [], [f.format() for f in findings]
    for p in progs:
        if not p.skipped:
            assert len(p.trace) and len(p.retrace) == len(p.trace)


def test_forest_level_loop_is_gather_only_on_engine_torch():
    (prog,) = build_programs("engine_torch", device="cpu",
                             programs=("forest",))
    loop = [s for s in prog.trace if s.in_loop]
    assert loop and all(s.path.startswith("level/") for s in loop)
    assert {s.packet for s in loop} <= {"aten.index_select", "aten.add",
                                        "aten.select"}
    direct = [s for s in prog.trace if s.packet == "aten.index_put_"]
    assert len(direct) == 1 and not direct[0].in_loop


def test_lint_cli_single_backend(capsys):
    rc = main(["--backend", "int_dot", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "int_dot" in out and "clean" in out
    assert "paged-attention skipped: built only where the B2 kernel" in out


def test_lint_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in R.list_rules():
        assert name in out


def test_lint_cli_mesh_exits_2_naming_a10(capsys):
    """A ``model`` axis above 1 is not served yet: exit 2 naming A10.2."""
    with pytest.raises(SystemExit) as e:
        main(["--mesh", "data=2,model=2", "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP item A10.2" in capsys.readouterr().err


def test_lint_cli_mesh_data2_starts_its_ranks(capfd):
    """``--mesh data=2`` with no process group starts two ranks itself:
    exit 0, clean, ``sharding-integrity`` evaluated on the decode
    program."""
    assert main(["--mesh", "data=2", "--device", "cpu",
                 "--backend", "int_dot"]) == 0
    out = capfd.readouterr().out
    assert "sharding-integrity evaluated on 1 program(s) (decode) under " \
        "mesh data=2 (2 ranks)" in out
    assert "on mesh data=2: 0 finding(s), 0 baselined, 0 failing" in out


def test_baseline_stale_keys_and_prune():
    found = analysis.find_violations(_item, torch.ones(4))
    live = found[0].key()
    dead = "no-host-callback::int_dot::retired-program::aten.item"
    assert stale_keys({live, dead}, found) == [dead]
    assert stale_keys({live}, found) == []
    assert stale_keys(set(), found) == []


def test_lint_cli_prune_baseline(tmp_path, capsys):
    dead = "no-host-callback::int_dot::retired-program::aten.item"
    p = tmp_path / "baseline.txt"
    p.write_text(dead + "\n")
    argv = ["--backend", "int_dot", "--batch", "2", "--device", "cpu",
            "--baseline", str(p), "--prune-baseline"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert f"stale: {dead}" in out and "1 stale entry" in out
    assert main(argv + ["--write-baseline", str(p)]) == 0
    assert dead not in p.read_text()


def test_lint_cli_fails_on_a_finding_unless_baselined(tmp_path, capsys,
                                                      monkeypatch):
    rule = R.get_rule("static-shapes")
    monkeypatch.setattr(type(rule), "check", lambda self, prog: [
        self._finding(prog, "forced", path="0:aten.x", primitive="aten.x")])
    argv = ["--backend", "int_dot", "--batch", "2", "--device", "cpu"]
    assert main(argv) == 1
    p = tmp_path / "b.txt"
    assert main(argv + ["--write-baseline", str(p)]) == 0
    assert main(argv + ["--baseline", str(p)]) == 0
    assert "static-shapes::int_dot::decode::aten.x" in p.read_text()


def test_lint_cli_plans_and_budgets_sections(tmp_path, capsys):
    out_json = tmp_path / "lint.json"
    rc = main(["--backend", "engine_torch", "--plans", "--budgets",
               "--device", "cpu", "--json", str(out_json)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[planlint]" in out and "[costcheck]" in out
    doc = json.loads(out_json.read_text())
    assert doc["plans"] and doc["plans"][0]["backend"] == "engine_torch"
    assert any(r.get("ok") for r in doc["budgets"])
    assert doc["backends"][0]["skipped"] == {"paged-attention": KERNEL_ONLY}
    assert doc["summary"]["device"] == "cpu"
    rows = {r["budget"]: r for r in doc["budgets"]}
    assert rows["swap-trace-count"]["value"] == 1
    assert rows["live-page-decode"]["skipped"] == KERNEL_ONLY
    assert rows["forest-scatter-in-loop"]["value"] == 0
