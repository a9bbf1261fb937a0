"""The port stands alone: no JAX, no reference package, no silent CPU.

* No module under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or ``repro`` (an AST scan, so lazy imports inside functions
  count too).
* The entry points (``Model``, ``ServeEngine``, ``launch.serve``) refuse
  to run when no CUDA device is present unless asked for the CPU.
* The kernel wrappers raise, rather than fall back to their plain
  versions, when given a non-CPU tensor and the kernel cannot be built
  (a stubbed loader stands in for the missing ``nvcc``); for the GEMM and
  recurrence wrappers a plain version that raises when reached shows it
  is never called for such a tensor.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = {str(p.relative_to(ROOT)): sorted(r & {"jax", "jaxlib", "repro"})
           for p in files if _imported_roots(p) & {"jax", "jaxlib", "repro"}}
    assert not bad, f"port modules importing JAX or the reference: {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_cfg():
    from repro_torch.configs import get_reduced
    from repro_torch.launch.specs import serve_config
    return serve_config(get_reduced("smollm_135m").replace(n_layers=1),
                        backend="engine_torch")


def test_entry_points_refuse_cpu_fallback(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, max_len=16, page_size=4)
    ServeEngine(model, params, max_len=16, page_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m", "--reduced", "--continuous"])


def test_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "smollm-135m", "--reduced", "--continuous",
                      "--device", "cpu", "--backend", "engine_cuda",
                      "--paged-kernel", "--prompt-len", "8", "--gen", "3",
                      "--page-size", "4", "--requests", "3"])
    assert [len(r.tokens) for r in eng.finished] == [3, 3, 3]
    assert eng.counters["pages_shared"] > 0
    out = capsys.readouterr().out
    assert "[prefix reuse]" in out and "transitive_forest launches=0" in out


def test_launcher_serves_lut_cuda_on_cpu_without_plans(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "smollm-135m", "--reduced", "--continuous",
                      "--device", "cpu", "--backend", "lut_cuda",
                      "--paged-kernel", "--prompt-len", "8", "--gen", "3",
                      "--page-size", "4", "--requests", "3"])
    assert [len(r.tokens) for r in eng.finished] == [3, 3, 3]
    out = capsys.readouterr().out
    assert "[plan cache]" not in out and "/lut_cuda" in out
    assert "transitive_gemm launches=0" in out


def test_launcher_serves_fp_on_cpu(capsys):
    """``--fp``: the base config unquantized (dense linears, float
    attention, exact pool), decoded through the paged kernel's plain
    version on CPU tensors; no plan, no integer GEMM."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "smollm-135m", "--reduced", "--continuous",
                      "--device", "cpu", "--fp", "--paged-kernel",
                      "--prompt-len", "8", "--gen", "3", "--page-size", "4",
                      "--requests", "3"])
    cfg = eng.model.cfg
    assert cfg.quant.mode == "none" and not cfg.quant_attention
    assert cfg.kv_cache_bits == 16 and cfg.dtype == torch.bfloat16
    assert [len(r.tokens) for r in eng.finished] == [3, 3, 3]
    out = capsys.readouterr().out
    assert "[plan cache]" not in out and "| fp bfloat16 |" in out
    assert "paged_attention launches=0 | decode=paged-kernel" in out


def _failing_build(name):
    raise RuntimeError(f"nvcc not found: cannot build {name}")


def test_forest_wrapper_raises_instead_of_falling_back(monkeypatch, rng):
    from repro_torch.core.engine import BatchedTransitiveEngine, compile_plan
    from repro_torch.kernels import build, transitive_forest as tf
    monkeypatch.setattr(build, "load", _failing_build)
    d = compile_plan(BatchedTransitiveEngine(4, 8).plan(
        rng.integers(-8, 8, size=(4, 16))))
    x = torch.from_numpy(rng.integers(-128, 128, size=(16, 3)))
    before = tf.transitive_forest.launches
    cpu = tf.transitive_forest(d, x)           # CPU: the plain version
    np.testing.assert_array_equal(cpu.numpy(),
                                  tf.forest_plain(d, x).numpy())
    with pytest.raises(RuntimeError, match="cannot build transitive_forest"):
        tf.transitive_forest(d, x.to("meta"))
    assert tf.transitive_forest.launches == before


def test_forest_rows_entry_raises_instead_of_falling_back(monkeypatch,
                                                         rng):
    """The serving entry of the forest kernel: the plain version on CPU
    tensors only; a failed build and a tensor on neither device raise."""
    import types
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan, pack_forest_plan)
    from repro_torch.kernels import build, transitive_forest as tf
    fplan = pack_forest_plan(compile_plan(BatchedTransitiveEngine(4, 8).plan(
        rng.integers(-8, 8, size=(4, 16)))))
    qx = torch.from_numpy(rng.integers(-128, 128, size=(3, 16)).astype(
        np.int8))
    before = tf.transitive_forest.launches
    cpu = tf.transitive_forest_rows(fplan, qx)      # CPU: the plain version
    np.testing.assert_array_equal(
        cpu.numpy(), tf.forest_plan_plain(fplan, qx.T).T.numpy())
    monkeypatch.setattr(tf, "forest_plan_plain", _never)
    monkeypatch.setattr(build, "load", _failing_build)
    with pytest.raises(RuntimeError, match="cannot build transitive_forest"):
        tf.transitive_forest_rows(fplan, qx.to("meta"))
    monkeypatch.setattr(build, "load",
                        lambda name: types.SimpleNamespace(_typed=True))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tf.transitive_forest_rows(fplan, qx.to("meta"))
    assert tf.transitive_forest.launches == before


def test_attention_wrapper_raises_instead_of_falling_back(monkeypatch):
    from repro_torch.kernels import build, paged_attention as pa
    monkeypatch.setattr(build, "load", _failing_build)
    cfg = _tiny_cfg()
    n_pages, ps, kv, hd = 3, 4, cfg.n_kv_heads, cfg.hd
    pool = {"k": torch.zeros((n_pages, ps, kv, hd), dtype=torch.int8),
            "v": torch.zeros((n_pages, ps, kv, hd), dtype=torch.int8),
            "ks": torch.ones((n_pages, ps, kv, 1)),
            "vs": torch.ones((n_pages, ps, kv, 1))}
    q = torch.ones((1, 1, cfg.n_heads, hd))
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    steps = torch.tensor([5], dtype=torch.int32)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
    assert out.shape == q.shape and torch.isfinite(out).all()
    meta = {n: a.to("meta") for n, a in pool.items()}
    with pytest.raises(RuntimeError, match="cannot build paged_attention"):
        pa.paged_attention(q.to("meta"), meta, table, steps, cfg,
                           hd ** -0.5)
    assert pa.paged_attention.launches == before


def _never(*args, **kwargs):
    raise AssertionError("a non-CPU tensor reached the plain version")


@pytest.mark.parametrize("name", ["transitive_gemm", "w4a8_gemm", "rg_lru"])
def test_gemm_and_scan_wrappers_raise_instead_of_falling_back(
        monkeypatch, rng, name):
    import importlib
    from repro_torch.kernels import build, ops
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    wrapper = getattr(mod, f"{name}_cuda")
    q = torch.from_numpy(rng.integers(-8, 8, size=(4, 64)).astype(np.int8))
    args = {"transitive_gemm": (q, q),
            "w4a8_gemm": (q, torch.ones((4, 1)), q, torch.ones((4, 2))),
            "rg_lru": (torch.ones((2, 3, 4)), torch.ones((2, 3, 4)),
                       torch.ones((2, 4)))}[name]
    kw = {"w4a8_gemm": {"group": 32}}.get(name, {})
    op = getattr(ops, name)
    monkeypatch.setattr(build, "load", _failing_build)
    before = wrapper.launches
    cpu = op(*args, **kw)                       # CPU: the plain version
    assert cpu.device.type == "cpu" and torch.isfinite(cpu.float()).all()
    monkeypatch.setattr(mod, f"{name}_plain", _never)
    monkeypatch.setattr(mod, "ref", None)       # no route to kernels/ref
    with pytest.raises(RuntimeError, match=f"cannot build {name}"):
        op(*(a.to("meta") for a in args), **kw)
    assert wrapper.launches == before


@pytest.mark.parametrize("d,kernel", [(4, "rg_lru_ring"),
                                      (5, "rg_lru_regs")])
def test_rg_lru_both_instances_raise_instead_of_falling_back(monkeypatch, d,
                                                             kernel):
    """B5's two instances (TMA ring where rows are 16-byte aligned, the
    register prefetch elsewhere): with the kernel unbuildable, a non-CPU
    input of either raises through ``ops.rg_lru`` and the wrapper, never
    reaching the plain version, and nothing is launched."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import rg_lru as mod
    args = (torch.ones((2, 3, d)), torch.ones((2, 3, d)), torch.ones((2, d)))
    assert mod.launch_plan(2, 3, d, 4, 4, 4).kernel == kernel
    monkeypatch.setattr(build, "load", _failing_build)
    monkeypatch.setattr(mod, "rg_lru_plain", _never)
    monkeypatch.setattr(mod, "ref", None)
    before = mod.rg_lru_cuda.launches
    for fn in (ops.rg_lru, mod.rg_lru_cuda):
        with pytest.raises(RuntimeError, match="cannot build rg_lru"):
            fn(*(a.to("meta") for a in args))
    assert mod.rg_lru_cuda.launches == before


def test_wide_t_routes_raise_instead_of_falling_back(monkeypatch, rng):
    """T outside {4, 8}: B3 at T=6 (the one LUT kernel, at its own width),
    B1 from a T=9 DevicePlan (packed, the fused int16 kernel), from a T=9
    ForestPlan through the serving row entry (the same kernel), from a
    T=16 DevicePlan (packed into a SparseForestPlan, ``forest_sparse``)
    and from a T=16 DevicePlan whose compact table does not fit (the
    two-pass kernel) run their plain versions on CPU tensors, and on a
    non-CPU tensor raise when their kernel cannot be built, launching
    nothing."""
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan, complete_forest_plan,
                                         pack_forest_plan, run_device)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import transitive_forest as tf
    from repro_torch.kernels import transitive_forest_dense as tfd
    from repro_torch.kernels import transitive_forest_sparse as tfs
    from repro_torch.kernels import transitive_gemm as tg
    monkeypatch.setattr(build, "load", _failing_build)
    qx = torch.from_numpy(rng.integers(-128, 128, (3, 36)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-8, 8, (5, 36)).astype(np.int8))
    dplan = compile_plan(BatchedTransitiveEngine(4, 9).plan(qw.numpy()))
    fplan = pack_forest_plan(dplan)
    assert fplan.rows.dtype == torch.int16
    qx16 = torch.from_numpy(rng.integers(-128, 128, (2, 32)).astype(np.int8))
    qw16 = torch.from_numpy(rng.integers(-8, 8, (3, 32)).astype(np.int8))
    dplan16 = compile_plan(BatchedTransitiveEngine(4, 16).plan(qw16.numpy()))
    crowded = compile_plan(complete_forest_plan(16, 30000, 3))
    xc = torch.from_numpy(rng.integers(-128, 128, (16, 2)))
    before = (tg.transitive_gemm_cuda.launches,
              tfd.transitive_forest_dense.launches,
              tf.transitive_forest.launches, tfs.launch_sparse.launches)
    exact = qx.long() @ qw.long().T
    assert torch.equal(ops.transitive_gemm(qx, qw, w_bits=4, t=6).long(),
                       exact)
    assert torch.equal(ops.transitive_forest(dplan, qx.T).T.long(), exact)
    assert torch.equal(tf.transitive_forest_rows(fplan, qx).long(), exact)
    assert torch.equal(ops.transitive_forest(dplan16, qx16.T).T.long(),
                       qx16.long() @ qw16.long().T)
    assert torch.equal(ops.transitive_forest(crowded, xc),
                       run_device(crowded, xc))
    with pytest.raises(RuntimeError, match="cannot build transitive_gemm"):
        ops.transitive_gemm(qx.to("meta"), qw.to("meta"), w_bits=4, t=6)
    for call in (lambda: ops.transitive_forest(dplan, qx.T.to("meta")),
                 lambda: tf.transitive_forest_rows(_on(fplan, "meta"),
                                                   qx.to("meta")),
                 lambda: ops.transitive_forest(crowded, xc.to("meta"))):
        with pytest.raises(RuntimeError,
                           match="cannot build transitive_forest_dense"):
            call()
    for call in (lambda: ops.transitive_forest(dplan16, qx16.T.to("meta")),
                 lambda: tf.transitive_forest_rows(dplan16,
                                                   qx16.to("meta"))):
        with pytest.raises(RuntimeError,
                           match="cannot build transitive_forest_sparse"):
            call()
    assert (tg.transitive_gemm_cuda.launches,
            tfd.transitive_forest_dense.launches,
            tf.transitive_forest.launches,
            tfs.launch_sparse.launches) == before


def _on(plan, device):
    """The plan with every leaf moved to ``device``."""
    import dataclasses
    return dataclasses.replace(plan, **{f: a.to(device)
                                        for f, a in plan.leaves().items()})


def test_build_needs_nvcc_and_nothing_runs_at_import(monkeypatch, tmp_path):
    """Importing the kernels builds nothing; a build without nvcc raises
    with the reason instead of producing a library."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.start("transitive_forest")
    assert not (tmp_path / "kernels").exists()
