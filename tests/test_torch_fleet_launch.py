"""The port launcher's fleet flags (``repro_torch.launch.serve``) on the
CPU, on the reduced smollm: the planner and server roles, the hot-swap
drill with ``--assert-swap-identity``, and the reference launcher's
refusals.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro_torch.core import plancache  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SMALL = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
         "--prompt-len", "8", "--gen", "4", "--page-size", "4"]


@pytest.fixture(autouse=True)
def cache():
    c = plancache.PlanCache()
    prev = plancache.set_default_cache(c)
    yield c
    plancache.set_default_cache(prev)


def _tokens(eng):
    return {r.rid: r.tokens for r in eng.finished}


@pytest.mark.parametrize("backend", ["engine_cuda", "engine_torch"])
def test_planner_then_server_builds_nothing(tmp_path, capsys, cache,
                                            backend):
    """The planner writes bundles and exits; a server attaches them with
    0 plan builds and serves the tokens a self-planning run serves."""
    bdir = str(tmp_path / "bundles")
    args = SMALL + ["--backend", backend]
    manifest = serve.main(args + ["--role", "planner", "--bundle-dir", bdir])
    assert manifest["n_files"] == 14 and manifest["backend"] == backend
    assert "[planner]" in capsys.readouterr().out
    planned = cache.stats()["misses"]
    assert planned == 14
    cache.reset_stats()
    eng = serve.main(args + ["--role", "server", "--bundle-dir", bdir,
                             "--continuous"])
    out = capsys.readouterr().out
    assert "plan builds on this cell: 0" in out
    assert cache.stats()["misses"] == 0
    mine = serve.main(args + ["--continuous"])
    assert _tokens(eng) == _tokens(mine)


@pytest.mark.parametrize("backend", ["engine_cuda", "lut"])
def test_watch_weights_swap_identity(tmp_path, capsys, backend):
    """The drill: half the requests on generation 0, new weights written as
    a checkpoint, planned off-thread, the rest on generation 1; every
    request equals its generation served alone on a fresh engine."""
    eng = serve.main(SMALL + ["--backend", backend, "--continuous",
                              "--requests", "4", "--slots", "2",
                              "--watch-weights", str(tmp_path / "w"),
                              "--assert-swap-identity"])
    out = capsys.readouterr().out
    assert "[hotswap] identity OK" in out
    assert eng.generation == 1
    assert sorted(r.gen for r in eng.finished) == [0, 0, 1, 1]
    s = eng.stats()
    assert s["swaps"] == 1 and s["generations_retired"] == 1


@pytest.mark.parametrize("argv, message", [
    (["--role", "planner"], "--role planner needs --bundle-dir"),
    (["--role", "server"], "--role server needs --bundle-dir"),
    (["--watch-weights", "W"], "--watch-weights needs --continuous"),
    (["--role", "planner", "--bundle-dir", "B", "--fp"], "drop --fp"),
    (["--role", "planner", "--bundle-dir", "B", "--backend", "lut_cuda"],
     "does not execute from device plans"),
    (["--role", "server", "--bundle-dir", "B", "--backend", "int_dot"],
     "does not execute from them"),
])
def test_launcher_refusals(tmp_path, capsys, argv, message):
    argv = [str(tmp_path / a) if a in ("B", "W") else a for a in argv]
    with pytest.raises(SystemExit) as e:
        serve.main(SMALL + argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_server_refuses_stale_bundles(tmp_path, capsys):
    """Bundles planned from other weights (another --seed) are refused:
    the server exits non-zero without serving."""
    bdir = str(tmp_path / "bundles")
    args = SMALL + ["--backend", "engine_cuda", "--bundle-dir", bdir]
    serve.main(args + ["--role", "planner", "--seed", "1"])
    with pytest.raises(SystemExit, match="bundle refused.*stale bundle"):
        serve.main(args + ["--role", "server", "--continuous"])
    with pytest.raises(SystemExit, match="bundle refused.*no manifest"):
        serve.main(SMALL + ["--backend", "engine_cuda", "--role", "server",
                            "--bundle-dir", str(tmp_path / "empty")])
