"""Port parity: the data-parallel serve cell (``repro_torch.launch.mesh``,
``greedy_generate(mesh=)``, ``ServeEngine(mesh=)``, plans and bundles
placed on the mesh, the lint under a mesh) against the port's one-rank run
and the reference's one-device run, in one 4-rank ``gloo`` CPU world for
the whole module (``RankWorld``: spawned ranks, a ``FileStore`` in a
private temporary directory, a hard timeout per call).

The cell is the reference's (``tests/test_serve_mesh.py``): reduced
smollm-135m with 2 layers, W4A8 serving config, here in float32 with the
reference's weights carried over (``repro_torch.convert``). The reference
runs ``int_dot`` on one device (every planned backend is bit-exact with
it); each rank runs ``tests/_mesh_ranks.py``, which loads no JAX. Tokens
and plan-cache counts are held to exact equality: data parallelism never
reorders a row's reductions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _mesh_ranks as R  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.launch.mesh import RankWorld  # noqa: E402

BACKENDS = ("engine_torch", "engine_cuda")


@pytest.fixture(scope="module")
def world():
    w = RankWorld(4, timeout=240, threads=1)
    yield w.start()
    w.close()


@pytest.fixture(scope="module")
def ref():
    """The reference's cell on one device: model, weights (and their numpy
    twins for the ranks), the (4, 8) batch and its greedy tokens."""
    cfg = ref_serve_config(ref_reduced("smollm_135m").replace(n_layers=2),
                           backend="int_dot").replace(dtype=jnp.float32)
    model = RefModel(cfg)
    raw = model.init(jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 8), 0, cfg.vocab, jnp.int32))
    want = np.asarray(ref_greedy_generate(
        model, raw, {"tokens": jnp.asarray(tokens)}, max_len=24, n_steps=5))
    return {"model": model, "raw": raw,
            "raw_np": jax.tree.map(np.asarray, raw), "tokens": tokens,
            "greedy": want}


def _ref_greedy(ref, raw, prompt, max_len, n):
    return np.asarray(ref_greedy_generate(
        ref["model"], raw, {"tokens": jnp.asarray([prompt], jnp.int32)},
        max_len=max_len, n_steps=n))[0].tolist()


@pytest.mark.parametrize("backend, spec", [
    ("engine_torch", "data=4"), ("engine_cuda", "data=4"),
    ("engine_cuda", "pod=2,data=2")])
def test_mesh_generate_bit_identical_and_no_cache_traffic(world, ref,
                                                          backend, spec):
    """``greedy_generate`` on a 4-rank batch mesh (``data=4``, and
    ``pod=2,data=2``: the batch split over the product) with plans
    attached on the mesh equals the port's one-rank run and the
    reference's one-device run on every rank; decode reads every plan
    from the params (0 plan-cache hits or misses after attach); the
    placed plans are replicated DTensors equal to their host twins."""
    everywhere = ("R",) * len(spec.split(","))
    for r in world.run(R.generate, ref["raw_np"], backend, ref["tokens"],
                       spec):
        np.testing.assert_array_equal(r["one"], ref["greedy"])
        np.testing.assert_array_equal(r["mesh"], ref["greedy"])
        assert r["lookups"] == (0, 0)
        assert r["plans_equal"] and r["plan_placements"] == {everywhere}


def test_mesh_prefill_caches_sharded_and_decode_trace_clean(world, ref):
    """The prefilled caches are DTensors ``Shard``ed on the batch (one row
    a rank, none fully replicated); the mesh decode step's op trace is
    clean under tracelint; ``sharding-integrity`` finds nothing on them
    and fires on every cache leaf once it is left replicated on the real
    4-rank mesh."""
    for r in world.run(R.caches_and_trace, ref["raw_np"], "engine_cuda",
                       ref["tokens"]):
        assert r["placements"] and all(
            p == ("S(1)",) for p in r["placements"].values()), \
            r["placements"]
        for path, shape in r["global_rows"].items():
            assert shape[1] == 4 and r["local_rows"][path][1] == 1
        assert r["trace_findings"] == []
        assert r["sharded_findings"] == []
        assert len(r["replicated_findings"]) == len(r["placements"])
        assert "fully replicated on a 4-device mesh" in \
            r["replicated_findings"][0]


@pytest.mark.filterwarnings(
    "ignore::repro_torch.distributed.sharding.ShardingDropWarning")
def test_mesh_engine_fast_path_bit_identical(world, ref):
    """ServeEngine's fast path (B2's decode, bucketed prefill) on ``data=4``
    with ragged prompts of 3, 6, 9 and 11 tokens equals the one-rank
    engine and the reference's one-device greedy tokens on every rank;
    bucket widths 1 and 2 replicate (the warning), the packed decode
    splits its slots, one decode signature, and the replicated pool is
    bit-identical on every rank."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (3, 6, 9, 11)]
    want = [_ref_greedy(ref, ref["raw"], p, 16, 4) for p in prompts]
    got = world.run(R.serve, ref["raw_np"], "engine_cuda", prompts, 4)
    for r in got:
        assert r["one"] == r["mesh"] == dict(enumerate(want))
        assert r["batched_calls"] > 0 and r["decode_signatures"] == 1
        assert r["placements"] == {"tokens": ("S(0)",), "table": ("S(0)",),
                                   "steps": ("S(0)",), "pool": ("R",)}
    assert len({r["pool"] for r in got}) == 1


def test_mesh_hot_swap_bit_exact_per_generation(world, ref):
    """A swap lands mid-flight on ``data=4`` (generation 1 planned by a
    ``ReplanWorker(mesh=)``, both generations' plans placed on the mesh):
    every request equals the reference's one-device greedy tokens on its
    admitting generation's weights, on every rank, and the packed decode
    keeps one signature."""
    raw1 = ref["model"].init(jax.random.PRNGKey(1234))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, size=8).tolist() for _ in range(4)]
    want = {(g, tuple(p)): _ref_greedy(ref, raw, p, 16, 4)
            for g, raw in ((0, ref["raw"]), (1, raw1)) for p in prompts}
    for r in world.run(R.hot_swap, ref["raw_np"],
                       jax.tree.map(np.asarray, raw1), "engine_cuda",
                       prompts, 4):
        assert sorted({g for g, _, _ in r["tokens"]}) == [0, 1]
        for g, p, toks in r["tokens"]:
            assert toks == want[(g, tuple(p))], (g, p)
        assert r["decode_signatures"] == 1
        assert (r["swaps"], r["retired"]) == (1, 1) and r["placed"]


def test_load_bundles_on_mesh_builds_nothing(world, ref, tmp_path):
    """Bundles written once (planner role) load onto a ``data=4`` mesh with
    0 plan builds and 0 lookups on every rank, and serve the reference's
    tokens."""
    from repro_torch.convert import params_from_reference
    from repro_torch.core.plancache import PlanCache
    from repro_torch.fleet import write_bundles
    model, _ = R.cell(ref["raw_np"], "engine_cuda")
    write_bundles(params_from_reference(ref["raw_np"], "cpu"),
                  model.cfg.quant, str(tmp_path), cache=PlanCache())
    for r in world.run(R.load_bundles, ref["raw_np"], "engine_cuda",
                       str(tmp_path), ref["tokens"]):
        assert (r["builds"], r["hits"]) == (0, 0)
        np.testing.assert_array_equal(r["mesh"], ref["greedy"])


def test_data2_mesh_in_a_4_rank_world(world, ref):
    """A 2-way cell on the 4-rank world is legal: ranks 0 and 1 serve the
    reference's tokens, ranks 2 and 3 stand outside the mesh."""
    got = world.run(R.sub_mesh, ref["raw_np"], "engine_torch",
                    ref["tokens"])
    assert [r["in_mesh"] for r in got] == [True, True, False, False]
    for r in got[:2]:
        np.testing.assert_array_equal(r["mesh"], ref["greedy"])


def test_mesh_refusals(world, ref):
    """A mesh larger than the world is refused naming the rank count; a
    ``model`` axis of 2 (``make_local_mesh(2, 2)``) is refused at
    greedy_generate and ServeEngine, naming ROADMAP A10.2."""
    for r in world.run(R.refusals, ref["raw_np"], "engine_torch"):
        assert "needs 8 ranks but the process group has 4" in \
            r["too_large"]
        assert r["local_mesh"] == (("data", "model"), (2, 2))
        for where in ("greedy_generate", "ServeEngine"):
            assert "'model' axis of 2" in r[where]
            assert "A10.2" in r[where]


def test_lint_cli_mesh_data4_exits_0(world):
    """``python -m repro_torch.analysis.lint --mesh data=4 --device cpu``,
    run inside the world: exit 0 on every rank, 0 findings, and
    ``sharding-integrity`` evaluated on the decode program."""
    got = world.run(R.lint_cli, ["--mesh", "data=4", "--device", "cpu",
                                 "--backend", "engine_cuda", "--plans"])
    assert [rc for rc, _ in got] == [0, 0, 0, 0]
    out = got[0][1]
    assert "sharding-integrity evaluated on 1 program(s) (decode) under " \
        "mesh data=4 (4 ranks)" in out
    assert "on mesh data=4: 0 finding(s)" in out


def test_plan_placement_forms_and_backend_hook(world):
    """``shard_device_plan``'s three forms of specs (None: every leaf
    replicated; one placements tuple: every leaf; a mapping: the fields
    named, the rest replicated) on a stack of four DevicePlans and
    ForestPlans: DTensor leaves whose whole values equal the host plan's,
    one stacked entry a rank where sharded; unknown fields and other
    types refused. ``attach_device_plans(mesh=)`` without specs asks the
    backend's ``plan_specs`` hook; explicit specs bypass it."""
    for r in world.run(R.plan_placement):
        for name in BACKENDS:
            for form in ("none", "all", "map"):
                got = r[(name, form)]
                assert got["dtensor"] and got["equal"], (name, form)
                sharded = {f for f, p in got["placements"].items()
                           if p == ("S(0)",)}
                assert set(got["placements"]) - sharded == {
                    f for f, p in got["placements"].items() if p == ("R",)}
                first = next(iter(got["placements"]))
                assert sharded == {"none": set(), "all": set(got["rows"]),
                                   "map": {first}}[form]
                assert all(got["rows"][f] == 1 for f in sharded)
            assert "unknown" in r[(name, "refused", "ValueError")]
            assert "specs must be" in r[(name, "refused", "TypeError")]
        assert r["hook_calls"] == [True] and r["hook_placed"]
        assert r["hook_calls_after_explicit"] == 1


def test_swap_trace_count_on_mesh(world):
    """The ``swap-trace-count`` budget's scenario on a ``data=2`` mesh:
    one packed-decode signature across the swap, two when the new
    generation's plans are widened (the hand-broken twin)."""
    got = world.run(R.swap_traces)
    assert got == [(1, 2), (1, 2), None, None]
