"""Port parity: the serving slice of ``repro_torch`` end to end against the
JAX reference, on ``serve_config(get_reduced("smollm_135m"))`` (W4A8
per-channel PTQ, dynamic int8 attention, KV8 pool) in float32 with the
paged-attention kernel path on.

The reference's weights are carried over through ``repro_torch.convert``;
the reference serves through ``engine_pallas`` (interpret mode) and the
port through ``engine_cuda``, whose plain versions run on CPU tensors.
Reference plans are built with its engine directly, so nothing here
routes through ``repro.analysis``. The port is held to: prefill logits
within tolerance, ``greedy_generate`` tokens equal to the reference's,
and ``ServeEngine`` tokens on a staggered, prefix-sharing workload equal
to the reference ``ServeEngine``'s and to the port's own per-request
``greedy_generate``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.core.engine import BatchedTransitiveEngine  # noqa: E402
from repro.core.engine import compile_plans  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

MAX_LEN, PAGE, GEN = 24, 4, 5


def _ref_attach(tree):
    """The reference's stacked DevicePlans, built without its plan cache."""
    if isinstance(tree, dict):
        if "qw" in tree and "sg" in tree:
            qw = np.asarray(tree["qw"]).astype(np.int64)
            plans = [BatchedTransitiveEngine(4, 8).plan(qw[i])
                     for i in range(qw.shape[0])]
            return {**tree, "dplan": compile_plans(plans)}
        return {k: _ref_attach(v) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def cell():
    ref_cfg = ref_serve_config(ref_reduced("smollm_135m"),
                               backend="engine_pallas").replace(
        dtype=jnp.float32, paged_kernel=True)
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    ref_params = _ref_attach(raw)
    cfg = serve_config(get_reduced("smollm_135m"),
                       backend="engine_cuda").replace(
        dtype=torch.float32, paged_kernel=True)
    model = Model(cfg, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    params = model.attach_device_plans(params)
    return ref_model, ref_params, model, params


def _prompts(vocab, seed=7):
    """Staggered prefix-sharing workload: evens repeat a 9-token base
    prompt, odds share its first half, plus one short fresh prompt."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=9).tolist()
    return [base, base[:4] + rng.integers(0, vocab, size=5).tolist(),
            base, rng.integers(0, vocab, size=3).tolist(), base]


def test_converted_params_keep_layout(cell):
    """Converted weights keep the reference's layout; the port's
    DevicePlans (``engine_torch``'s lowering) equal the reference's leaf
    for leaf, and ``engine_cuda`` attaches their compact packing."""
    from repro_torch.core import plancache
    from repro_torch.core.engine import (FOREST_DATA_FIELDS, ForestPlan,
                                         pack_forest_plan)
    ref_model, ref_params, model, params = cell
    blocks = params["blocks"]
    assert blocks["b0"]["wq"]["qw"].dtype == torch.int8
    assert blocks["b0"]["wq"]["qw"].shape[0] == model.cfg.n_repeats
    np.testing.assert_array_equal(
        blocks["m0"]["down"]["qw"].numpy(),
        np.asarray(ref_params["blocks"]["m0"]["down"]["qw"]))
    ref_wo = ref_params["blocks"]["b0"]["wo"]["dplan"]
    dense = plancache.attach_device_plans(
        _without_plans(params), model.cfg.quant, backend="engine_torch")
    for name in ("level_src", "gather_idx", "direct_idx"):
        np.testing.assert_array_equal(
            getattr(dense["blocks"]["b0"]["wo"]["dplan"], name).numpy(),
            np.asarray(getattr(ref_wo, name)))
    compact = blocks["b0"]["wo"]["dplan"]
    assert isinstance(compact, ForestPlan)
    want = pack_forest_plan(params_from_reference(ref_wo))
    for name in FOREST_DATA_FIELDS:
        np.testing.assert_array_equal(getattr(compact, name).numpy(),
                                      getattr(want, name).numpy())


def test_prefill_logits_match(cell):
    """f32 prefill logits: integer GEMMs and int8 attention products are
    exact in both packages, but f32 norms, RoPE, softmax and the tied
    unembedding sum in other orders, and a one-ulp difference can move one
    activation code by one step; the logits (O(0.1)) are held to atol
    2e-4."""
    ref_model, ref_params, model, params = cell
    toks = np.random.default_rng(1).integers(0, 512, size=(2, 7))
    want, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                MAX_LEN)
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           MAX_LEN)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_greedy_generate_tokens_equal_reference(cell):
    ref_model, ref_params, model, params = cell
    toks = np.random.default_rng(2).integers(0, 512, size=(2, 6))
    want = np.asarray(ref_greedy_generate(
        ref_model, ref_params, {"tokens": jnp.asarray(toks, jnp.int32)},
        max_len=MAX_LEN, n_steps=GEN))
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(toks)},
                          max_len=MAX_LEN, n_steps=GEN)
    assert got.dtype == torch.int32 and got.shape == (2, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = greedy_generate(model, params,
                            {"tokens": torch.from_numpy(toks)},
                            max_len=MAX_LEN, n_steps=0)
    assert empty.shape == (2, 0)
    with pytest.raises(ValueError, match="n_steps"):
        greedy_generate(model, params, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN, n_steps=-1)


def _serve(engine, prompts):
    """Submit one prompt per step (staggered arrivals), run to the end."""
    for p in prompts:
        engine.submit(p, GEN)
        engine.step()
    engine.run()
    return {r.rid: list(r.tokens) for r in engine.finished}


def test_serve_engine_tokens_equal_reference_and_greedy(cell):
    ref_model, ref_params, model, params = cell
    prompts = _prompts(model.cfg.vocab)
    ref_eng = RefServeEngine(ref_model, ref_params, n_slots=2,
                             max_len=MAX_LEN, page_size=PAGE,
                             paged_kernel=True)
    want = _serve(ref_eng, prompts)
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, paged_kernel=True, device="cpu")
    got = _serve(eng, prompts)
    assert got == want
    c = eng.counters
    assert c["pages_shared"] > 0 and c["prefix_hits"] > 0
    for key in ("pages_shared", "prefix_hits", "prefill_skipped",
                "prefill_computed", "decode_tokens"):
        assert c[key] == ref_eng.counters[key], key
    for r in eng.finished:
        alone = greedy_generate(model, params,
                                {"tokens": torch.tensor([r.prompt])},
                                max_len=MAX_LEN, n_steps=GEN)
        assert alone[0].tolist() == r.tokens, r.rid


def test_serve_engine_gather_path_and_per_request_prefill(cell):
    """The gather decode oracle and per-request (unbucketed) prefill give
    the same tokens as the kernel path with bucketed prefill."""
    _, _, model, params = cell
    prompts = _prompts(model.cfg.vocab, seed=11)
    toks = []
    for kernel, bucketed in ((True, True), (False, False)):
        eng = ServeEngine(model, params, n_slots=3, max_len=MAX_LEN,
                          page_size=PAGE, paged_kernel=kernel,
                          bucket_prefill=bucketed, device="cpu")
        toks.append(_serve(eng, prompts))
    assert toks[0] == toks[1]


def test_serve_engine_validation(cell):
    _, _, model, params = cell
    with pytest.raises(ValueError, match="multiple of page_size"):
        ServeEngine(model, params, max_len=10, page_size=4, device="cpu")
    eng = ServeEngine(model, params, n_slots=1, max_len=8, page_size=4,
                      device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit([1] * 8, 2)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 2)
    eng.submit([1, 2, 3], 1)                 # finishes at prefill
    assert [len(r.tokens) for r in eng.run()] == [1]
    assert eng.report()["n_requests"] == 1


def _without_plans(tree):
    if isinstance(tree, dict):
        return {k: _without_plans(v) for k, v in tree.items()
                if k != "dplan"}
    return tree


def test_serve_engine_on_lut_cuda_equals_reference_and_int_dot(cell):
    """The LUT serving path on CPU: the doubling-LUT backend (``lut_cuda``, its
    plain version on CPU tensors) with no plans. ServeEngine gives the
    reference ServeEngine's tokens and the port's ``int_dot`` tokens, and
    ``greedy_generate`` gives the reference's greedy tokens. (On these
    prompts request 1's served tokens differ from its per-request greedy
    tokens in the reference itself, and the port reproduces both.)"""
    from repro_torch.core import plancache
    ref_model, ref_params, model, params = cell
    raw = _without_plans(params)
    prompts = _prompts(model.cfg.vocab, seed=13)
    ref_eng = RefServeEngine(ref_model, ref_params, n_slots=2,
                             max_len=MAX_LEN, page_size=PAGE,
                             paged_kernel=True)
    want = _serve(ref_eng, prompts)
    toks = {}
    cache = plancache.PlanCache()
    prev = plancache.set_default_cache(cache)
    try:
        for backend in ("lut_cuda", "int_dot"):
            cfg = model.cfg.replace(
                quant=model.cfg.quant.with_(backend=backend))
            lut_model = Model(cfg, device="cpu")
            eng = ServeEngine(lut_model, raw, n_slots=2, max_len=MAX_LEN,
                              page_size=PAGE, paged_kernel=True,
                              device="cpu")
            toks[backend] = _serve(eng, prompts)
            if backend == "lut_cuda":
                batch = np.random.default_rng(2).integers(0, 512,
                                                          size=(2, 6))
                greedy = greedy_generate(
                    lut_model, raw, {"tokens": torch.from_numpy(batch)},
                    max_len=MAX_LEN, n_steps=GEN)
    finally:
        plancache.set_default_cache(prev)
    assert (cache.hits, cache.misses) == (0, 0)
    assert toks["lut_cuda"] == want
    assert toks["int_dot"] == want
    ref_greedy = ref_greedy_generate(
        ref_model, ref_params, {"tokens": jnp.asarray(batch, jnp.int32)},
        max_len=MAX_LEN, n_steps=GEN)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref_greedy))


def test_engine_cuda_serves_from_forest_plans_without_packing(cell):
    """``engine_cuda`` serves from the attached compact ForestPlans: every
    PTQ layer carries one, serving packs nothing, and the tokens equal the
    reference ServeEngine's (``engine_pallas``, interpret mode)."""
    from repro_torch.core.engine import ForestPlan, pack_forest_plan
    from repro_torch.core.plancache import _iter_ptq_layers
    ref_model, ref_params, model, params = cell
    layers = list(_iter_ptq_layers(params))
    assert layers and all(isinstance(layer["dplan"], ForestPlan)
                          for layer in layers)
    prompts = _prompts(model.cfg.vocab, seed=5)
    want = _serve(RefServeEngine(ref_model, ref_params, n_slots=2,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 paged_kernel=True), prompts)
    calls = pack_forest_plan.calls
    got = _serve(ServeEngine(model, params, n_slots=2, max_len=MAX_LEN,
                             page_size=PAGE, paged_kernel=True,
                             device="cpu"), prompts)
    assert pack_forest_plan.calls == calls
    assert got == want


# The paged-attention kernel's three other pool layouts, served: the
# unquantized base config (``launch/serve.py --fp``: exact pool, float
# attention), and W4A8 linears with an int8 pool and float attention, or
# an exact pool and int8 attention. (reference config, port config)
# makers; the reference's integer GEMM is ``int_dot`` (bit-exact with
# every backend's int32 accumulator, and quick in interpret mode), the
# port's ``lut_cuda`` (its plain version on CPU tensors).
_LAYOUT_CELLS = {
    "fp": lambda r, p: (r, p),
    "kv8-float-attention": lambda r, p: (
        ref_serve_config(r, backend="int_dot").replace(
            kv_cache_bits=8, quant_attention=False),
        serve_config(p, backend="lut_cuda").replace(
            kv_cache_bits=8, quant_attention=False)),
    "exact-kv-int8-attention": lambda r, p: (
        ref_serve_config(r, backend="int_dot").replace(
            kv_cache_bits=16, quant_attention=True),
        serve_config(p, backend="lut_cuda").replace(
            kv_cache_bits=16, quant_attention=True)),
}


@pytest.mark.parametrize("cell_name", list(_LAYOUT_CELLS))
def test_serve_engine_other_pool_layouts_equal_reference(cell_name):
    """The reduced 2-layer smollm (the reference's own ``fp_cell`` in
    tests/test_serve_engine.py) in float32, served by ServeEngine with the
    paged kernel on in both packages, on the staggered prefix-sharing
    workload: the port's tokens equal the reference's, and equal the
    port's gather path's. The weights are the reference's, converted."""
    from repro_torch.kernels.paged_attention import paged_attention
    ref_cfg, cfg = _LAYOUT_CELLS[cell_name](
        ref_reduced("smollm_135m").replace(n_layers=2, dtype=jnp.float32),
        get_reduced("smollm_135m").replace(n_layers=2, dtype=torch.float32))
    ref_model = RefModel(ref_cfg.replace(paged_kernel=True))
    raw = ref_model.init(jax.random.PRNGKey(0))
    model = Model(cfg.replace(paged_kernel=True), device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    prompts = _prompts(model.cfg.vocab, seed=17)
    want = _serve(RefServeEngine(ref_model, raw, n_slots=2,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 paged_kernel=True), prompts)
    before = paged_attention.launches
    toks = {}
    for kernel in (True, False):
        toks[kernel] = _serve(ServeEngine(model, params, n_slots=2,
                                          max_len=MAX_LEN, page_size=PAGE,
                                          paged_kernel=kernel,
                                          device="cpu"), prompts)
    assert paged_attention.launches == before    # CPU: the plain version
    assert toks[True] == want
    assert toks[False] == want
