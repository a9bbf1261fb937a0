"""Port parity: recurrentgemma-9b (RG-LRU blocks, a block tail, local
attention over a rolling cache) against the JAX reference.

The registered config equals the reference's, full and reduced. One
RG-LRU block (``apply_rglru``: the recurrence through ``ops.rg_lru``,
the plain version on CPU tensors, where the reference scans
associatively) is held to the reference's at prefill and one decode step,
and one local-attention block at prefill into its rolling cache and
decode steps that wrap it. The reduced config in float32 is built in
both packages with the reference's weights carried over by
``repro_torch.convert``: prefill logits within atol 2e-4 and
``greedy_generate`` tokens equal at prompts of 48 positions (inside the
64-slot window), 100 (past it: the prefill keeps the last 64 and decode
wraps the rolling cache) and 2,100 (past ``CHUNK_THRESHOLD``:
``attend_chunked`` with the window).

The W4A8 ``serve_config`` on ``int_dot`` quantizes every activation per
token, so an ulp-level difference between XLA's and torch's float
arithmetic (exp, sigmoid, softplus, tanh-GELU, RMSNorm, the scans'
orders) moves an int8 code by one step now and then, and the recurrence
carries that step to every later position: held free-running, the
reduced model's logits part by 0.02-0.03 and its greedy tokens after 5
of 8 at 48 positions. So it is held on shared codes: the reference runs
eagerly with its per-token quantizer recorded, and at each quantization
the port computes its own codes and scales, which must agree (codes
within one step, at most 1e-4 of them off; scales within rtol 1e-4),
then carries on with the reference's. On those codes the prefill logits
agree within atol 2e-4 and the greedy tokens are equal, at the same
three prompt lengths. Every integer backend of the port gives
``int_dot``'s tokens, and ``engine_torch`` plans the tail's linears too.
The paged serve path refuses the config with the reference's reason,
and the launcher serves it in its one-shot mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

from _shared_codes import greedy_on_shared_codes  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "recurrentgemma_9b"
# (batch, prompt length, generated tokens)
RUNS = [(2, 48, 8), (2, 100, 40), (1, 2100, 8)]


def _run_id(run):
    return f"B{run[0]}-S{run[1]}-gen{run[2]}"


def _convert(raw):
    return params_from_reference(jax.tree.map(np.asarray, raw), "cpu")


def _pair(backend):
    """(reference config, port config): the reduced config in float32, base
    (``backend`` None) or its serve_config on ``backend``."""
    ref_cfg, cfg = ref_reduced(ARCH), get_reduced(ARCH)
    if backend is not None:
        ref_cfg = ref_serve_config(ref_cfg)
        cfg = serve_config(cfg, backend=backend)
    return ref_cfg.replace(dtype=jnp.float32), cfg.replace(
        dtype=torch.float32)


def _prompt(b, s):
    return np.random.default_rng(s).integers(0, 512, size=(b, s))


def test_config_equals_reference():
    """Every field the port keeps equals the reference's, full and
    reduced; dtypes by name."""
    for got, want in ((get_config(ARCH), ref_get_config(ARCH)),
                      (get_reduced(ARCH), ref_reduced(ARCH))):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name in ("dtype", "opt_state_dtype"):
                assert str(a).removeprefix("torch.") == jnp.dtype(b).name
            elif f.name == "quant":
                for q in dataclasses.fields(a):
                    assert getattr(a, q.name) == getattr(b, q.name), q.name
            else:
                assert a == b, f.name
        assert (got.n_repeats, got.block_tail, got.local_window, got.hd) \
            == (want.n_repeats, want.block_tail, want.local_window, want.hd)
    full, red = get_config(ARCH), get_reduced(ARCH)
    assert (full.n_repeats, full.block_tail, full.hd, full.d_ff,
            full.vocab, full.tie_embeddings) == (
        12, ("rglru", "rglru"), 256, 12288, 256000, True)
    assert (red.n_layers, red.d_model, red.n_heads, red.n_kv_heads, red.hd,
            red.local_window) == (8, 128, 4, 1, 32, 64)


@pytest.mark.parametrize("s", [48, 100])
def test_apply_rglru_matches_reference(s):
    """One RG-LRU block in f32 at prefill over ``s`` positions and one
    decode step from its cache. The
    port's recurrence runs sequentially, the reference's associative scan
    in another order: the cache h within rtol 1e-5 / atol 1e-6, y within
    atol 2e-4."""
    ref_cfg, cfg = _pair(None)
    raw = RB.init_rglru(jax.random.PRNGKey(3), ref_cfg)
    params = _convert(raw)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want_y, want_c = RB.apply_rglru(
        raw, jnp.asarray(x), ref_cfg, cache=RB.cache_rglru(ref_cfg, 2),
        prefill=True)
    cache = PB.cache_rglru(cfg, 2)
    got_y, got_c = PB.apply_rglru(params, torch.from_numpy(x), cfg,
                                  cache=cache, prefill=True)
    assert got_c is cache and got_y.shape == tuple(want_y.shape)
    np.testing.assert_allclose(got_c["h"].numpy(), np.asarray(want_c["h"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=2e-4)
    want_y, want_c = RB.apply_rglru(raw, jnp.asarray(x1), ref_cfg,
                                    cache=want_c)
    got_y, got_c = PB.apply_rglru(params, torch.from_numpy(x1), cfg,
                                  cache=cache)
    np.testing.assert_allclose(got_c["h"].numpy(), np.asarray(want_c["h"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("s", [48, 100, 2100])
def test_windowed_attention_block_matches_reference(s):
    """One local-attention block (window 64) in f32: prefill of ``s``
    positions into a rolling cache of min(s + 24, 64) slots (the prompt's
    last positions at slots p % size; above 2048 positions through
    ``attend_chunked``), then 24 decode steps, which wrap it. Each output
    within atol 2e-4, and the cache within rtol 1e-5 / atol 1e-6."""
    ref_cfg, cfg = _pair(None)
    raw = RA.init_attn(jax.random.PRNGKey(5), ref_cfg)
    params = _convert(raw)
    rng = np.random.default_rng(s + 1)
    b, max_len = 2, s + 24
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    want_c = RA.init_attn_cache(ref_cfg, b, max_len, 64)
    cache = PA.init_attn_cache(cfg, b, max_len, 64)
    assert cache["k"].shape == tuple(want_c["k"].shape)
    want_y, want_c = RA.apply_attn(raw, jnp.asarray(x), ref_cfg,
                                   positions=jnp.asarray(pos), cache=want_c,
                                   window=64, prefill=True)
    got_y, got_c = PA.apply_attn(params, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(pos),
                                 cache=cache, window=64, prefill=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=2e-4)
    for step in range(s, s + 24):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((b, 1), step)
        want_y, want_c = RA.apply_attn(raw, jnp.asarray(x1), ref_cfg,
                                       positions=jnp.asarray(p1),
                                       cache=want_c, step=step, window=64)
        got_y, got_c = PA.apply_attn(params, torch.from_numpy(x1), cfg,
                                     positions=torch.from_numpy(p1),
                                     cache=cache, step=step, window=64)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=0, atol=2e-4)
    assert got_c is cache and set(cache) == set(want_c) == {"k", "v"}
    for name, want in want_c.items():
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def cell():
    ref_cfg, cfg = _pair(None)
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, raw, Model(cfg, device="cpu"), _convert(raw)


def test_params_carry_the_tail_and_lam(cell):
    """``params_from_reference`` carries the unstacked tail and every
    RG-LRU block's ``lam`` bit for bit, in the layout ``Model.init``
    makes."""
    ref_model, raw, model, params = cell
    own = model.init(0)
    assert jax.tree.structure(jax.tree.map(np.asarray, raw)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), own))
    for where in (params["tail"]["b1"], params["blocks"]["b0"]):
        assert where["lam"].dtype == torch.float32
    np.testing.assert_array_equal(params["tail"]["b1"]["lam"].numpy(),
                                  np.asarray(raw["tail"]["b1"]["lam"]))
    np.testing.assert_array_equal(params["blocks"]["b0"]["lam"].numpy(),
                                  np.asarray(raw["blocks"]["b0"]["lam"]))
    assert params["blocks"]["b0"]["lam"].shape == (2, model.cfg.d_model)
    assert set(params["tail"]) == {"b0", "m0", "b1", "m1"}


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_prefill_logits_match(cell, run):
    """f32 prefill logits within atol 2e-4 (the dense archs' tolerance):
    the scans sum in other orders, and under int_dot a one-ulp difference
    can move one activation code by one step."""
    ref_model, raw, model, params = cell
    b, s, gen = run
    toks = _prompt(b, s)
    want, _ = ref_model.prefill(raw, {"tokens": jnp.asarray(toks)},
                                s + gen + 8)
    got, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                s + gen + 8)
    assert got.shape == tuple(want.shape) and torch.isfinite(got).all()
    assert caches["body"]["c2"]["k"].shape[2] == min(s + gen + 8, 64)
    assert caches["tail"]["c1"]["h"].shape == (b, model.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_greedy_generate_tokens_equal_reference(cell, run):
    ref_model, raw, model, params = cell
    b, s, gen = run
    toks = _prompt(b, s)
    want = np.asarray(ref_greedy_generate(
        ref_model, raw, {"tokens": jnp.asarray(toks, jnp.int32)},
        max_len=s + gen + 8, n_steps=gen))
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(toks)},
                          max_len=s + gen + 8, n_steps=gen)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def int_dot_cell():
    ref_cfg, cfg = _pair("int_dot")
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, raw, Model(cfg, device="cpu"), _convert(raw)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_int_dot_matches_reference_on_shared_codes(int_dot_cell, run,
                                                   monkeypatch):
    """The reduced W4A8 serve config on ``int_dot``: prefill and greedy
    decode of ``run``, the reference eagerly with every per-token
    quantization recorded (the PTQ linears' activations, int8 attention's
    q, k and P, the KV8 cache's rows), the port computing each of its own
    in the same order: the same shapes, codes within one step and at most
    1e-4 of them off, scales within rtol 1e-4 (the scans sum 2,100 steps
    in other orders), after which the port carries on with the
    reference's codes and scales. Then the logits of every step agree
    within atol 2e-4 and every greedy token is equal."""
    ref_model, raw, model, params = int_dot_cell
    b, s, gen = run
    got, want_logits, want_toks, _ = greedy_on_shared_codes(
        ref_model, raw, model, params, {"tokens": _prompt(b, s)},
        s + gen + 8, gen, monkeypatch)
    for (logits, tok), want, want_tok in zip(got, want_logits, want_toks):
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=2e-4)
        np.testing.assert_array_equal(tok.numpy(), want_tok)


@pytest.fixture(scope="module")
def int_dot_params():
    """The reduced serve_config's weights (the port's own draw)."""
    _, cfg = _pair("int_dot")
    return Model(cfg, device="cpu").init(0)


@pytest.mark.parametrize("backend", ["lut", "lut_cuda", "engine_torch"])
def test_other_backends_give_int_dots_tokens(backend, int_dot_params):
    """The same int32 accumulators through every backend: ``lut`` (the
    doubling LUT in torch), ``lut_cuda`` (B3's plain version on CPU
    tensors) and ``engine_torch`` (planned: its DevicePlans attached,
    the tail's included) give ``int_dot``'s tokens at 100 -> 40, decode
    wrapping the rolling cache."""
    toks = {"tokens": torch.from_numpy(_prompt(2, 100))}
    want = greedy_generate(Model(_pair("int_dot")[1], device="cpu"),
                           int_dot_params, toks, max_len=148, n_steps=40)
    model = Model(_pair(backend)[1], device="cpu")
    params = model.attach_device_plans(int_dot_params)
    got = greedy_generate(model, params, toks, max_len=148, n_steps=40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tail_linears_get_plans():
    """``precompile_plans`` and ``attach_device_plans`` on ``engine_torch``
    walk the unstacked tail as well as the stacked body: 23 stacked
    linears over 2 repeats and 16 in the tail, each with its plan."""
    from repro_torch.core import plancache
    from repro_torch.core.engine import DevicePlan
    _, cfg = _pair("engine_torch")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    prev = plancache.set_default_cache(plancache.PlanCache())
    try:
        stats = model.precompile_plans(params)
        params = model.attach_device_plans(params)
    finally:
        plancache.set_default_cache(prev)
    assert (stats["layers"], stats["plans"]) == (23 + 16, 23 * 2 + 16)
    for i in (0, 1):
        for name in ("w_x", "w_gate", "w_r", "w_i", "w_out"):
            plan = params["tail"][f"b{i}"][name]["dplan"]
            assert isinstance(plan, DevicePlan)
            assert (plan.n, plan.k) == (cfg.d_model, cfg.d_model)
        for name in ("up", "gate", "down"):
            assert isinstance(params["tail"][f"m{i}"][name]["dplan"],
                              DevicePlan)
    assert params["blocks"]["b0"]["w_x"]["dplan"].index(1).n == cfg.d_model


def test_paged_path_refuses_with_the_reference_reason(cell, capsys):
    """``supports_paged`` gives the reference's reason word for word;
    ``ServeEngine``, ``init_page_pool`` and the launcher's
    ``--continuous`` refuse on it."""
    from repro_torch.launch import serve
    ref_model, raw, model, params = cell
    reason = model.supports_paged()
    assert reason == ref_model.supports_paged() and reason is not None
    assert reason == ("block pattern ('rglru', 'rglru', 'attn') has "
                      "non-attn blocks")
    with pytest.raises(NotImplementedError, match="paged serving: block "):
        ServeEngine(model, params, max_len=16, page_size=4, device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV pool: block "):
        model.init_page_pool(4, 4)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                    "--continuous", "--device", "cpu"])
    assert f"--continuous needs the paged serve path: {reason}" in \
        capsys.readouterr().err
    # each of the other reasons, as the reference words it
    for kw in (dict(block_pattern=("attn",), block_tail=("rglru",)),
               dict(block_pattern=("attn",), block_tail=(),
                    local_window=64)):
        got = Model(model.cfg.replace(**kw), device="cpu").supports_paged()
        assert got == RefModel(ref_model.cfg.replace(**kw)).supports_paged()
        assert got is not None


def test_oneshot_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                       "--backend", "lut_cuda", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "70", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < 512)).all()
    out = capsys.readouterr().out
    assert "| W4A8+KV8/lut_cuda | one-shot | cpu] generated 2x4 tokens" in out
    assert "(max_len 82)" in out and "tok/s" in out
    assert "transitive_gemm launches=0 rg_lru launches=0" in out
