"""Port parity: the examples ``quickstart`` and ``serve_lm``, the serving
step factories ``make_prefill`` / ``make_decode_step``, and the
launcher's ``--path``, ``--no-bucket-prefill`` and ``--no-precompile``
(and its refusal of ``--mesh``), on the CPU. ``--lint`` is held in
``tests/test_torch_planlint.py``.

The quickstart's numbers are held exactly to the reference's modules on
the same arrays (step 4 to the reference's Pallas kernel in interpret
mode). The factories and ``ServeEngine(bucket_prefill=False)`` run the
reduced float32 smollm on the reference's converted weights, tokens
equal to the reference's. The launcher's flags run on the reduced model
with the port's own weights: tokens equal across the flags.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.core import bitslice as ref_bitslice  # noqa: E402
from repro.core import transitive as ref_transitive  # noqa: E402
from repro.core.patterns import tile_stats as ref_tile_stats  # noqa: E402
from repro.core.scoreboard import (  # noqa: E402
    dynamic_scoreboard as ref_dynamic_scoreboard)
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.train import serve_step as ref_serve_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import plancache  # noqa: E402
from repro_torch.examples import quickstart, serve_lm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import (greedy_generate,  # noqa: E402
                                          make_decode_step, make_prefill)

SMALL = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
         "--prompt-len", "8", "--gen", "4", "--page-size", "4",
         "--continuous"]


@pytest.fixture
def cache():
    c = plancache.PlanCache()
    prev = plancache.set_default_cache(c)
    yield c
    plancache.set_default_cache(prev)


# -- the examples ----------------------------------------------------------------

def test_quickstart_equals_reference_modules(capsys):
    q = quickstart.main("cpu")
    assert "bit-exact" in capsys.readouterr().out
    w, x = q["w"], q["x"]
    rows = ref_bitslice.transrow_matrix(w, bits=4, t=8)
    assert q["rows_shape"] == rows.shape == (4, 64, 8)
    st = ref_tile_stats(ref_dynamic_scoreboard(
        rows.transpose(2, 0, 1).reshape(8, -1), t=8))
    assert q["density"] == float(st.density.mean())
    assert q["patterns"] == {p: float(getattr(st, p).mean())
                             for p in ("pr", "fr", "tr", "zr")}
    np.testing.assert_array_equal(
        q["out"], ref_transitive.transitive_gemm(w, x, bits=4, t=8))
    want = np.asarray(ref_ops.transitive_gemm(
        jnp.asarray(x.T, jnp.int8), jnp.asarray(w, jnp.int8), w_bits=4,
        t=8))
    assert q["out_kernel"].dtype == torch.int32
    np.testing.assert_array_equal(q["out_kernel"].numpy(), want)


def test_serve_lm_runs_and_its_integer_paths_agree(capsys):
    """The example on the CPU: both models generate 4 x 8 tokens, the
    lossless check passes, and its W4A8 model gives the same tokens on
    the transitive backends as on int_dot."""
    ex = serve_lm.main("cpu")
    out = capsys.readouterr().out
    assert "int-dot == lut path" in out and "weights differ" in out
    for key in ("tokens_fp", "tokens_q"):
        toks = ex[key]
        assert toks.shape == (4, 8) and toks.dtype == torch.int32
        assert ((toks >= 0) & (toks < ex["model_q"].cfg.vocab)).all()
    np.testing.assert_allclose(ex["y_dot"].numpy(), ex["y_lut"].numpy(),
                               rtol=1e-5)
    mq = ex["model_q"]
    assert mq.cfg.quant.mode == "ptq" and mq.cfg.quant.backend == "int_dot"
    for backend in ("lut", "lut_cuda"):
        cfg = mq.cfg.replace(quant=mq.cfg.quant.with_(backend=backend))
        toks = greedy_generate(Model(cfg, device="cpu"), ex["params_q"],
                               ex["batch"], max_len=64, n_steps=8)
        assert torch.equal(toks, ex["tokens_q"]), backend


def test_serve_lm_config_equals_reference():
    ex_cfg = serve_config(get_reduced("chatglm3_6b").replace(
        dtype=torch.float32))
    ref_cfg = ref_serve_config(ref_reduced("chatglm3_6b").replace(
        dtype=jnp.float32))
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "quant_attention", "kv_cache_bits"):
        assert getattr(ex_cfg, f) == getattr(ref_cfg, f), f
    for f in ("mode", "w_bits", "a_bits", "group"):
        assert getattr(ex_cfg.quant, f) == getattr(ref_cfg.quant, f), f


# -- make_prefill / make_decode_step ---------------------------------------------

@pytest.fixture(scope="module", params=["fp", "w4a8"])
def cell(request):
    """The reduced smollm in float32, unquantized or W4A8 on int_dot, the
    reference's weights converted for the port."""
    ref_cfg = ref_reduced("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_reduced("smollm_135m").replace(dtype=torch.float32)
    if request.param == "w4a8":
        ref_cfg, cfg = ref_serve_config(ref_cfg), serve_config(cfg)
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   "cpu")
    return ref_model, ref_params, model, params


def _loop(prefill, step, params, tokens, gen, prompt_len, as_step, argmax,
          cat):
    logits, caches = prefill(params, {"tokens": tokens})
    tok = argmax(logits)
    out = [tok]
    for i in range(gen - 1):
        logits, caches = step(params, caches, tok, as_step(prompt_len + i))
        tok = argmax(logits)
        out.append(tok)
    return cat(out), logits


def test_step_factories_equal_reference(cell):
    """A greedy loop over the factories: tokens equal to the reference's
    loop over its own factories and to ``greedy_generate``; the last
    step's logits within 2e-4."""
    ref_model, ref_params, model, params = cell
    toks = np.random.default_rng(5).integers(0, 512, size=(3, 7))
    max_len, gen = 20, 6
    want, want_logits = _loop(
        ref_serve_step.make_prefill(ref_model, max_len),
        ref_serve_step.make_decode_step(ref_model), ref_params,
        jnp.asarray(toks, jnp.int32), gen, 7, jnp.int32,
        lambda lg: jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None],
        lambda ts: np.asarray(jnp.concatenate(ts, axis=1)))
    got, got_logits = _loop(
        make_prefill(model, max_len), make_decode_step(model), params,
        torch.from_numpy(toks), gen, 7, int,
        lambda lg: torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None],
        lambda ts: torch.cat(ts, dim=1))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=2e-4)
    assert torch.equal(got, greedy_generate(
        model, params, {"tokens": torch.from_numpy(toks)}, max_len, gen))


def test_per_request_prefill_equals_reference_engine(cell):
    """``ServeEngine(bucket_prefill=False)`` on the launcher's workload
    (prefix-sharing prompts, one arrival every 2 host steps): tokens equal
    to the reference engine's with ``bucket_prefill=False`` and to the
    port's bucketed engine."""
    ref_model, ref_params, model, params = cell
    prompts = serve.prefix_sharing_prompts(model.cfg.vocab, 5, 8, seed=1)
    kw = dict(n_slots=2, max_len=12, page_size=4)

    def drive(eng):
        submitted = host_step = 0
        while submitted < len(prompts) or eng.queue or eng.active:
            if submitted < len(prompts) and host_step >= submitted * 2:
                eng.submit(prompts[submitted], 4)
                submitted += 1
            eng.step()
            host_step += 1
        return {r.rid: list(r.tokens) for r in eng.finished}

    want = drive(RefServeEngine(ref_model, ref_params, bucket_prefill=False,
                                **kw))
    got = drive(ServeEngine(model, params, bucket_prefill=False,
                            device="cpu", **kw))
    bucketed = drive(ServeEngine(model, params, device="cpu", **kw))
    assert got == want == bucketed


# -- the launcher's flags ------------------------------------------------------------

def _tokens(eng):
    return {r.rid: r.tokens for r in eng.finished}


def test_path_is_a_deprecated_alias_of_backend(capsys, cache):
    base = serve.main(SMALL + ["--backend", "lut"])
    assert base.model.cfg.quant.backend == "lut"
    with pytest.warns(DeprecationWarning, match="--path is deprecated"):
        alias = serve.main(SMALL + ["--path", "lut"])
    assert alias.model.cfg.quant.backend == "lut"
    assert _tokens(alias) == _tokens(base)
    with pytest.warns(DeprecationWarning, match="--path is deprecated"):
        both = serve.main(SMALL + ["--backend", "lut", "--path",
                                   "engine_torch"])
    assert both.model.cfg.quant.backend == "lut"      # --backend wins
    assert cache.stats()["misses"] == 0                # nothing planned
    default = serve.main(SMALL)
    assert default.model.cfg.quant.backend == "int_dot"
    out = capsys.readouterr().out
    assert "W4A8+KV8/lut |" in out and "W4A8+KV8/int_dot |" in out
    assert _tokens(default) == _tokens(base)


@pytest.mark.parametrize("backend", ["lut", "engine_torch"])
def test_no_bucket_prefill_serves_the_same_tokens(capsys, backend):
    bucketed = serve.main(SMALL + ["--backend", backend, "--paged-kernel"])
    assert "prefill=bucketed" in capsys.readouterr().out
    single = serve.main(SMALL + ["--backend", backend, "--paged-kernel",
                                 "--no-bucket-prefill"])
    assert "prefill=per-request" in capsys.readouterr().out
    assert bucketed.bucket_prefill and not single.bucket_prefill
    assert bucketed.counters["prefill_batched_calls"] > 0
    assert single.counters["prefill_batched_calls"] == 0
    assert single.counters["prefill_calls"] == 4
    assert _tokens(single) == _tokens(bucketed)


@pytest.mark.parametrize("backend", ["engine_torch", "engine_cuda"])
def test_no_precompile_builds_each_plan_in_attach(capsys, monkeypatch,
                                                  backend):
    """Without --no-precompile the plans are built by the precompile; with
    it none is precompiled and every plan is built inside attach, as many
    as before (one per stacked weight slice), none while serving; the
    tokens are the same."""
    calls = {"precompile": 0, "attach": 0}
    precompile, attach = plancache.precompile, plancache.attach_device_plans

    def counted_precompile(*a, **k):
        calls["precompile"] += 1
        return precompile(*a, **k)

    def counted_attach(*a, **k):
        m0 = plancache.default_cache().stats()["misses"]
        out = attach(*a, **k)
        calls["attach"] += plancache.default_cache().stats()["misses"] - m0
        return out
    monkeypatch.setattr(plancache, "precompile", counted_precompile)
    monkeypatch.setattr(plancache, "attach_device_plans", counted_attach)
    misses, toks = [], []
    for extra in ([], ["--no-precompile"]):
        c = plancache.PlanCache()
        prev = plancache.set_default_cache(c)
        try:
            toks.append(_tokens(serve.main(SMALL + ["--backend", backend]
                                           + extra)))
        finally:
            plancache.set_default_cache(prev)
        misses.append(c.stats()["misses"])
    assert calls == {"precompile": 1, "attach": 14}
    assert misses == [14, 14]
    assert "no precompile: attach built 14 plans" in capsys.readouterr().out
    assert toks[0] == toks[1]


@pytest.mark.parametrize("argv, message", [
    (["--mesh", "data=4"], "--mesh is not ported.*item A10"),
])
def test_launcher_refuses_flags_not_ported(capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        serve.main(SMALL + argv)
    assert e.value.code == 2
    assert re.search(message, capsys.readouterr().err)
