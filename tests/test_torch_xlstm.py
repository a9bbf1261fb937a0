"""Port parity: xlstm-125m (mLSTM and sLSTM blocks, no MLP) against the
JAX reference.

One mLSTM block (``apply_mlstm``) is held to the reference's in f32 at a
prefill of 32 positions (one chunk of ``MLSTM_CHUNK``), 128 (two chunks:
the loop over chunk summaries runs) and 100 (not a multiple of 64: one
chunk of 100, as the reference falls back), then 8 decode steps from its
cache; one sLSTM block (``apply_slstm``, a loop over positions) the same
way. The reduced config in float32 is built in both packages with the
reference's weights carried over by ``repro_torch.convert``: prefill
logits within atol 2e-4 and ``greedy_generate`` tokens equal, and the
reference's own property ``prefill(s) == prefill(s - k) + k decode
steps`` (``tests/test_models.py``) holds on the port.

The W4A8 ``serve_config`` on ``int_dot`` quantizes every activation per
token; the recurrences carry a one-step code difference from an
ulp-level float difference to every later position (free-running, the
reduced model's prefill logits part by up to 6e-4 at 128 positions), so
it is held on shared codes (``tests/_shared_codes.py``): codes within
one step, at most 1e-4 of them off; then the logits of every step agree
within atol 2e-4 and every greedy token is equal. Every integer backend
of the port gives ``int_dot``'s tokens. The paged serve path refuses the config with the reference's reason,
and the launcher serves it in its one-shot mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

from _shared_codes import greedy_on_shared_codes  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "xlstm_125m"
# (batch, prompt length, generated tokens): one chunk, two chunks, and a
# length that is not a multiple of the chunk (one chunk of 100)
RUNS = [(2, 32, 8), (2, 128, 8), (1, 100, 12)]
# the W4A8 runs on shared codes, where the reference runs eagerly: one
# chunk of 32 (S not a multiple of 64), one chunk of 64, two chunks
INT_RUNS = [(2, 32, 8), (2, 64, 4), (2, 128, 8)]


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


def _close_tree(got, want, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   err_msg=name, **tol)


BLOCKS = {"mlstm": (RB.init_mlstm, RB.cache_mlstm, RB.apply_mlstm,
                    PB.cache_mlstm, PB.apply_mlstm),
          "slstm": (RB.init_slstm, RB.cache_slstm, RB.apply_slstm,
                    PB.cache_slstm, PB.apply_slstm)}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
@pytest.mark.parametrize("s", [32, 128, 100])
def test_block_matches_reference(kind, s):
    """One block in f32: prefill of ``s`` positions into its cache, then 8
    decode steps from it. The port's einsums and loops sum in other
    orders than XLA's: every output and the cache after each call within
    atol 2e-4 (rtol 2e-4 on the cache, whose mLSTM C grows with the
    positions summed), the cache written in place."""
    ref_init, ref_cache, ref_apply, port_cache, port_apply = BLOCKS[kind]
    ref_cfg, cfg = _pair(None)
    raw = ref_init(jax.random.PRNGKey(7), ref_cfg)
    params = _convert(raw)
    rng = np.random.default_rng(s)
    b = 2
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    want_y, want_c = ref_apply(raw, jnp.asarray(x), ref_cfg,
                               cache=ref_cache(ref_cfg, b), prefill=True)
    cache = port_cache(cfg, b)
    got_y, got_c = port_apply(params, torch.from_numpy(x), cfg, cache=cache,
                              prefill=True)
    assert got_c is cache and got_y.shape == tuple(want_y.shape)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=2e-4)
    _close_tree(cache, want_c, rtol=2e-4, atol=2e-4)
    for _ in range(8):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want_y, want_c = ref_apply(raw, jnp.asarray(x1), ref_cfg,
                                   cache=want_c)
        got_y, got_c = port_apply(params, torch.from_numpy(x1), cfg,
                                  cache=cache)
        assert got_c is cache
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=0, atol=2e-4)
        _close_tree(cache, want_c, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_without_cache_matches_reference(kind):
    """The cache-free pass (the reference's training mode): the chunkwise
    mLSTM from a zero state, the sLSTM loop from zeros; y within atol
    2e-4 and no cache returned."""
    ref_init, _, ref_apply, _, port_apply = BLOCKS[kind]
    ref_cfg, cfg = _pair(None)
    raw = ref_init(jax.random.PRNGKey(8), ref_cfg)
    x = np.random.default_rng(9).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want, _ = ref_apply(raw, jnp.asarray(x), ref_cfg)
    got, cache = port_apply(_convert(raw), torch.from_numpy(x), cfg)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_log_sigmoid_is_the_references_beyond_softplus_threshold():
    """``log_f = -softplus(-x)`` with JAX's softplus (``logaddexp(x, 0)``)
    at every input, where torch's ``softplus`` switches to the identity
    above 20: within 1e-6 of ``jax.nn.log_sigmoid``'s form."""
    x = np.linspace(-60, 60, 2401, dtype=np.float32)
    want = np.asarray(-jax.nn.softplus(-jnp.asarray(x)))
    got = PB._log_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mlstm_key_scale_rounds_to_the_working_dtype():
    """In bf16 the key scale hd^-0.5 multiplies the linear's bf16 output
    after being rounded to bf16 (a JAX weak-typed scalar): the port's k
    equals the reference's bit for bit on the same q/k/v weights."""
    ref_cfg = ref_reduced(ARCH)
    cfg = get_reduced(ARCH)
    raw = RB.init_mlstm(jax.random.PRNGKey(2), ref_cfg)
    x = np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    _, want_k, _, _, _ = RB._mlstm_proj(raw, xj, ref_cfg)
    _, got_k, _, _, _ = PB._mlstm_proj(
        _convert(raw), torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got_k.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got_k.float().numpy(), np.asarray(want_k.astype(jnp.float32)))


@pytest.fixture(scope="module")
def cell():
    ref_cfg, cfg = _pair(None)
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, raw, Model(cfg, device="cpu"), _convert(raw)


def test_params_layout_and_caches(cell):
    """``Model.init`` makes the reference's tree (two stacked repeats of
    an mLSTM and an sLSTM block, no MLP, tied embedding); the caches hold
    the reference's shapes and dtypes."""
    ref_model, raw, model, params = cell
    own = model.init(0)
    assert jax.tree.structure(jax.tree.map(np.asarray, raw)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), own))
    assert set(own["blocks"]) == {"b0", "b1"} and "unembed" not in own
    assert own["blocks"]["b0"]["w_if"]["w"].shape == (2, 8, 128)
    want = ref_model.init_cache(2, 40)
    got = model.init_cache(2, 40)
    for c in ("c0", "c1"):
        for name, w in want["body"][c].items():
            assert tuple(got["body"][c][name].shape) == w.shape, name
            assert got["body"][c][name].dtype == torch.float32


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_prefill_logits_match(cell, run):
    ref_model, raw, model, params = cell
    b, s, gen = run
    toks = _prompt(b, s)
    want, _ = ref_model.prefill(raw, {"tokens": jnp.asarray(toks)},
                                s + gen + 8)
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           s + gen + 8)
    assert got.shape == tuple(want.shape) and torch.isfinite(got).all()
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


@pytest.mark.parametrize("s, split", [(32, 24), (128, 100)])
def test_prefill_equals_prefill_then_decode(cell, s, split):
    """The reference's own property on the port: the logits of a prefill
    of s positions equal those of a prefill of ``split`` positions and
    s - split decode steps, within rtol/atol 2e-4 (at 128 the full prefill
    takes two chunks, the split one one chunk of 100)."""
    _, _, model, params = cell
    toks = torch.from_numpy(_prompt(2, s))
    full, _ = model.prefill(params, {"tokens": toks}, s + 8)
    logits, caches = model.prefill(params, {"tokens": toks[:, :split]},
                                   s + 8)
    for i in range(split, s):
        logits, caches = model.decode_step(params, caches, toks[:, i:i + 1],
                                           i)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.fixture(scope="module")
def int_dot_cell():
    ref_cfg, cfg = _pair("int_dot")
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, raw, Model(cfg, device="cpu"), _convert(raw)


@pytest.mark.parametrize("run", INT_RUNS, ids=_run_id)
def test_int_dot_matches_reference_on_shared_codes(int_dot_cell, run,
                                                   monkeypatch):
    """The reduced W4A8 serve config on ``int_dot``: prefill and greedy
    decode of ``run``, the reference eagerly with every per-token
    quantization recorded (the PTQ linears' activations: the mLSTM's five,
    the sLSTM's eight a position and ``w_out``), the port computing each
    of its own in the same order: the same shapes, codes within one step
    and at most 1e-4 of them off, scales within rtol 1e-4, after which the
    port carries on with the reference's codes and scales. Then the
    logits of every step agree within atol 2e-4 and every greedy token is
    equal."""
    ref_model, raw, model, params = int_dot_cell
    b, s, gen = run
    got, want_logits, want_toks, n_codes = greedy_on_shared_codes(
        ref_model, raw, model, params, {"tokens": _prompt(b, s)},
        s + gen + 8, gen, monkeypatch)
    # 2 repeats x (5 mLSTM linears + 8 per position and w_out in the sLSTM)
    per_decode = 2 * (5 + 9)
    assert n_codes == 2 * (5 + 8 * s + 1) + (gen - 1) * per_decode
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
    tensors) and ``engine_torch`` (planned, every linear's DevicePlan
    attached, ``w_if``'s 8 outputs included) give ``int_dot``'s tokens at
    20 -> 6 (one chunk of 20: the sLSTM's per-position linears make the
    plain LUT paths slow on the CPU)."""
    toks = {"tokens": torch.from_numpy(_prompt(2, 20))}
    want = greedy_generate(Model(_pair("int_dot")[1], device="cpu"),
                           int_dot_params, toks, max_len=34, n_steps=6)
    model = Model(_pair(backend)[1], device="cpu")
    params = model.attach_device_plans(int_dot_params)
    if backend == "engine_torch":
        assert params["blocks"]["b0"]["w_if"]["dplan"].n == 8
    got = greedy_generate(model, params, toks, max_len=34, n_steps=6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_paged_path_refuses_with_the_reference_reason(cell, capsys):
    """``supports_paged`` gives the reference's reason word for word;
    ``ServeEngine``, ``init_page_pool`` and the launcher's
    ``--continuous`` refuse on it."""
    from repro_torch.launch import serve
    ref_model, raw, model, params = cell
    reason = model.supports_paged()
    assert reason == ref_model.supports_paged() == (
        "block pattern ('mlstm', 'slstm') has non-attn blocks")
    with pytest.raises(NotImplementedError, match="paged serving: block "):
        ServeEngine(model, params, max_len=16, page_size=4, device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV pool: block "):
        model.init_page_pool(4, 4)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "xlstm-125m", "--reduced", "--continuous",
                    "--device", "cpu"])
    assert f"--continuous needs the paged serve path: {reason}" in \
        capsys.readouterr().err


def test_oneshot_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "xlstm-125m", "--reduced", "--backend",
                       "lut_cuda", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "20", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < 512)).all()
    out = capsys.readouterr().out
    assert "| W4A8+KV8/lut_cuda | one-shot | cpu] generated 2x4 tokens" in out
    assert "(max_len 32)" in out
    assert "transitive_forest launches=0 transitive_gemm launches=0" in out
