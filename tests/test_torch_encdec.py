"""Port parity: the cross-attention and encoder-decoder families,
whisper-tiny (a non-causal encoder over frame embeddings, decoder layers
of self-attention, cross-attention and a GELU MLP) and
llama-3.2-vision-90b (a cross-attention block after every four
self-attention blocks, over patch embeddings as given), against the JAX
reference.

The GELU MLP, one cross block (prefill with a context into its cache,
then decode from the cache alone) and whisper's encoder (``_encode``)
are held to the reference's in f32 within atol 2e-4. The reduced
configs in float32, with the reference's weights carried over by
``repro_torch.convert`` and the same seeded context: prefill logits
within atol 2e-4 and ``greedy_generate`` tokens equal; the decoder's
caches are capped at ``max_target_positions`` as the reference caps
them. Under a KV8 serve config the cross caches stay in the working
dtype. Both W4A8 serve configs on ``int_dot`` (whisper's with float
attention and working-dtype caches, vision's with int8 attention and
KV8 self-attention caches) give the reference's greedy tokens, and its
logits on shared activation codes (``tests/_shared_codes.py``). The paged
path refuses both with the reference's reason, and the launcher serves
them one-shot with a seeded context.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

from _shared_codes import greedy_on_shared_codes  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["whisper_tiny", "llama_3_2_vision_90b"]
PROMPT, GEN = 24, 8


def _convert(raw):
    return params_from_reference(jax.tree.map(np.asarray, raw), "cpu")


def _pair(arch, backend=None):
    """(reference config, port config): the reduced config in float32, base
    (``backend`` None) or its serve_config on ``backend``."""
    ref_cfg, cfg = ref_reduced(arch), get_reduced(arch)
    if backend is not None:
        ref_cfg = ref_serve_config(ref_cfg)
        cfg = serve_config(cfg, backend=backend)
    return ref_cfg.replace(dtype=jnp.float32), cfg.replace(
        dtype=torch.float32)


def _context(cfg, b, seed=11):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.n_context_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))
    return toks, _context(cfg, b, seed + 100)


def test_gelu_mlp_matches_reference():
    """whisper's MLP: ``up`` -> tanh-form GELU -> ``down``, no gate, in
    f32 within atol 2e-4."""
    ref_cfg, cfg = _pair("whisper_tiny")
    raw = RB.init_mlp(jax.random.PRNGKey(4), ref_cfg, gelu=True)
    params = _convert(raw)
    assert set(params) == {"norm", "up", "down"}
    own = PB.init_mlp(torch.Generator().manual_seed(0), cfg, gelu=True)
    assert set(own) == set(params)
    x = np.random.default_rng(5).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want = RB.apply_mlp(raw, jnp.asarray(x), ref_cfg)
    got = PB.apply_mlp(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("arch, backend", [
    ("whisper_tiny", None), ("llama_3_2_vision_90b", None),
    ("llama_3_2_vision_90b", "int_dot")])
def test_cross_block_matches_reference(arch, backend):
    """One cross block: a prefill of 7 positions against the context (K/V
    projected from it, written to the cross cache, every query attending
    to every context position, no RoPE), then 4 decode steps from the
    cache alone. f32 (float attention; with ``int_dot``, vision's serve
    config: int8 attention, KV8 self caches): outputs within atol 2e-4,
    the cross cache equal to the reference's within 1e-6 and in the
    working dtype."""
    ref_cfg, cfg = _pair(arch, backend)
    raw = RA.init_attn(jax.random.PRNGKey(6), ref_cfg, cross=True)
    params = _convert(raw)
    b, sq = 2, 7
    rng = np.random.default_rng(12)
    x = rng.standard_normal((b, sq, cfg.d_model)).astype(np.float32)
    ctx = _context(cfg, b)
    pos = np.broadcast_to(np.arange(sq), (b, sq)).copy()
    want_c = RA.init_attn_cache(ref_cfg, b, cfg.n_context_tokens,
                                cross=True)
    cache = PA.init_attn_cache(cfg, b, cfg.n_context_tokens, cross=True)
    assert set(cache) == {"k", "v"} and cache["k"].dtype == torch.float32
    want_y, want_c = RA.apply_attn(raw, jnp.asarray(x), ref_cfg,
                                   positions=jnp.asarray(pos), cache=want_c,
                                   context=jnp.asarray(ctx), prefill=True)
    got_y, got_c = PA.apply_cross(params, torch.from_numpy(x), cfg,
                                  cache=cache, context=torch.from_numpy(ctx))
    assert got_c is cache
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=2e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_c[name]), rtol=0,
                                   atol=1e-6)
    stub = jnp.zeros((b, cfg.n_context_tokens, cfg.d_model), jnp.float32)
    for step in range(sq, sq + 4):
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((b, 1), step)
        want_y, want_c = RA.apply_attn(raw, jnp.asarray(x1), ref_cfg,
                                       positions=jnp.asarray(p1),
                                       cache=want_c, step=step,
                                       context=stub)
        got_y, _ = PA.apply_cross(params, torch.from_numpy(x1), cfg,
                                  cache=cache)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=0, atol=2e-4)


def test_cross_cache_stays_in_the_working_dtype_under_kv8():
    """vision's serve config (bf16, KV8): self-attention caches hold int8
    codes and f32 scales, the cross caches bf16 of n_context_tokens
    positions, as the reference's ``init_cache`` makes them."""
    ref_cfg = ref_serve_config(ref_reduced("llama_3_2_vision_90b"))
    cfg = serve_config(get_reduced("llama_3_2_vision_90b"))
    assert cfg.kv_cache_bits == 8 and cfg.quant_attention
    want = RefModel(ref_cfg).init_cache(2, 40)["body"]
    got = Model(cfg, device="cpu").init_cache(2, 40)["body"]
    for c in ("c0", "c3", "c4"):
        assert set(got[c]) == set(want[c])
        for name, w in want[c].items():
            assert tuple(got[c][name].shape) == w.shape, (c, name)
            assert str(got[c][name].dtype).removeprefix("torch.") == \
                jnp.dtype(w.dtype).name, (c, name)
    assert got["c4"]["k"].dtype == torch.bfloat16
    assert got["c4"]["k"].shape[2] == cfg.n_context_tokens
    assert got["c0"]["k"].dtype == torch.int8


@pytest.fixture(scope="module", params=ARCHS)
def cell(request):
    ref_cfg, cfg = _pair(request.param)
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, raw, Model(cfg, device="cpu"), _convert(raw)


def test_params_layout(cell):
    """``Model.init`` makes the reference's tree: whisper's stacked
    encoder (2 reduced layers, each attention + GELU MLP), ``enc_norm``
    and an MLP after the cross block only; vision's untied unembedding
    and an MLP after every block."""
    ref_model, raw, model, params = cell
    own = model.init(0)
    assert jax.tree.structure(jax.tree.map(np.asarray, raw)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), own))
    cfg = model.cfg
    if cfg.is_encdec:
        assert set(own["blocks"]) == {"b0", "b1", "m1"}
        assert set(own["encoder"]) == {"b0", "m0"}
        assert "gate" not in own["encoder"]["m0"]
        assert own["encoder"]["b0"]["wq"]["w"].shape[0] == 2
    else:
        assert set(own["blocks"]) == {f"{k}{i}" for k in "bm"
                                      for i in range(5)}
        assert "unembed" in own and "encoder" not in own


def test_encode_matches_reference():
    """whisper's encoder (non-causal self-attention with RoPE at
    positions 0..n-1, GELU MLPs, ``enc_norm``) over 64 seeded frames:
    within atol 2e-4."""
    ref_cfg, cfg = _pair("whisper_tiny")
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(1))
    frames = _context(cfg, 2)
    want = ref_model._encode(raw, jnp.asarray(frames))
    got = Model(cfg, device="cpu")._encode(_convert(raw),
                                           torch.from_numpy(frames))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_prefill_logits_match(cell):
    ref_model, raw, model, params = cell
    toks, ctx = _batch(model.cfg, 2, PROMPT, 1)
    want, _ = ref_model.prefill(raw, {"tokens": jnp.asarray(toks),
                                      "context": jnp.asarray(ctx)}, 40)
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                    "context": torch.from_numpy(ctx)}, 40)
    assert got.shape == tuple(want.shape) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_greedy_generate_tokens_equal_reference(cell):
    ref_model, raw, model, params = cell
    toks, ctx = _batch(model.cfg, 2, PROMPT, 2)
    want = np.asarray(ref_greedy_generate(
        ref_model, raw, {"tokens": jnp.asarray(toks, jnp.int32),
                         "context": jnp.asarray(ctx)},
        max_len=PROMPT + GEN + 8, n_steps=GEN))
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(toks),
                                          "context": ctx},
                          max_len=PROMPT + GEN + 8, n_steps=GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_context_changes_the_tokens(cell):
    """The cross blocks read the context: another context gives other
    logits; a batch without one is refused."""
    _, _, model, params = cell
    toks, ctx = _batch(model.cfg, 2, PROMPT, 3)
    a, _ = model.prefill(params, {"tokens": toks, "context": ctx}, 40)
    b, _ = model.prefill(params, {"tokens": toks, "context": ctx * 3}, 40)
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="needs 'context'"):
        model.prefill(params, {"tokens": toks}, 40)


def test_max_target_positions_caps_the_caches():
    """whisper's decoder caches hold at most ``max_target_positions``
    positions (64 reduced) whatever ``max_len`` asks, as the reference's;
    the cross caches hold the context's; within the cap the tokens equal
    the reference's at ``max_len`` 100."""
    ref_cfg, cfg = _pair("whisper_tiny")
    assert cfg.max_target_positions == ref_cfg.max_target_positions == 64
    ref_model = RefModel(ref_cfg)
    model = Model(cfg, device="cpu")
    want = ref_model.init_cache(2, 100)["body"]
    got = model.init_cache(2, 100)["body"]
    assert got["c0"]["k"].shape == want["c0"]["k"].shape == (2, 2, 64, 4, 32)
    assert got["c1"]["k"].shape == want["c1"]["k"].shape
    raw = ref_model.init(jax.random.PRNGKey(0))
    toks, ctx = _batch(cfg, 2, 50, 4)
    ref = np.asarray(ref_greedy_generate(
        ref_model, raw, {"tokens": jnp.asarray(toks, jnp.int32),
                         "context": jnp.asarray(ctx)}, max_len=100,
        n_steps=10))
    port = greedy_generate(model, _convert(raw), {"tokens": toks,
                                                  "context": ctx},
                           max_len=100, n_steps=10)
    np.testing.assert_array_equal(port.numpy(), ref)
    with pytest.raises(ValueError, match="exceeds the cache"):
        model.prefill(_convert(raw), {"tokens": np.zeros((1, 65), int),
                                      "context": ctx[:1]}, 100)


@pytest.mark.parametrize("arch", ARCHS)
def test_int_dot_serve_config_matches_reference(arch, monkeypatch):
    """The W4A8 serve config on ``int_dot`` (whisper: float attention and
    working-dtype caches; vision: int8 attention, KV8 self caches, the
    cross cache in the working dtype) in f32. Free-running, the greedy
    tokens equal the reference's; vision's prefill logits part by ~0.01,
    as much as the reference's jitted run parts from its own eager one (a
    code moved by one step where two float paths part by an ulp). So the
    logits are held on shared codes (``tests/_shared_codes.py``): every
    step's within atol 2e-4, every token equal."""
    ref_cfg, cfg = _pair(arch, "int_dot")
    assert cfg.quant_attention == ref_cfg.quant_attention == (
        arch != "whisper_tiny")
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    model, params = Model(cfg, device="cpu"), _convert(raw)
    toks, ctx = _batch(cfg, 2, PROMPT, 5)
    want = np.asarray(ref_greedy_generate(
        ref_model, raw, {"tokens": jnp.asarray(toks, jnp.int32),
                         "context": jnp.asarray(ctx)},
        max_len=PROMPT + GEN + 8, n_steps=GEN))
    got = greedy_generate(model, params, {"tokens": toks, "context": ctx},
                          max_len=PROMPT + GEN + 8, n_steps=GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    got, want_logits, want_toks, _ = greedy_on_shared_codes(
        ref_model, raw, model, params, {"tokens": toks, "context": ctx},
        PROMPT + GEN + 8, GEN, monkeypatch)
    for (logits, tok), want, want_tok in zip(got, want_logits, want_toks):
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=2e-4)
        np.testing.assert_array_equal(tok.numpy(), want_tok)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["lut", "lut_cuda", "engine_torch"])
def test_other_backends_give_int_dots_tokens(arch, backend):
    """``lut``, ``lut_cuda`` (B3's plain version on CPU tensors) and
    ``engine_torch`` (planned: the encoder's linears too) give
    ``int_dot``'s tokens on the port's own reduced weights."""
    base = Model(_pair(arch, "int_dot")[1], device="cpu")
    params = base.init(0)
    toks, ctx = _batch(base.cfg, 2, 20, 6)
    batch = {"tokens": toks, "context": ctx}
    want = greedy_generate(base, params, batch, max_len=36, n_steps=6)
    model = Model(_pair(arch, backend)[1], device="cpu")
    attached = model.attach_device_plans(params)
    if backend == "engine_torch" and model.cfg.is_encdec:
        assert attached["encoder"]["m0"]["up"]["dplan"].index(1).n == \
            model.cfg.d_ff
    got = greedy_generate(model, attached, batch, max_len=36, n_steps=6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_paged_path_refuses_with_the_reference_reason(cell, capsys):
    """``supports_paged`` gives the reference's reasons word for word (the
    pattern's cross block first; a context on an attention-only pattern
    next); ``ServeEngine`` and ``--continuous`` refuse on them."""
    from repro_torch.launch import serve
    ref_model, raw, model, params = cell
    reason = model.supports_paged()
    assert reason == ref_model.supports_paged() and reason.startswith(
        "block pattern (") and reason.endswith("has non-attn blocks")
    with pytest.raises(NotImplementedError, match="paged serving: block "):
        ServeEngine(model, params, max_len=16, page_size=4, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", model.cfg.name, "--reduced", "--continuous",
                    "--device", "cpu"])
    assert f"--continuous needs the paged serve path: {reason}" in \
        capsys.readouterr().err
    kw = dict(block_pattern=("attn",), n_layers=2, mlp_after=None)
    got = Model(model.cfg.replace(**kw), device="cpu").supports_paged()
    assert got == RefModel(ref_model.cfg.replace(**kw)).supports_paged() \
        == "cross-attention context caches are not paged"


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_oneshot_launcher_runs_on_cpu(arch, capsys):
    """The one-shot launcher draws a seeded context of (batch,
    n_context_tokens, d_model) and generates through the cross blocks."""
    from repro_torch.launch import serve
    toks = serve.main(["--arch", arch, "--reduced", "--backend", "lut_cuda",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "20", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < 512)).all()
    out = capsys.readouterr().out
    assert "| W4A8+KV" in out and "one-shot | cpu] generated 2x4" in out
    batch = serve.oneshot_batch(Model(get_reduced(arch), device="cpu"), 2,
                                20, 0)
    assert batch["context"].shape == (2, 64, 128)
    assert batch["context"].dtype == torch.float32


def test_config_fields_cover_the_reference():
    """The port's ModelConfig keeps every field the three new configs
    read; the reference's ``seq_shard`` (training's sequence-parallel
    activations, set by vision) is the one it leaves out."""
    from repro.configs.base import ModelConfig as RefConfig
    from repro_torch.configs.base import ModelConfig as PortConfig
    port = {f.name for f in dataclasses.fields(PortConfig)}
    assert {"n_context_tokens", "encoder_layers", "max_target_positions",
            "mlp_after"} <= port
    assert "seq_shard" not in port and "seq_shard" in {
        f.name for f in dataclasses.fields(RefConfig)}
