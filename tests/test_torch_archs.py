"""Port parity: the four dense architectures beside smollm-135m
(``llama1_7b``, ``qwen3_14b``, ``mistral_nemo_12b``, ``chatglm3_6b``)
against the JAX reference.

The port registers all eleven reference architectures. Each dense arch's
registered config, and each of the xLSTM, encoder-decoder and
cross-attention ones', equals the reference's on every field the port
keeps. Its reduced ``serve_config`` (W4A8 per-channel PTQ, dynamic
int8 attention, KV8 pool) in float32 is built in both packages with the
reference's weights carried over by ``repro_torch.convert``; the
reference runs its ``int_dot`` backend and the gather decode path, the
port ``lut_cuda`` (the doubling-LUT GEMM's plain version on CPU tensors:
the same int32 accumulators) with ``paged_kernel=True`` (the kernel
wrapper's plain version on CPU tensors). The port is held to: prefill
logits within atol 2e-4, ``greedy_generate`` tokens and ``ServeEngine``
tokens on a staggered, prefix-sharing workload equal to the reference's.

The reference's ``reduced`` caps heads at 4, so at reduced size qwen3 and
mistral have one query head per KV head and chatglm3 two. Three
variants keep the published head ratios, built by the same ``replace``
in both packages: mistral's 4 (8 heads over 2), qwen3's 5 (10 over 2)
and chatglm3's 16 (16 over 1); their heads times head_dim (32) differ
from d_model (128), as mistral-nemo's published 32 x 128 differs from
its 5120.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch.specs import serve_config as ref_serve_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.configs import ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401

DENSE = ["llama1_7b", "qwen3_14b", "mistral_nemo_12b", "chatglm3_6b"]
# the xLSTM, encoder-decoder and cross-attention families
NEW = ["xlstm_125m", "whisper_tiny", "llama_3_2_vision_90b"]
# (arch, heads, KV heads): the published query heads per KV head
VARIANTS = [("mistral_nemo_12b", 8, 2), ("qwen3_14b", 10, 2),
            ("chatglm3_6b", 16, 1)]
CASES = [(a, None) for a in DENSE] + [(a, (h, kv)) for a, h, kv in VARIANTS]
MAX_LEN, PAGE, GEN = 24, 4, 5


def _case_id(case):
    arch, heads = case
    return arch if heads is None else f"{arch}-H{heads[0]}-KV{heads[1]}"


def test_the_four_dense_archs_are_registered():
    """The port registers the reference's eleven architectures (the four
    dense ones among them), each under its hyphenated name too, and
    ``Model`` takes every one."""
    assert ARCHS[0] == "smollm_135m" and sorted(ARCHS) == sorted(REF_ARCHS)
    assert len(ARCHS) == 11 and set(DENSE + NEW) < set(ARCHS)
    for arch in ARCHS:
        cfg = get_config(arch)
        assert get_config(cfg.name) == get_config(arch.replace("_", "-")) \
            == cfg
        Model(get_reduced(arch), device="cpu")


@pytest.mark.parametrize("arch", DENSE + NEW)
def test_config_equals_reference(arch):
    """Every field of the port's ModelConfig (the quant config's too) equals
    the reference's, full and reduced; dtypes compared by name."""
    for got, want in ((get_config(arch), ref_get_config(arch)),
                      (get_reduced(arch), ref_reduced(arch))):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name in ("dtype", "opt_state_dtype"):
                assert str(a).removeprefix("torch.") == jnp.dtype(b).name
            elif f.name == "quant":
                for q in dataclasses.fields(a):
                    assert getattr(a, q.name) == getattr(b, q.name), q.name
            else:
                assert a == b, f.name
        assert (got.n_repeats, got.hd, got.is_encdec) == (
            want.n_repeats, want.hd, want.is_encdec)
    for reduce in (get_reduced, ref_reduced):
        r = reduce(arch)
        assert (r.d_model, r.head_dim, r.grad_accum) == (128, 32, 1)
        assert r.n_layers == (2 if arch in DENSE
                              else 2 * len(r.block_pattern))


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def cell(request):
    arch, heads = request.param
    ref_cfg = ref_serve_config(ref_reduced(arch)).replace(dtype=jnp.float32)
    cfg = serve_config(get_reduced(arch), backend="lut_cuda").replace(
        dtype=torch.float32, paged_kernel=True)
    if heads is not None:
        kw = dict(n_heads=heads[0], n_kv_heads=heads[1])
        ref_cfg, cfg = ref_cfg.replace(**kw), cfg.replace(**kw)
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    return ref_model, raw, model, params


def test_variant_and_reduced_shapes(cell):
    """The cell runs the head ratio it claims, and its untied unembedding,
    qk-norm and partial RoPE flags reach the port's params and config."""
    ref_model, raw, model, params = cell
    cfg = model.cfg
    assert cfg.n_heads // cfg.n_kv_heads == (ref_model.cfg.n_heads
                                             // ref_model.cfg.n_kv_heads)
    assert ("unembed" in params) == (not cfg.tie_embeddings)
    assert ("q_norm" in params["blocks"]["b0"]) == cfg.qk_norm
    wq = params["blocks"]["b0"]["wq"]["qw"]
    assert wq.shape[1:] == (cfg.n_heads * cfg.hd, cfg.d_model)


def test_prefill_logits_match(cell):
    """f32 prefill logits: integer GEMMs and int8 attention products are
    exact in both packages, but f32 norms (qk-norm too), RoPE (chatglm3's
    partial one too), softmax and the unembedding sum in other orders, and
    a one-ulp difference can move one activation code by one step; the
    logits (O(0.1)) are held to atol 2e-4."""
    ref_model, raw, model, params = cell
    toks = np.random.default_rng(1).integers(0, 512, size=(2, 7))
    want, _ = ref_model.prefill(raw, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           MAX_LEN)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_greedy_generate_tokens_equal_reference(cell):
    ref_model, raw, model, params = cell
    toks = np.random.default_rng(2).integers(0, 512, size=(2, 6))
    want = np.asarray(ref_greedy_generate(
        ref_model, raw, {"tokens": jnp.asarray(toks, jnp.int32)},
        max_len=MAX_LEN, n_steps=GEN))
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(toks)},
                          max_len=MAX_LEN, n_steps=GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def _serve(engine, prompts):
    """Submit one prompt per step (staggered arrivals), run to the end."""
    for p in prompts:
        engine.submit(p, GEN)
        engine.step()
    engine.run()
    return {r.rid: list(r.tokens) for r in engine.finished}


def test_serve_engine_tokens_equal_reference(cell):
    """The port's ServeEngine (paged decode through the kernel wrapper,
    prefix sharing, bucketed prefill) against the reference's on the
    gather path: the same tokens and the same sharing counters."""
    ref_model, raw, model, params = cell
    rng = np.random.default_rng(7)
    base = rng.integers(0, 512, size=9).tolist()
    prompts = [base, base[:4] + rng.integers(0, 512, size=5).tolist(),
               base, rng.integers(0, 512, size=3).tolist(), base]
    ref_eng = RefServeEngine(ref_model, raw, n_slots=2, max_len=MAX_LEN,
                             page_size=PAGE, paged_kernel=False)
    want = _serve(ref_eng, prompts)
    eng = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN,
                      page_size=PAGE, paged_kernel=True, device="cpu")
    assert _serve(eng, prompts) == want
    for key in ("pages_shared", "prefix_hits", "prefill_skipped",
                "prefill_computed", "decode_tokens"):
        assert eng.counters[key] == ref_eng.counters[key], key
