"""Port parity: the MoE family (``moonshot_v1_16b_a3b``: 64 experts top-6;
``llama4_maverick_400b_a17b``: 128 experts top-1 plus a shared expert)
against the JAX reference.

Each config equals the reference's on every field the port keeps, and
their reduced variants keep the reference's cut (at most 8 experts, top-k
at most 2). The MoE block (``models.blocks.apply_moe``) runs on the same
numpy input and the reference's weights carried over by
``repro_torch.convert`` (the generic tree walk, no special case), in
float32 within atol 2e-4, and its router picks the experts
``jax.lax.top_k`` picks. The reduced ``serve_config`` of both archs in
float32 (reference: ``int_dot`` + gather decode; port: ``lut_cuda`` +
``paged_kernel``, the plain versions on CPU tensors): prefill logits
within atol 2e-4, ``greedy_generate`` and ``ServeEngine`` tokens equal to
the reference's. ``Model.init`` fills its stacked blocks repeat by
repeat and gives the same bits as stacking the per-repeat draws.
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
from repro.models import blocks as RB  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.train.serve_step import (  # noqa: E402
    greedy_generate as ref_greedy_generate)
from repro_torch.configs import ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch.specs import serve_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402

MOE = ["moonshot_v1_16b_a3b", "llama4_maverick_400b_a17b"]
MAX_LEN, PAGE, GEN = 24, 4, 5


def _carry(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree), "cpu")


def test_the_moe_archs_are_registered():
    for arch in MOE:
        assert arch in ARCHS
        assert get_config(arch.replace("_", "-")) == get_config(arch)


@pytest.mark.parametrize("arch", MOE)
def test_config_equals_reference(arch):
    """Every field of the port's ModelConfig (the quant config's too)
    equals the reference's; dtypes compared by name."""
    got, want = get_config(arch), ref_get_config(arch)
    assert got.family == "moe"
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(a).removeprefix("torch.") == jnp.dtype(b).name
        elif f.name == "quant":
            for q in dataclasses.fields(a):
                assert getattr(a, q.name) == getattr(b, q.name), q.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("arch,experts,top_k,shared", [
    ("moonshot_v1_16b_a3b", 8, 2, 0), ("llama4_maverick_400b_a17b", 8, 1, 1)])
def test_reduced_shapes(arch, experts, top_k, shared):
    """The reference's reduced cut: at most 8 experts, top-k at most 2
    (llama4 keeps its top-1 and its shared expert), two layers of width
    128; the port's reduced config equals it field by field."""
    for r in (get_reduced(arch), ref_reduced(arch)):
        assert (r.n_experts, r.top_k, r.n_shared_experts) == (
            experts, top_k, shared)
        assert (r.n_layers, r.d_model, r.d_ff, r.head_dim) == (2, 128, 256,
                                                               32)
    got, want = get_reduced(arch), ref_reduced(arch)
    for f in dataclasses.fields(got):
        if f.name not in ("dtype", "quant"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    params = Model(get_reduced(arch), device="cpu").init(0)
    moe = params["blocks"]["m0"]
    assert moe["w_gate"].shape == moe["w_up"].shape == (2, experts, 128, 256)
    assert moe["w_down"].shape == (2, experts, 256, 128)
    assert moe["router"].shape == (2, 128, experts)
    assert ("shared" in moe) == bool(shared)


def _block(arch, serve, seed):
    """(reference cfg, port cfg, reference params, port params) of one MoE
    block at reduced size in float32; ``serve`` takes the serve configs
    (the shared expert's W4A8 linears: ``int_dot`` / ``lut_cuda``)."""
    ref_cfg = ref_reduced(arch).replace(dtype=jnp.float32)
    cfg = get_reduced(arch).replace(dtype=torch.float32)
    if serve:
        ref_cfg = ref_serve_config(ref_cfg)
        cfg = serve_config(cfg, backend="lut_cuda")
    raw = RB.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, raw, _carry(raw)


@pytest.mark.parametrize("arch,shape,serve", [
    ("moonshot_v1_16b_a3b", (1, 1), False),
    ("moonshot_v1_16b_a3b", (2, 16), False),
    ("llama4_maverick_400b_a17b", (2, 16), False),
    ("llama4_maverick_400b_a17b", (2, 16), True)],
    ids=["moonshot-one-token", "moonshot-2x16", "llama4-shared-2x16",
         "llama4-shared-w4a8-2x16"])
def test_apply_moe_matches_reference(arch, shape, serve):
    """``apply_moe`` against the reference's on the same input and the
    carried-over weights, f32: the products and the gate-weighted combine
    sum in other orders (atol 2e-4). The router's expert ids equal the
    reference's ``jax.lax.top_k`` of its softmax, and its gates agree to
    f32 rounding. The MoE leaves carry over bit for bit."""
    ref_cfg, cfg, raw, params = _block(arch, serve, seed=3)
    for name in ("norm", "router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(raw[name]))
    assert ("shared" in params) == ("shared" in raw)
    x = np.random.default_rng(4).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    want = np.asarray(RB.apply_moe(raw, jnp.asarray(x), ref_cfg))
    got = B.apply_moe(params, torch.from_numpy(x), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    xn = RB.rms_norm(jnp.asarray(x), raw["norm"], ref_cfg.norm_eps)
    logits = xn.astype(jnp.float32) @ raw["router"].astype(jnp.float32)
    ref_gates, ref_ids = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                       ref_cfg.top_k)
    _, gates, ids = B.route(params, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    ref_gates = ref_gates / jnp.maximum(ref_gates.sum(-1, keepdims=True),
                                        1e-9)
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref_gates),
                               rtol=1e-6, atol=1e-7)


def test_moe_combine_adds_slots_in_order():
    """Each token's K expert outputs come back in (token, slot) order and
    are added slot by slot: the combine equals an explicit per-token loop
    over the slots bit for bit, on bf16 inputs (where the order of the
    adds shows)."""
    g = torch.Generator().manual_seed(5)
    n, k, d, f, e = 6, 3, 16, 8, 5
    x = torch.randn((n, d), generator=g).to(torch.bfloat16)
    wg, wu = (torch.randn((e, d, f), generator=g).to(torch.bfloat16)
              for _ in range(2))
    wd = torch.randn((e, f, d), generator=g).to(torch.bfloat16)
    ids = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(n)])
    gates = torch.rand((n, k), generator=g).to(torch.bfloat16)
    got = B._moe_local(x, gates, ids, wg, wu, wd)
    for t in range(n):
        acc = None
        for j in range(k):
            ex = int(ids[t, j])
            h = torch.nn.functional.silu(x[t:t + 1] @ wg[ex]) * (
                x[t:t + 1] @ wu[ex])
            o = (h @ wd[ex]) * gates[t, j]
            acc = o if acc is None else acc + o
        assert torch.equal(got[t:t + 1], acc), t


@pytest.fixture(scope="module", params=MOE)
def cell(request):
    arch = request.param
    ref_cfg = ref_serve_config(ref_reduced(arch)).replace(dtype=jnp.float32)
    cfg = serve_config(get_reduced(arch), backend="lut_cuda").replace(
        dtype=torch.float32, paged_kernel=True)
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    return ref_model, raw, model, _carry(raw)


def test_moe_is_paged_and_carries_over(cell):
    """The family is served paged (``supports_paged`` is None in both
    packages) and its stacked MoE leaves carry over bit for bit."""
    ref_model, raw, model, params = cell
    assert model.supports_paged() is None and ref_model.supports_paged() \
        is None
    want = jax.tree.map(np.asarray, raw["blocks"]["m0"])
    got = params["blocks"]["m0"]
    for name in ("norm", "router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    if "shared" in want:
        for name in ("up", "gate", "down"):
            for leaf in ("qw", "sg"):
                np.testing.assert_array_equal(
                    got["shared"][name][leaf].numpy(),
                    want["shared"][name][leaf])


def test_prefill_logits_match(cell):
    """f32 prefill logits within atol 2e-4: the attention's integer GEMMs
    are exact in both packages; norms, softmax, the experts' products and
    the unembedding sum in other orders."""
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
    prefix sharing, bucketed prefill: the MoE block sees padded rows
    there) against the reference's on the gather path: the same tokens
    and the same sharing counters."""
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


@pytest.mark.parametrize("arch,layers", [
    ("smollm_135m", None), ("recurrentgemma_9b", None),
    ("moonshot_v1_16b_a3b", None), ("llama4_maverick_400b_a17b", None),
    ("llama4_maverick_400b_a17b", 1)])
def test_init_fills_the_stack_bit_identically(arch, layers):
    """``Model.init`` on the CPU allocates each stacked leaf once and fills
    it repeat by repeat (one repeat: a view of its draw); its params
    equal, bit for bit and leaf by leaf, an explicit ``torch.stack`` of
    the per-repeat draws made in the same order from the same generator
    (the embedding first, the unembedding and the tail after the
    blocks)."""
    cfg = serve_config(get_reduced(arch), backend="lut_cuda")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg, device="cpu")
    got = model.init(7)
    gen = torch.Generator().manual_seed(7)
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=gen)
             * 0.02).to(cfg.dtype)
    draws = [model._init_superblock(gen, model.pattern)
             for _ in range(cfg.n_repeats)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    want = {"embed": embed, "blocks": stack(draws)}
    if not cfg.tie_embeddings:
        want["unembed"] = (torch.randn((cfg.vocab, cfg.d_model),
                                       generator=gen) * 0.02).to(cfg.dtype)
    if cfg.block_tail:
        want["tail"] = model._init_superblock(gen, cfg.block_tail)
    flat_got = dict(_leaves(got))
    flat_want = dict(_leaves(want))
    assert set(flat_got) == set(flat_want) | {("final_norm",)}
    for key, a in flat_want.items():
        b = flat_got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b), key


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_launcher_serves_moonshot_on_cpu(capsys):
    """``--arch moonshot-v1-16b-a3b --continuous`` serves through
    ServeEngine (the family is paged), here at reduced size on the CPU."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                      "--continuous", "--device", "cpu", "--backend",
                      "lut_cuda", "--paged-kernel", "--prompt-len", "8",
                      "--gen", "3", "--page-size", "4", "--requests", "3"])
    assert [len(r.tokens) for r in eng.finished] == [3, 3, 3]
    assert eng.counters["pages_shared"] > 0
    out = capsys.readouterr().out
    assert "moonshot-v1-16b-a3b | W4A8+KV8/lut_cuda | continuous | cpu]" \
        in out
