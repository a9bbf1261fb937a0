"""Port parity: the training path (QAT's ``fake_quant``, AdamW, the
cosine schedule, the synthetic data, one train step, the RG-LRU's
gradient through B5's wrapper, the loop's crash-and-resume, the
entry points) against the JAX reference.

Tolerances: ``fake_quant``'s forward is exact (the quantizer's codes and
scales are the reference's); the QAT linear's gradients within rtol
1e-5 (f32 matmuls in another order); two AdamW updates within 1e-6 of
the reference's (f32 arithmetic in the reference's order; ``b ** count``
and the square root may part by an ulp); the schedule within rtol 1e-6;
the data bit-equal. One train step on reduced smollm in f32: loss within
2e-4 (``test_torch_loss``'s bound), grad_norm within rtol 1e-4, lr
exact, the updated params within 1e-6 of the reference's. B5's backward
is held to ``torch.autograd.gradcheck`` in float64 with eps 1e-2, atol
1e-4 and rtol 1e-3 (the plain version computes in f32, as the kernel
does: a float64 finite difference sees f32 rounding over eps, ~1e-5 at
eps 1e-2 and 1.4e-3 at 1e-4; the recurrence is a polynomial of degree
S in a, so a wide central difference stays exact to ~1e-5 at S=7), and
to the gradient of the reference's ``associative_scan`` within rtol 1e-4
/ atol 1e-5 (f32, another order of products). A run crashed and resumed from its checkpoint ends within
2e-4 of the straight run (the reference's bar).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.quant.quantize as RQ  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.quant import QuantConfig as RefQuantConfig  # noqa: E402
from repro.quant import fake_quant as ref_fake_quant  # noqa: E402
from repro.quant import linear_apply as ref_linear_apply  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
import repro_torch.quant.quantize as PQ  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.distributed.fault import run_with_restarts  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rg_lru as K  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.quant import QuantConfig, fake_quant, linear_apply  # noqa: E402,E501
from repro_torch.train import train_step as PT  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the configs' training knobs -------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_training_knobs_equal_reference(arch):
    """remat, grad_accum, the moments' dtype (by name) and the factored
    second moment, full and reduced (reduced: no remat, one microbatch)."""
    for got, want in ((get_config(arch), ref_get_config(arch)),
                      (get_reduced(arch), ref_reduced(arch))):
        assert (got.remat, got.grad_accum, got.factored_second_moment) == (
            want.remat, want.grad_accum, want.factored_second_moment)
        assert str(got.opt_state_dtype).removeprefix("torch.") == \
            jnp.dtype(want.opt_state_dtype).name
    assert (get_reduced(arch).remat, get_reduced(arch).grad_accum) == (
        "none", 1)
    opt = PT.make_optimizer(get_config(arch))
    assert (opt.moment_dtype == torch.bfloat16) == opt.factored_v == (
        arch == "llama4_maverick_400b_a17b")


# ---- fake_quant and QAT ----------------------------------------------------

@pytest.mark.parametrize("bits,group", [(4, 64), (8, 32), (4, 128)])
def test_fake_quant_forward_equals_reference_and_ste_is_identity(bits,
                                                                 group):
    x = np.random.default_rng(bits + group).standard_normal(
        (6, 128)).astype(np.float32)
    want = np.asarray(ref_fake_quant(jnp.asarray(x), bits, group))
    xt = _t(x).requires_grad_(True)
    got = fake_quant(xt, bits, group)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.randn(6, 128, dtype=torch.float32)
    (dx,) = torch.autograd.grad(got, xt, g)
    assert torch.equal(dx, g)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert fake_quant(bf, bits, group).dtype == torch.bfloat16
    q, sc = PQ.quantize_groupwise(_t(x), bits, group)
    rq, rs = RQ.quantize_groupwise(jnp.asarray(x), bits, group)
    np.testing.assert_array_equal(
        PQ.dequantize_groupwise(q, sc, group).numpy(),
        np.asarray(RQ.dequantize_groupwise(rq, rs, group)))
    np.testing.assert_array_equal(
        PQ.dequantize(q, sc[..., :1]).numpy(),
        np.asarray(RQ.dequantize(rq, rs[..., :1])))


def test_qat_linear_grads_match_reference():
    """The port's counterpart of ``tests/test_quant.py::test_qat_ste_grads``:
    the QAT linear's gradients of mean(y^2) in w and x against
    ``jax.grad`` on the same weights."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((32, 64)) / 8).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    rcfg = RefQuantConfig(mode="qat", w_bits=4, group=64)
    want_w, want_x = jax.grad(
        lambda pw, px: (ref_linear_apply({"w": pw}, px, rcfg) ** 2).mean(),
        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    pw, px = _t(w).requires_grad_(True), _t(x).requires_grad_(True)
    cfg = QuantConfig(mode="qat", w_bits=4, group=64)
    y = linear_apply({"w": pw}, px, cfg)
    gw, gx = torch.autograd.grad((y ** 2).mean(), (pw, px))
    assert gw.abs().sum() > 0 and torch.isfinite(gw).all()
    np.testing.assert_allclose(gw.numpy(), np.asarray(want_w), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_x), rtol=1e-5,
                               atol=1e-7)


def test_unknown_quant_mode_still_raises():
    with pytest.raises(NotImplementedError, match="unknown quant mode"):
        linear_apply({"w": torch.ones(2, 2)}, torch.ones(1, 2),
                     QuantConfig(mode="awq"))


# ---- AdamW and the schedule ------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)

    def a(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    params = {"embed": a(16, 8), "norm": a(8), "blocks": {"w": a(3, 4, 8),
                                                          "b": a(3, 8)}}
    grads = {"embed": a(16, 8, s=0.5), "norm": a(8, s=0.5),
             "blocks": {"w": a(3, 4, 8, s=0.5), "b": a(3, 8, s=0.5)}}
    return params, grads


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float32), tree)


@pytest.mark.parametrize("form", ["plain", "bf16_moments", "factored_v"])
def test_adamw_updates_equal_reference(form):
    """Two updates (bias corrections at count 1 and 2; the gradients'
    norm above clip_norm, so clipping acts) in three forms."""
    kw = {"plain": {}, "bf16_moments": {"moment_dtype": "bf16"},
          "factored_v": {"factored_v": True}}[form]
    ref_kw = {k: (jnp.bfloat16 if v == "bf16" else v) for k, v in kw.items()}
    pt_kw = {k: (torch.bfloat16 if v == "bf16" else v)
             for k, v in kw.items()}
    ref_opt, opt = RefAdamW(**ref_kw), AdamW(**pt_kw)
    params, _ = _opt_tree(0)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    pp = jax.tree.map(_t, params)
    ps = opt.init(pp)
    for i, lr in enumerate((1e-2, 3e-3)):
        _, grads = _opt_tree(i + 1)
        rp, rs = ref_opt.update(jax.tree.map(jnp.asarray, grads), rs, rp,
                                jnp.float32(lr))
        pp, ps = opt.update(jax.tree.map(_t, grads), ps, pp,
                            torch.tensor(lr, dtype=torch.float32))
    assert int(ps["count"]) == 2
    for want, got in ((rp, pp), (rs["m"], ps["m"]), (rs["v"], ps["v"])):
        for w, g in zip(jax.tree.leaves(_np(want)),
                        jax.tree.leaves(_np(jax.tree.map(
                            lambda t: t.float().numpy(), got)))):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    if form == "factored_v":
        assert set(ps["v"]["blocks"]["w"]) == {"r", "c"}
        assert ps["v"]["norm"].shape == (8,)
    if form == "bf16_moments":
        assert ps["m"]["embed"].dtype == torch.bfloat16


def test_cosine_schedule_equals_reference():
    ref, got = ref_cosine(3e-4, 10, 200), cosine_schedule(3e-4, 10, 200)
    for step in (0, 1, 9, 10, 11, 105, 199, 200, 250):
        want = float(ref(jnp.int32(step)))
        assert abs(float(got(step)) - want) <= 1e-6 * abs(want), step
        t = got(torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32


# ---- data ------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("smollm_135m", 1),
                                        ("smollm_135m", 4),
                                        ("llama_3_2_vision_90b", 2)])
def test_synthetic_lm_equals_reference(arch, accum):
    ref = RefSyntheticLM(ref_reduced(arch), 24, 8, seed=5)
    got = SyntheticLM(get_reduced(arch), 24, 8, seed=5, device="cpu")
    np.testing.assert_array_equal(got.succ, ref.succ)
    for step in (0, 1, 2):
        want, have = ref.batch(step, accum), got.batch(step, accum)
        assert set(have) == set(want)
        for k, v in want.items():
            assert tuple(have[k].shape) == v.shape
            np.testing.assert_array_equal(have[k].numpy(), np.asarray(v))
    assert ("context" in have) == (arch != "smollm_135m")


# ---- one train step --------------------------------------------------------

def test_train_step_equals_reference():
    """Two train steps on reduced smollm (2 layers, f32, grad_accum 2): the
    first at lr 0 (warm-up), the second moves the params."""
    ref_cfg = ref_reduced("smollm_135m").replace(
        n_layers=2, dtype=jnp.float32, grad_accum=2)
    cfg = get_reduced("smollm_135m").replace(n_layers=2,
                                             dtype=torch.float32,
                                             grad_accum=2)
    ref_model = RefModel(ref_cfg)
    ref_opt = RT.make_optimizer(ref_cfg)
    ref_state = RT.init_state(ref_model, ref_opt, jax.random.PRNGKey(0))
    ref_step = jax.jit(RT.make_train_step(ref_model, ref_opt,
                                          ref_cosine(1e-3, 1, 10)))
    model = Model(cfg, device="cpu")
    opt = PT.make_optimizer(cfg)
    params = params_from_reference(
        jax.tree.map(np.asarray, ref_state["params"]), "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step_fn = PT.make_train_step(model, opt, cosine_schedule(1e-3, 1, 10))
    ref_data = RefSyntheticLM(ref_cfg, 16, 4, seed=0)
    data = SyntheticLM(cfg, 16, 4, seed=0, device="cpu")
    for step in range(2):
        ref_state, want = ref_step(ref_state, ref_data.batch(step, 2))
        state, got = step_fn(state, data.batch(step, 2))
        assert abs(float(got["loss"]) - float(want["loss"])) <= 2e-4
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-4)
        assert float(got["lr"]) == float(want["lr"])
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    for w, g in zip(jax.tree.leaves(ref_state["params"]),
                    leaves(state["params"])):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6)


# ---- the RG-LRU's gradient -------------------------------------------------

def test_rg_lru_grad_passes_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 7, 5), generator=gen, dtype=torch.float64)
    a = torch.rand((2, 7, 5), generator=gen, dtype=torch.float64) * 0.5 \
        + 0.45
    h0 = torch.randn((2, 5), generator=gen, dtype=torch.float64)
    args = tuple(t.requires_grad_(True) for t in (x, a, h0))
    assert torch.autograd.gradcheck(K.rg_lru, args, eps=1e-2, atol=1e-4,
                                    rtol=1e-3)


def test_rg_lru_grad_matches_the_reference_scan():
    """dx, da from the reference's associative scan (the reference's
    training path for the RG-LRU) under ``jax.grad``, for h0 = 0."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 40, 16)).astype(np.float32)
    a = rng.uniform(0.5, 0.999, (3, 40, 16)).astype(np.float32)
    w = rng.standard_normal((3, 40, 16)).astype(np.float32)

    def ref_loss(xx, aa):
        _, h = jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (aa, xx), axis=1)
        return jnp.sum(h * w)
    want_x, want_a = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(a))
    xt, at = _t(x).requires_grad_(True), _t(a).requires_grad_(True)
    h = ops.rg_lru(xt, at, torch.zeros((3, 16)))
    gx, ga = torch.autograd.grad((h * _t(w)).sum(), (xt, at))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_a), rtol=1e-4,
                               atol=1e-5)


def test_rglru_block_gradients_reach_every_weight(monkeypatch):
    """One RG-LRU block: the gradients of lam, w_r, w_i, w_x (which reach
    the loss only through B5's output) are nonzero and equal the
    reference's; the backward goes through ``rg_lru_grad`` once. A cut
    graph would leave them None or zero."""
    ref_cfg = ref_reduced("recurrentgemma_9b").replace(dtype=jnp.float32)
    cfg = get_reduced("recurrentgemma_9b").replace(dtype=torch.float32)
    raw = RB.init_rglru(jax.random.PRNGKey(3), ref_cfg)
    x = np.random.default_rng(4).standard_normal((2, 12, 128)).astype(
        np.float32)
    want = jax.grad(lambda p: jnp.sum(RB.apply_rglru(
        p, jnp.asarray(x), ref_cfg)[0] ** 2))(raw)
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    flat = {"lam": params["lam"], "w_r": params["w_r"]["w"],
            "w_i": params["w_i"]["w"], "w_x": params["w_x"]["w"]}
    for t in flat.values():
        t.requires_grad_(True)
    calls = []
    grad = K.rg_lru_grad
    monkeypatch.setattr(K, "rg_lru_grad",
                        lambda *a: calls.append(1) or grad(*a))
    y, _ = PB.apply_rglru(params, _t(x), cfg)
    got = torch.autograd.grad((y ** 2).sum(), list(flat.values()))
    assert calls == [1]
    for name, g, w in zip(flat, got, (want["lam"], want["w_r"]["w"],
                                      want["w_i"]["w"], want["w_x"]["w"])):
        w = np.asarray(w)
        assert g is not None and float(g.abs().sum()) > 0, name
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w), \
            name


# ---- the loop and the entry points -----------------------------------------

def _tiny():
    return get_reduced("smollm_135m").replace(n_layers=2)


def test_crash_and_resume_is_exact(tmp_path):
    """A run crashed at step 5 and resumed from its step-4 checkpoint (bf16
    params, f32 moments) ends at the straight run's loss (2e-4)."""
    kw = dict(seq_len=16, global_batch=4, steps=8, lr=1e-3, device="cpu")
    _, h1 = train(_tiny(), **kw)
    d = str(tmp_path / "ck")
    starts = []

    def loop(attempt):
        _, hist = train(_tiny(), ckpt_dir=d, ckpt_every=2,
                        fail_at_step=5 if attempt == 0 else None, **kw)
        starts.append(hist[0]["step"])
        return hist
    h2, restarts = run_with_restarts(loop, max_restarts=2)
    assert restarts == 1 and starts == [4]
    assert [h["step"] for h in h2] == [4, 5, 6, 7]
    np.testing.assert_allclose(h2[-1]["loss"], h1[-1]["loss"], rtol=2e-4,
                               atol=2e-4)
    assert h1[-1]["loss"] < h1[0]["loss"]


def test_launch_train_and_train_lm_run_on_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch
    hist, restarts = launch.main(
        ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--steps",
         "3", "--seq", "16", "--batch", "4", "--ckpt",
         str(tmp_path / "a")])
    assert len(hist) == 3 and restarts == 0
    assert "done: loss" in capsys.readouterr().out
    assert (tmp_path / "a" / "metrics.jsonl").exists()
    hist, restarts = train_lm.main(["--steps", "4", "--device", "cpu",
                                    "--ckpt", str(tmp_path / "b"),
                                    "--inject-failure"])
    assert restarts == 1 and hist[-1]["step"] == 3


def test_entry_points_refuse_the_cpu_when_not_asked(monkeypatch, tmp_path):
    from repro_torch.examples import quantize_eval
    from repro_torch.launch import train as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_tiny(), seq_len=8, global_batch=2, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_eval.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(_tiny(), 8, 2)
