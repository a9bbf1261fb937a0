"""Port parity: ``Model.loss`` and its gradients (the training path)
against the JAX reference, for all eleven reduced architectures.

Each reduced config in float32 (quant mode ``none``) is built in both
packages with the reference's weights carried over by
``repro_torch.convert``; one seeded batch (B=2, S=16 tokens and labels,
and seeded context embeddings where the config has cross blocks) goes
through the reference's ``jax.value_and_grad(Model.loss)`` and the
port's ``Model.loss`` under autograd. The loss agrees within 2e-4 (f32
norms, softmax, the recurrences and the logsumexp sum in other orders);
each gradient leaf within a norm-relative error of 1e-3. The port's
remat (``torch.utils.checkpoint`` of each super-block) gives the loss
and the gradients of the run without it, bit for bit.

The W4A8 PTQ loss (the accuracy example's perplexity) on ``int_dot`` is
held on the reference's activation codes (``tests/_shared_codes.py``'s
method): free-running, a code moved by one step (an ulp-level float
difference) moves the loss too; on shared codes it agrees within 2e-4,
and every integer backend of the port gives ``int_dot``'s loss exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.quant.quantize as RQ  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.quant import QuantConfig as RefQuantConfig  # noqa: E402
from repro.quant import quantize_groupwise as ref_quantize_groupwise  # noqa: E402,E501
import repro_torch.quant.quantize as PQ  # noqa: E402
from repro_torch.configs import ARCHS, get_reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.examples.quantize_eval import quantize_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.quant import QuantConfig  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401

B, S = 2, 16


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_context_tokens or cfg.is_encdec:
        out["context"] = (rng.standard_normal(
            (B, cfg.n_context_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _port_value_and_grad(model, params, batch):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), dict(zip(_flat(params), grads))


@pytest.fixture(scope="module", params=ARCHS)
def cell(request):
    arch = request.param
    ref_cfg = ref_reduced(arch).replace(dtype=jnp.float32)
    cfg = get_reduced(arch).replace(dtype=torch.float32)
    assert cfg.remat == ref_cfg.remat == "none"
    ref_model = RefModel(ref_cfg)
    raw = ref_model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    want_loss, want_g = jax.jit(jax.value_and_grad(ref_model.loss))(
        raw, {k: jnp.asarray(v) for k, v in batch.items()})
    want_g = {k: np.asarray(v) for k, v in _flat(want_g).items()}

    runs = {}

    def port(remat):
        if remat not in runs:
            model = Model(cfg.replace(remat=remat), device="cpu")
            params = params_from_reference(jax.tree.map(np.asarray, raw),
                                           "cpu")
            runs[remat] = _port_value_and_grad(model, params, batch)
        return runs[remat]
    return float(want_loss), want_g, port


def test_loss_matches_reference(cell):
    want, _, port = cell
    got, _ = port("none")
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 2e-4, (float(got), want)


def test_gradients_match_reference(cell):
    """Every leaf gets a gradient (stacked leaves collect every repeat's
    share; the RG-LRU's lam through B5's backward), each within a
    norm-relative error of 1e-3 of the reference's. A leaf whose true
    gradient is 0 (llama4's top-1 router: one gate renormalized is 1
    whatever the router) has rounding noise in both packages: its
    reference norm is below 1e-6 of the whole gradient's, and the port's
    must be too."""
    _, want, port = cell
    _, got = port("none")
    assert set(got) == set(want)
    total = np.sqrt(sum(np.sum(np.square(w.astype(np.float64)))
                        for w in want.values()))
    for key, g in got.items():
        w = want[key]
        assert tuple(g.shape) == w.shape, key
        g = g.numpy().astype(np.float64)
        if np.linalg.norm(w) < 1e-6 * total:
            assert np.linalg.norm(g) < 1e-6 * total, key
            continue
        err = np.linalg.norm(g - w)
        assert err <= 1e-3 * np.linalg.norm(w), (key, err,
                                                 np.linalg.norm(w))


def test_remat_gives_the_same_loss_and_gradients(cell):
    _, _, port = cell
    loss, grads = port("none")
    loss_r, grads_r = port("block")
    assert torch.equal(loss, loss_r)
    for key, g in grads.items():
        assert torch.equal(g, grads_r[key]), key


def _ptq_pair(bits):
    """(reference model, its PTQ params, port model, port params, batch):
    reduced smollm in f32 with its linears quantized group-wise (group 64)
    by each package's own quantizer, as the accuracy example does."""
    ref_cfg = ref_reduced("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_reduced("smollm_135m").replace(dtype=torch.float32)
    raw = RefModel(ref_cfg).init(jax.random.PRNGKey(1))

    def ref_q(tree):
        if isinstance(tree, dict) and "w" in tree and tree["w"].ndim >= 2:
            w = tree["w"]
            qw, sg = ref_quantize_groupwise(w.reshape(-1, w.shape[-1]),
                                            bits, 64)
            return {"qw": qw.reshape(w.shape),
                    "sg": sg.reshape(w.shape[:-1] + (-1,))}
        if isinstance(tree, dict):
            return {k: ref_q(v) for k, v in tree.items()}
        return tree
    ref_params = {**raw, "blocks": ref_q(raw["blocks"])}
    params = params_from_reference(jax.tree.map(np.asarray, raw), "cpu")
    params = {**params, "blocks": quantize_params(params, bits)["blocks"]}
    for a, b in zip(jax.tree.leaves(ref_params["blocks"]),
                    leaves(params["blocks"])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    q = dict(mode="ptq", w_bits=bits, a_bits=8, group=64)
    return (RefModel(ref_cfg.replace(quant=RefQuantConfig(**q))), ref_params,
            cfg.replace(quant=QuantConfig(**q)), params, _batch(cfg, 5))


@pytest.mark.parametrize("bits", [8, 4])
def test_ptq_loss_matches_reference_on_shared_codes(bits, monkeypatch):
    ref_model, ref_params, cfg, params, batch = _ptq_pair(bits)
    codes = []
    ref_quantize = RQ.quantize_per_token

    def record(x, bits=8):
        q, scale = ref_quantize(x, bits)
        codes.append((np.asarray(q), np.asarray(scale)))
        return q, scale
    monkeypatch.setattr(RQ, "quantize_per_token", record)
    with jax.disable_jit():
        want = float(ref_model.loss(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    monkeypatch.undo()
    port_quantize = PQ.quantize_per_token
    seen = {"calls": 0, "off": 0, "codes": 0}

    def shared(x, bits=8):
        q, scale = port_quantize(x, bits)
        rq, rs = codes[seen["calls"]]
        seen["calls"] += 1
        off = np.abs(q.numpy().astype(np.int64) - rq.astype(np.int64))
        assert off.max() <= 1
        seen["off"] += int((off > 0).sum())
        seen["codes"] += off.size
        np.testing.assert_allclose(scale.numpy(), rs, rtol=1e-4, atol=0)
        return torch.from_numpy(rq.copy()), torch.from_numpy(rs.copy())
    monkeypatch.setattr(PQ, "quantize_per_token", shared)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = float(Model(cfg, device="cpu").loss(params, tb))
    monkeypatch.undo()
    assert seen["calls"] == len(codes) > 0
    assert seen["off"] <= 1e-4 * seen["codes"], seen
    assert abs(got - want) <= 2e-4, (got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("backend", ["lut", "lut_cuda", "engine_torch",
                                     "engine_cuda"])
def test_ptq_loss_is_the_same_on_every_integer_backend(backend, bits):
    """The transitive backends give int_dot's int32 accumulators, so the
    PTQ loss is int_dot's exactly (the accuracy example's "identical =>
    lossless"), at W8A8 and W4A8: the group epilogue sums each backend's
    partials in one layout."""
    _, _, cfg, params, batch = _ptq_pair(bits)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        want = Model(cfg, device="cpu").loss(params, tb)
        got = Model(cfg.replace(quant=cfg.quant.with_(backend=backend)),
                    device="cpu").loss(params, tb)
    assert torch.equal(got, want)


def test_loss_refuses_the_cpu_when_not_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_reduced("smollm_135m"))
