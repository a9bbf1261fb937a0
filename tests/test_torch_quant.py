"""Port parity: quantizers and the TransitiveLinear PTQ path of
``repro_torch`` against the JAX reference ``repro``.

Codes and scales quantized from f32 inputs are equal exactly (same true
division, same round-half-even). Every port backend's int32 accumulator
(``int_dot``, ``lut``, ``engine_torch``, and ``lut_cuda`` and
``engine_cuda`` through their plain versions on CPU) equals the reference
``int_dot``'s and its counterpart's exactly, per-channel and grouped; the
f32 ``linear_apply`` output matches the reference within the tolerance
stated at each check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.backend import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core.backend import get_backend as ref_backend  # noqa: E402
from repro.core.engine import (  # noqa: E402
    BatchedTransitiveEngine as RefEngine)
from repro.core.engine import compile_plan as ref_compile  # noqa: E402
from repro.quant import QuantConfig as RefQuantConfig  # noqa: E402
from repro.quant import linear_apply as ref_linear_apply  # noqa: E402
from repro.quant import quantize as ref_q  # noqa: E402
from repro_torch.core.backend import EngineConfig, get_backend  # noqa: E402
from repro_torch.core.engine import (BatchedTransitiveEngine,  # noqa: E402
                                     compile_plan)
from repro_torch.quant import QuantConfig, linear_apply  # noqa: E402
from repro_torch.quant import quantize as pt_q  # noqa: E402

BACKENDS = ["int_dot", "lut", "lut_cuda", "engine_torch", "engine_cuda"]
REF_OF = {"int_dot": "int_dot", "lut": "lut", "lut_cuda": "pallas",
          "engine_torch": "engine_jit", "engine_cuda": "engine_pallas"}


def _inputs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])               # a view of x
    rows[0] = 0.0                                 # an all-zero row
    rows[1, :4] = [127.0, 0.5, -1.5, 2.5]         # exact ties at code .5
    return x


@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 33), (2, 576)])
def test_quantize_per_token_exact(shape, rng):
    x = _inputs(rng, shape)
    q_p, s_p = pt_q.quantize_per_token(torch.from_numpy(x))
    q_r, s_r = ref_q.quantize_per_token(jnp.asarray(x))
    assert q_p.dtype == torch.int8 and s_p.dtype == torch.float32
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))


@pytest.mark.parametrize("bits,group", [(4, 32), (8, 64), (4, 96)])
def test_quantize_groupwise_exact(bits, group, rng):
    w = rng.standard_normal((7, 192)).astype(np.float32)
    q_p, s_p = pt_q.quantize_groupwise(torch.from_numpy(w), bits, group)
    q_r, s_r = ref_q.quantize_groupwise(jnp.asarray(w), bits, group)
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))


def test_quantize_keeps_working_dtype(rng):
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    _, s32 = pt_q.quantize_per_token(x)
    _, s16 = pt_q.quantize_per_token(x.to(torch.bfloat16))
    assert s32.dtype == torch.float32 and s16.dtype == torch.bfloat16


def _layer(rng, n, k, w_bits, group):
    """A PTQ layer made from numpy: codes in range, f32 scales."""
    lo, hi = -(1 << (w_bits - 1)), (1 << (w_bits - 1)) - 1
    qw = rng.integers(lo, hi + 1, size=(n, k)).astype(np.int8)
    g = k if group == 0 else group
    sg = (rng.random((n, k // g)) * 0.1 + 0.01).astype(np.float32)
    return qw, sg


def _dplans(qw, w_bits, groups):
    """The same weight planned and lowered by both packages."""
    pt = compile_plan(BatchedTransitiveEngine(w_bits, 8).plan(
        qw.astype(np.int64), groups=groups))
    ref = ref_compile(RefEngine(w_bits, 8).plan(qw.astype(np.int64),
                                                groups=groups))
    return pt, ref


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("groups", [1, 4])
def test_backend_int32_accumulator_equals_reference(backend, groups, rng):
    n, k = 24, 128
    qw, _ = _layer(rng, n, k, 4, 0)
    qx = rng.integers(-128, 128, size=(2, 3, k)).astype(np.int8)
    dpt, dref = _dplans(qw, 4, groups)
    g = k // groups
    ref_int_dot = ref_backend("int_dot")
    if groups == 1:
        want = ref_int_dot.execute(jnp.asarray(qx), jnp.asarray(qw), None,
                                   None, RefEngineConfig(4, 8, 1))
        xs, ws = qx, qw
    else:
        xs = qx.reshape(2, 3, groups, g)
        ws = qw.reshape(n, groups, g)
        want = ref_int_dot.execute(jnp.asarray(xs), jnp.asarray(ws), None,
                                   None, RefEngineConfig(4, 8, groups))
    got = get_backend(backend).execute(
        torch.from_numpy(xs), torch.from_numpy(ws), None, dpt,
        EngineConfig(4, 8, groups))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref_dev = ref_backend(REF_OF[backend]).execute(
        jnp.asarray(xs), jnp.asarray(ws), None, dref,
        RefEngineConfig(4, 8, groups))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_dev))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("group", [0, 32])
def test_linear_apply_matches_reference(backend, group, rng):
    """f32 ``linear_apply``: per-channel outputs are computed with the same
    f32 operations in the same order (int32 -> f32, * sx, * sg), so they
    agree to 1 ulp; grouped outputs sum the G rescaled partials in
    another order (einsum), so they get a relative tolerance of 1e-6 on
    values that are sums of 4 terms."""
    n, k = 20, 128
    qw, sg = _layer(rng, n, k, 4, group)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    groups = 1 if group == 0 else k // group
    dpt, dref = _dplans(qw, 4, groups)
    pt_cfg = QuantConfig(mode="ptq", w_bits=4, group=group, backend=backend)
    ref_cfg = RefQuantConfig(mode="ptq", w_bits=4, group=group,
                             backend=REF_OF[backend])
    got = linear_apply({"qw": torch.from_numpy(qw),
                        "sg": torch.from_numpy(sg), "dplan": dpt},
                       torch.from_numpy(x), pt_cfg)
    ref_params = {"qw": jnp.asarray(qw), "sg": jnp.asarray(sg)}
    if get_backend(backend).needs_plan:
        ref_params["dplan"] = dref
    want = np.asarray(ref_linear_apply(ref_params, jnp.asarray(x), ref_cfg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if group == 0:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_linear_apply_plan_signature_mismatch_raises(rng):
    qw, sg = _layer(rng, 8, 64, 4, 0)
    dpt, _ = _dplans(qw, 4, 1)
    cfg = QuantConfig(mode="ptq", w_bits=8, group=0, backend="engine_torch")
    with pytest.raises(ValueError, match="signature"):
        linear_apply({"qw": torch.from_numpy(qw), "sg": torch.from_numpy(sg),
                      "dplan": dpt}, torch.zeros((1, 64)), cfg)


def test_linear_without_attached_plan_uses_the_cache(rng):
    """No embedded plan: the layer plans through the process cache once."""
    from repro_torch.core import plancache
    qw, sg = _layer(rng, 8, 64, 4, 0)
    cache = plancache.PlanCache()
    prev = plancache.set_default_cache(cache)
    try:
        cfg = QuantConfig(mode="ptq", w_bits=4, group=0,
                          backend="engine_torch")
        params = {"qw": torch.from_numpy(qw), "sg": torch.from_numpy(sg)}
        x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
        a = linear_apply(params, x, cfg)
        b = linear_apply(params, x, cfg.with_(backend="int_dot"))
        linear_apply(params, x, cfg)
    finally:
        plancache.set_default_cache(prev)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (cache.misses, cache.hits) == (1, 1)


@pytest.mark.parametrize("group", [64, 128, 0])
@pytest.mark.parametrize("w_bits", [4, 8])
def test_lut_linear_paths_agree_with_reference(group, w_bits, rng):
    """The reference's ``test_linear_paths_agree`` across the packages:
    ``lut`` and ``lut_cuda`` (plain version on CPU) against the
    reference's ``lut`` and ``pallas`` (interpret mode), rtol and atol
    1e-4 as there; the LUT backends build no plan."""
    from repro_torch.core import plancache
    n, k = 96, 256
    qw, sg = _layer(rng, n, k, w_bits, group)
    x = rng.standard_normal((3, 7, k)).astype(np.float32)
    cache = plancache.PlanCache()
    prev = plancache.set_default_cache(cache)
    try:
        for port in ("lut", "lut_cuda"):
            got = linear_apply(
                {"qw": torch.from_numpy(qw), "sg": torch.from_numpy(sg)},
                torch.from_numpy(x),
                QuantConfig(mode="ptq", w_bits=w_bits, group=group,
                            backend=port))
            want = ref_linear_apply(
                {"qw": jnp.asarray(qw), "sg": jnp.asarray(sg)},
                jnp.asarray(x),
                RefQuantConfig(mode="ptq", w_bits=w_bits, group=group,
                               backend=REF_OF[port]))
            assert got.shape == (3, 7, n) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
    finally:
        plancache.set_default_cache(prev)
    assert (cache.hits, cache.misses) == (0, 0)
