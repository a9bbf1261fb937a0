"""B5's launch plan on the CPU: ``repro_torch.kernels.rg_lru.launch_plan``.

The plan is a pure function of the shapes, element sizes and base
addresses: it picks the instance (``rg_lru_ring``, TMA into a ring of
shared-memory stages, where every base and row is 16-byte aligned;
``rg_lru_regs`` elsewhere) and the tiling. These tests hold it to what
the kernel needs, and walk the kernel's tiles in torch on the CPU (the
plan's blocks and stages, zero past S and D) against the plain version,
bit for bit, and the reference's Pallas kernel in interpret mode, within
its tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rg_lru import rg_lru_pallas  # noqa: E402
from repro_torch.kernels.rg_lru import (  # noqa: E402
    REGS_STEPS, SMEM_LIMIT, SMEM_PER_SM, SMEM_RESERVED, SMS, launch_plan,
    rg_lru_plain, ring_smem)

SIZES = (2, 4, 8)                    # bf16 / f16, f32, f64
OFFSETS = (0, 1, 2, 4, 8, 16, 48)    # base addresses, bytes past 1 MiB


@pytest.mark.parametrize("s", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("d", [1, 33, 257, 512, 4096, 4100])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_launch_plan_owns_every_chain_once_and_fits(b, d, s):
    """For every element size of x and a (h takes x's) and base offset:
    each (b, d) chain belongs to exactly one block, shared memory fits a
    block, at least 132 blocks wherever b * d >= 132 * 32, and the
    aligned instance is chosen exactly when every row and base is
    16-byte aligned."""
    for xs in SIZES:
        for asz in SIZES:
            for off in OFFSETS:
                ptrs = (1 << 20) + off, 1 << 20, 1 << 21
                for x_ptr, a_ptr, out_ptr in (ptrs, ptrs[::-1]):
                    plan = launch_plan(b, s, d, xs, asz, xs, x_ptr, a_ptr,
                                       out_ptr)
                    want = (all(p % 16 == 0 for p in ptrs) and
                            d * xs % 16 == 0 and d * asz % 16 == 0)
                    assert plan.aligned == want
                    _check_plan(plan, b, d, xs, asz)


def _check_plan(plan, b, d, xs, asz):
    assert plan.dt in (32, 64, 128)
    owned = np.zeros((b, d), dtype=np.int64)
    for block in range(plan.blocks):
        bi, ds = plan.chains(block, d)
        assert 0 <= bi < b and len(ds) >= 1
        owned[bi, ds.start:ds.stop] += 1
    assert (owned == 1).all()
    if b * d >= SMS * 32:
        assert plan.blocks >= SMS
    if not plan.aligned:
        assert (plan.kernel, plan.threads, plan.smem, plan.st) == (
            "rg_lru_regs", plan.dt, 0, REGS_STEPS)
        return
    assert plan.kernel == "rg_lru_ring" and plan.threads == plan.dt + 32
    assert 16 <= plan.st <= 256 and plan.st % 16 == 0   # whole batches
    assert 3 <= plan.ns <= 16                # a stage is freed a stage late
    assert plan.st * plan.dt * min(xs, asz) % 128 == 0   # tiles 128-B apart
    assert plan.smem == ring_smem(plan.dt, plan.st, plan.ns, xs, asz)
    assert plan.smem <= SMEM_LIMIT
    if plan.ns > 3:           # sized to the SM: the whole grid resident
        per_sm = -(-plan.blocks // SMS)
        assert per_sm * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("b", [1, 4])
def test_ring_keeps_bytes_in_flight_at_recurrentgemma_width(b):
    """At D = 4096 in f32 (recurrentgemma-9b's width) the rings of every SM
    keep at least 20 KiB loading while a stage is consumed and the one
    before it is still being stored (the ~15-20 KB per SM that 3.35 TB/s
    needs over the load latency), and the grid covers the card."""
    plan = launch_plan(b, 2048, 4096, 4, 4, 4)
    per_sm = -(-plan.blocks // SMS)
    stage = plan.st * plan.dt * 8
    assert plan.aligned and plan.blocks >= 128
    assert (plan.ns - 2) * stage * per_sm >= 20 * 1024


@pytest.mark.parametrize("b,s", [(4, 128), (1, 2100)])
def test_launch_plan_takes_recurrentgemma_prefill_shapes(b, s):
    """recurrentgemma-9b's RG-LRU prefills (f32 at D = 4096; a batch of 4
    x 128 tokens, one prompt of 2,100) take the ring: the plan depends on
    B and D, not on S, owns every chain once and fits; S = 2,100 leaves a
    ragged last stage, which the kernel's TMA boxes fill with zeros past
    S and its store clips (``_emulate`` walks such stages below)."""
    plan = launch_plan(b, s, 4096, 4, 4, 4, 1 << 20, 1 << 21, 1 << 22)
    assert plan == launch_plan(b, 2048, 4096, 4, 4, 4)
    assert plan.kernel == "rg_lru_ring" and plan.blocks >= 128
    _check_plan(plan, b, 4096, 4, 4)
    stages = -(-s // plan.st)
    assert (stages - 1) * plan.st < s <= stages * plan.st


def _emulate(x, a, h0, plan):
    """The kernel's walk on the CPU: block by block (``plan.chains``), in
    tiles of ``plan.st`` steps over ``plan.dt`` lanes (the ring's TMA
    boxes, or the register batches: zero past S and D), the f32 step
    a * h then + x, h rounded once to x's dtype. Unwritten outputs stay
    NaN."""
    _, s, d = x.shape
    out = torch.full(x.shape, float("nan"), dtype=x.dtype)
    for block in range(plan.blocks):
        b, ds = plan.chains(block, d)
        h = torch.zeros(plan.dt)
        h[:len(ds)] = h0[b, ds.start:ds.stop].float()
        for t0 in range(0, s, plan.st):
            n = min(plan.st, s - t0)
            box_a = torch.zeros((plan.st, plan.dt))
            box_x = torch.zeros((plan.st, plan.dt))
            box_a[:n, :len(ds)] = a[b, t0:t0 + n, ds.start:ds.stop].float()
            box_x[:n, :len(ds)] = x[b, t0:t0 + n, ds.start:ds.stop].float()
            for t in range(n):
                h = box_a[t] * h + box_x[t]
                out[b, t0 + t, ds.start:ds.stop] = h[:len(ds)].to(x.dtype)
    return out


@pytest.mark.parametrize("b,s,d,xdt,adt,aligned", [
    (2, 200, 40, "float32", "float32", True),     # two stages, ragged D
    (1, 128, 32, "float32", "float32", True),     # one stage exactly
    (2, 37, 33, "float32", "float32", False),     # register batches
    (3, 17, 65, "bfloat16", "float16", False),
    (1, 20, 8, "float64", "bfloat16", True),      # dt wider than D
    (2, 256, 64, "bfloat16", "bfloat16", True)])  # two whole stages
def test_tile_walk_equals_plain_and_reference(b, s, d, xdt, adt, aligned,
                                              rng):
    """The plan's tiles cover every step of every chain once: the walk
    equals the plain version bit for bit, and the reference's Pallas
    kernel (interpret mode) within its tolerance (3e-4 where h is wider
    than 16 bits; one 16-bit ulp of |h| up to ~10, 3e-2, otherwise)."""
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    a = rng.uniform(0.8, 0.999, (b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    pt = [torch.from_numpy(x).to(getattr(torch, xdt)),
          torch.from_numpy(a).to(getattr(torch, adt)), torch.from_numpy(h0)]
    sizes = (pt[0].element_size(), pt[1].element_size())
    plan = launch_plan(b, s, d, *sizes, sizes[0])
    assert plan.aligned == aligned
    got = _emulate(*pt, plan)
    assert not got.isnan().any()
    torch.testing.assert_close(got, rg_lru_plain(*pt), rtol=0, atol=0)
    if xdt == "float64":
        return                  # the reference's float64 needs x64 mode
    want = rg_lru_pallas(jnp.asarray(x, getattr(jnp, xdt)),
                         jnp.asarray(a, getattr(jnp, adt)),
                         jnp.asarray(h0), interpret=True)
    tol = 3e-4 if pt[0].element_size() >= 4 else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
