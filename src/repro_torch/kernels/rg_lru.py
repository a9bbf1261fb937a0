"""The linear-recurrence kernel (CUDA C++, ``csrc/rg_lru.cu``).

Replaces the Pallas kernel ``repro/kernels/rg_lru.py`` (``rg_lru_pallas``).
:func:`rg_lru_cuda` computes ``h_t = a_t * h_{t-1} + x_t`` over x, a
(B, S, D) from h0 (B, D) with an f32 carry, h (B, S, D) in x's dtype. On
CPU tensors it runs the plain version (``kernels/ref.py::rg_lru_ref``, a
sequential f32 loop); on CUDA tensors it launches the kernel or raises.
Each launch adds one to ``rg_lru_cuda.launches``. :func:`rg_lru` is the
same function under autograd: its backward, :func:`rg_lru_grad`, runs the
kernel once more over time reversed (``rg_lru_grad.launches``), so the
RG-LRU trains through B5 on the card. x and a may each be
float32, bfloat16, float16 or float64; both compute in f32 and round h
once to x's dtype. Kernel and plain version round the same operations in
the same order, so they agree bit for bit; the reference's doubling scan
rounds otherwise.

The kernel is bound by bytes (x and a read once, h written once: 0.1202
ms at B=4, S=2048, D=4096 in f32 on an H100), and its design keeps enough
of them in flight while the scan stays sequential in S: a block owns
``dt`` neighbouring chains of one b and walks S. Where x, a and h have
16-byte aligned bases and rows (``D * elem % 16 == 0``), the aligned
instance ``rg_lru_ring`` runs: a ring of ``ns`` shared-memory stages of
``st`` steps, kept full by TMA loads of 3-D tensor maps that the C entry
encodes per call; h is written over x in the stage and leaves by one TMA
store per stage. Elsewhere the unaligned instance ``rg_lru_regs``
prefetches 16 steps per chain in registers on the same grid.
:func:`launch_plan`, a pure function of the shapes, element sizes and
base addresses, picks the instance and the tiling. More in the CUDA
source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.tracepoints import note_launch

__all__ = ["rg_lru", "rg_lru_cuda", "rg_lru_grad", "rg_lru_plain",
           "launch_plan", "LaunchPlan", "SMS", "SMEM_LIMIT"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}

SMS = 132                    # H100 SXM streaming multiprocessors
SMEM_LIMIT = 232448          # shared memory a block can use (227 KiB)
SMEM_PER_SM = 233472         # the SM's, shared by its blocks (228 KiB)
SMEM_RESERVED = 1024         # the runtime's per block
SMEM_SLACK = 128             # csrc/rg_lru.cu aligns the ring's base
DTS = (128, 64, 32)          # chains per block, widest first
V = 16                       # csrc/rg_lru.cu: steps per register batch
LONE_STEPS = 128             # stage steps of a block alone on its SM
SHARED_STAGE = 8192          # stage bytes where blocks share an SM
LONE_RING = 98304            # ring bytes of a block alone on its SM
SHARED_RING = 32768          # ring bytes of a block sharing its SM
MIN_STAGES = 3               # a stage is freed one stage late
MAX_STAGES = 16
REGS_STEPS = 16              # rg_lru_regs: steps per register batch (U)


class LaunchPlan(NamedTuple):
    """One call's launch: ``blocks`` blocks of ``threads`` threads, each
    owning ``dt`` neighbouring chains of one b (:meth:`chains`). The
    aligned instance (``rg_lru_ring``) keeps a ring of ``ns`` stages of
    ``st`` steps in ``smem`` bytes of shared memory; the unaligned one
    (``rg_lru_regs``) ``st`` steps per register batch and no ring."""
    aligned: bool
    dt: int
    st: int
    ns: int
    blocks: int
    threads: int
    smem: int

    @property
    def kernel(self) -> str:
        """The kernel's name, as the profiler shows it."""
        return "rg_lru_ring" if self.aligned else "rg_lru_regs"

    def chains(self, block: int, d: int) -> tuple[int, range]:
        """(b, the d range) that ``block`` owns at width ``d``, as the
        kernel's ``owner`` computes them."""
        tiles_d = -(-d // self.dt)
        b = block // tiles_d
        d0 = (block - b * tiles_d) * self.dt
        return b, range(d0, min(d0 + self.dt, d))


def ring_smem(dt: int, st: int, ns: int, x_size: int, a_size: int) -> int:
    """Shared memory of ``rg_lru_ring``: ns stages of an a and an x tile
    (st x dt each), two mbarriers a stage and the alignment slack."""
    return SMEM_SLACK + ns * st * dt * (x_size + a_size) + 16 * ns


def launch_plan(b: int, s: int, d: int, x_size: int, a_size: int,
                out_size: int, x_ptr: int = 0, a_ptr: int = 0,
                out_ptr: int = 0) -> LaunchPlan:
    """The launch for x, a, h (b, s, d) of element sizes ``x_size``,
    ``a_size``, ``out_size`` at base addresses ``*_ptr``.

    The aligned instance exactly where every base is 16-byte aligned and
    every row (``d * size``) a multiple of 16 bytes, as TMA needs. ``dt``:
    the widest of 128, 64, 32 chains per block that still gives a block
    to every SM, else 32 (so at least 132 blocks wherever b * d >=
    132 * 32). The ring, from a sweep of every tiling at six shapes on an
    H100 (``launch/bench_rg_lru.py --sweep``): each stage costs a fixed
    hand-off (a barrier, a TMA store, a release), which a block alone on
    its SM cannot hide behind another's steps, so it takes stages of 128
    steps and ~96 KiB; blocks that share an SM take stages of ~8 KiB and
    ~32 KiB each. ``st`` is a multiple of 16 (the kernel's register batch)
    up to 256, at least 3 stages (one is freed a stage late) and at most
    16, all within a block's shared memory and, where 3 stages allow it,
    the SM's share of every block resident at once."""
    aligned = all(p % 16 == 0 for p in (x_ptr, a_ptr, out_ptr)) and all(
        d * n % 16 == 0 for n in (x_size, a_size, out_size))
    dt = next((c for c in DTS if b * -(-d // c) >= SMS), DTS[-1])
    blocks = b * -(-d // dt)
    if not aligned:
        return LaunchPlan(False, dt, REGS_STEPS, 0, blocks, dt, 0)
    row = dt * (x_size + a_size)
    per_sm = -(-blocks // SMS)
    st, ring = ((LONE_STEPS, LONE_RING) if per_sm == 1 else
                (SHARED_STAGE // row, SHARED_RING))
    fit = (SMEM_LIMIT - SMEM_SLACK) // (MIN_STAGES * (row + 16))
    st = max(V, min(st, fit, 256) // V * V)
    share = SMEM_PER_SM // per_sm - SMEM_RESERVED - SMEM_SLACK
    ns = max(MIN_STAGES, min(MAX_STAGES, ring // (st * row),
                             share // (st * row + 16)))
    return LaunchPlan(True, dt, st, ns, blocks, dt + 32,
                      ring_smem(dt, st, ns, x_size, a_size))


def _library() -> ctypes.CDLL:
    lib = build.load("rg_lru")
    if not getattr(lib, "_typed", False):
        lib.rg_lru_launch.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P,
                                      _I, _I, _I, _I, _P]
        lib.rg_lru_launch.restype = _I
        lib.rg_lru_error.argtypes = [_I]
        lib.rg_lru_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x, a, h0) -> None:
    if x.ndim != 3 or a.shape != x.shape or tuple(h0.shape) != (
            x.shape[0], x.shape[2]):
        raise ValueError(f"need x, a (B, S, D) and h0 (B, D), got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(h0.shape)}")


def rg_lru_plain(x, a, h0) -> torch.Tensor:
    """The plain version (``kernels/ref.py``), on any device."""
    _check(x, a, h0)
    return ref.rg_lru_ref(x, a, h0)


def _scan(x, a, h0) -> torch.Tensor:
    """One launch of the kernel over CUDA x, a, h0 (no count); h (B, S, D)
    in x's dtype."""
    lib = _library()
    dev = x.device
    if dev.type != "cuda" or a.device != dev or h0.device != dev:
        raise ValueError(f"rg_lru runs on CUDA or CPU tensors on one "
                         f"device, got {x.device}, {a.device}, {h0.device}")
    if x.dtype not in _DTYPE_CODE or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes x and a in float32, bfloat16, "
                         f"float16 or float64, got {x.dtype} and {a.dtype}")
    b, s, d = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    xc, ac = x.contiguous(), a.contiguous()
    h0c = h0.to(torch.float32).contiguous()
    plan = launch_plan(b, s, d, xc.element_size(), ac.element_size(),
                       out.element_size(), xc.data_ptr(), ac.data_ptr(),
                       out.data_ptr())
    _launch(lib, xc, ac, h0c, out, plan)
    return out


def rg_lru_cuda(x, a, h0) -> torch.Tensor:
    """h (B, S, D) in x's dtype.

    CPU tensors take the plain version. Anything else must be CUDA
    tensors on one device, x and a each float32, bfloat16, float16 or
    float64;
    the kernel is built at first use, and a build or launch failure
    raises."""
    _check(x, a, h0)
    if x.device.type == "cpu":
        return rg_lru_plain(x, a, h0)
    out = _scan(x, a, h0)
    rg_lru_cuda.launches += 1
    return out


def rg_lru_grad(dh, a, h, h0):
    """The gradient of ``h = rg_lru(x, a, h0)``: (dx, da, dh0) from ``dh``
    (B, S, D), the forward's a and h and h0.

    The sum carried back, g_t = dh_t + a_{t+1} g_{t+1} (g past the last
    step is 0), is the same recurrence run backward in time: the kernel
    over flip(dh) with coefficients flip(a) shifted one step (the first
    multiplies h0 = 0, so it is 0 too) in one launch, each adding one to
    ``rg_lru_grad.launches`` (on CPU tensors the plain version, no
    count). Then dx = g, da_t = g_t h_{t-1} (h_0 = h0) and dh0 = a_1 g_1.
    g takes dh's dtype, dx that too; da and dh0 are computed in f32 and
    take a's and h0's dtypes. The flips are fresh contiguous copies, so
    the backward launch takes the instance the forward took at the same
    row size: ``rg_lru_ring`` where ``D * elem`` is a multiple of 16 bytes
    for dh, a and g, else ``rg_lru_regs``."""
    _check(dh, a, h0)
    a_next = torch.zeros_like(a, memory_format=torch.contiguous_format)
    a_next[:, :-1] = a[:, 1:]
    rev_dh, rev_a = dh.flip(1), a_next.flip(1)
    zero = torch.zeros_like(h0, dtype=torch.float32)
    if dh.device.type == "cpu":
        g = rg_lru_plain(rev_dh, rev_a, zero)
    else:
        g = _scan(rev_dh, rev_a, zero)
        rg_lru_grad.launches += 1
    g = g.flip(1)
    h_prev = torch.cat([h0[:, None].to(h.dtype), h[:, :-1]], 1)
    gf = g.to(torch.float32)
    da = (gf * h_prev.to(torch.float32)).to(a.dtype)
    dh0 = (a[:, 0].to(torch.float32) * gf[:, 0]).to(h0.dtype)
    return g, da, dh0


class _RGLRU(torch.autograd.Function):
    """:func:`rg_lru_cuda` with :func:`rg_lru_grad` as its backward."""

    @staticmethod
    def forward(ctx, x, a, h0):
        h = rg_lru_cuda(x, a, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        return rg_lru_grad(dh.contiguous(), a, h, h0)


def rg_lru(x, a, h0) -> torch.Tensor:
    """:func:`rg_lru_cuda` under autograd: the gradients of x, a and h0
    come from :func:`rg_lru_grad` (the kernel again on CUDA tensors, the
    plain version on CPU ones)."""
    return _RGLRU.apply(x, a, h0)


def _launch(lib, x, a, h0, out, plan: LaunchPlan) -> None:
    """Launch ``plan`` on contiguous CUDA x, a, out and f32 h0 on the
    current stream (no count: ``launch/bench_rg_lru.py`` sweeps tilings
    through it); raise on failure."""
    b, s, d = x.shape
    err = lib.rg_lru_launch(x.data_ptr(), _DTYPE_CODE[x.dtype], a.data_ptr(),
                            _DTYPE_CODE[a.dtype], h0.data_ptr(), b, s, d,
                            out.data_ptr(), plan.dt, plan.st, plan.ns,
                            int(plan.aligned),
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru launch failed ({plan.kernel}): "
                           f"{lib.rg_lru_error(err).decode()}")
    note_launch(f"B5.{plan.kernel}", (x, a, h0), (out,))


rg_lru_cuda.launches = 0
rg_lru_grad.launches = 0
