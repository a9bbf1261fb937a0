"""The group-dequant W4/W8 x A8 GEMM kernel (CUDA C++,
``csrc/w4a8_gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/w4a8_gemm.py``
(``w4a8_gemm_pallas``). :func:`w4a8_gemm_cuda` computes f32 (M, N) =
(sum over groups of the exact int32 group dot x the group scale) x the
token scale, for qx (M, K) int8, sx (M, 1) f32, qw (N, K) int8 and sg
(N, K // group) f32. On CPU tensors it runs the plain version
(``kernels/ref.py::w4a8_matmul_ref``); on CUDA tensors it launches the
kernel or raises. Each launch adds one to ``w4a8_gemm_cuda.launches``.

Two instances, picked by :func:`launch_plan`, a pure function of the
shapes and base addresses:

* ``w4a8_wgmma`` where the group is 32, 64, 128 or 256 and qx, qw sit
  on 16-byte aligned bases: the group dots on the int8 tensor cores
  (wgmma), fed by a ring of TMA tiles, with the weights as the 64-row
  operand and ``bt`` tokens as the instruction's N; a thread block
  cluster of ``split`` ranks along K where the output tiles are too few
  to fill the card. It sums the f32 group terms in a stated order, which
  :func:`w4a8_gemm_ordered` computes in plain torch: the two agree bit
  for bit.
* ``w4a8_dot`` for every other call (any group dividing K, any K): dp4a
  dots on the scalar pipes, four codes per instruction when ``group % 4
  == 0``, one otherwise, the f32 terms summed in another order than the
  plain version's, so the two agree within a tolerance.

Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.tracepoints import note_launch

__all__ = ["w4a8_gemm_cuda", "w4a8_gemm_plain", "w4a8_gemm_ordered",
           "launch_plan", "dot_plan", "with_split", "LaunchPlan",
           "wgmma_smem", "SMS", "SMEM_LIMIT"]

_P = ctypes.c_void_p
_I = ctypes.c_int

SMS = 132                    # H100 SXM streaming multiprocessors
SMEM_LIMIT = 232448          # shared memory a block can use (227 KiB)
SMEM_PER_SM = 233472         # the SM's, shared by its blocks (228 KiB)
SMEM_RESERVED = 1024         # the runtime's per block
SMEM_SLACK = 1024            # csrc/w4a8_gemm.cu aligns the ring to 1 KiB
BOX_K = 128                  # bytes of K per TMA box
KSTEP = 32                   # bytes of K per wgmma
GROUPS = (32, 64, 128, 256)  # w4a8_wgmma's: group / 32 wgmmas, unrolled
MAX_SPLIT = 8                # blocks per cluster (portable maximum)
PAD = 4                      # floats past each row of a split's f32 tile
# tokens per tile (wgmma's N) -> (consumer warpgroups, boxes a stage,
# stages): decode tiles stream the weights through three stages of two
# boxes, several blocks an SM; prefill tiles keep one block of two
# warpgroups an SM. The fastest rings by device time of every ring and
# split at smollm-135m's and llama1_7b's shapes (launch/bench_w4a8.py
# --sweep; PERF.md).
TILINGS = {8: (1, 2, 3), 16: (1, 2, 3), 32: (1, 2, 3), 64: (2, 1, 4),
           128: (2, 2, 3)}
GPCS, GPC_SMS = 7, 16        # a cluster runs inside one GPC: 7 of 16 SMs
DOT_BM, DOT_WARPS, DOT_KT = 8, 8, 4096   # w4a8_dot's BM, WARPS, KT


class LaunchPlan(NamedTuple):
    """One call's launch. ``w4a8_wgmma``: blocks of ``threads`` threads
    over ``grid`` = (M tiles of ``bt`` tokens, N tiles of ``rows`` weight
    rows, ``split`` ranks), ``wgs`` consumer warpgroups, a ring of ``ns``
    stages of ``kb`` boxes in ``smem`` bytes; rank r sums the groups
    ``ranges[r]``. ``w4a8_dot``: grid (N tiles of 32, M tiles of 8, 1)
    and one range."""
    kernel: str
    bt: int
    rows: int
    wgs: int
    split: int
    ranges: tuple
    ns: int
    kb: int
    smem: int
    grid: tuple
    threads: int


def wgmma_smem(bt: int, wgs: int, ns: int, kb: int) -> int:
    """Shared memory of ``w4a8_wgmma``: the alignment slack, ns stages of
    kb boxes of weights (64 * wgs rows) and tokens (bt rows), 128 bytes of
    K each, and two mbarriers a stage (the kernel's ``wgmma_smem``)."""
    return SMEM_SLACK + ns * kb * (64 * wgs + bt) * BOX_K + 16 * ns


def tile_bytes(bt: int, wgs: int) -> int:
    """The f32 tile a rank of a K split leaves in its ring."""
    return bt * (64 * wgs + PAD) * 4


def with_split(plan: LaunchPlan, split: int) -> LaunchPlan:
    """``plan`` (``w4a8_wgmma``) with ``split`` ranks along K instead:
    the tests and the bench hold and time every split this way."""
    groups = plan.ranges[-1][1]
    if not 1 <= split <= min(MAX_SPLIT, groups):
        raise ValueError(f"split={split} outside 1..{min(MAX_SPLIT, groups)}")
    return plan._replace(split=split, ranges=rank_ranges(groups, split),
                         grid=plan.grid[:2] + (split,))


def rank_ranges(groups: int, split: int) -> tuple:
    """Each rank's contiguous groups: ``groups // split`` each, the first
    ``groups % split`` ranks one more (the kernel's ``g_lo``, ``g_hi``)."""
    per, extra = divmod(groups, split)
    out, lo = [], 0
    for r in range(split):
        hi = lo + per + (1 if r < extra else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


def dot_plan(m: int, n: int, k: int, group: int) -> LaunchPlan:
    """The launch of ``w4a8_dot`` (any group dividing K, any K)."""
    kts = -(-min(k, DOT_KT) // 16) * 16
    smem = DOT_BM * kts + DOT_WARPS * DOT_BM * 32 * 4
    return LaunchPlan("w4a8_dot", DOT_BM, 32, 0, 1, ((0, k // group),), 0,
                      0, smem, (-(-n // 32), -(-m // DOT_BM), 1),
                      DOT_WARPS * 32)


def launch_plan(m: int, n: int, k: int, group: int, x_ptr: int = 0,
                w_ptr: int = 0) -> LaunchPlan:
    """The launch for qx (m, k), qw (n, k) at base addresses ``*_ptr``.

    ``w4a8_wgmma`` exactly where the group is one of ``GROUPS`` (so K %
    32 == 0, as TMA's row stride and wgmma's k-step need; the kernel
    issues a group's group / 32 wgmmas with no branch between them) and
    both bases are 16-byte aligned; ``w4a8_dot`` elsewhere. ``bt``: the
    least of 8, 16, 32, 64, 128 tokens that holds m (128 beyond), with
    one consumer warpgroup (64 weight rows) up to 32 and two (128 rows)
    from 64; the ring from ``TILINGS``, its stages widened to whole
    groups of 256 (two boxes, half the stages). ``split``: 1 unless the
    tiles leave SMs idle: fewer decode tiles than SMs (each streams its
    weights, so every SM should), or prefill tiles for at most a quarter
    of them (a prefill tile is short; its ranks' sums cost more than the
    idle SMs do above that). Then the most cluster ranks along K, at most
    8 and at most half the groups (a rank's share of the sums costs about
    a group), whose clusters all run in one wave: GPCS GPCs of GPC_SMS
    SMs, each holding its SMs' resident blocks (from shared memory) in
    whole clusters."""
    if group < 1 or k % group:
        raise ValueError(f"K={k} is not divisible by group={group}")
    if group not in GROUPS or x_ptr % 16 or w_ptr % 16:
        return dot_plan(m, n, k, group)
    bt = next((b for b in TILINGS if m <= b), 128)
    wgs, kb, ns = TILINGS[bt]
    if 4 * kb % (group // KSTEP):                   # whole groups a stage
        kb, ns = 2 * kb, max(2, ns // 2)
    rows = 64 * wgs
    smem = wgmma_smem(bt, wgs, ns, kb)
    resident = max(1, SMEM_PER_SM // (smem + SMEM_RESERVED))
    tiles = -(-m // bt) * -(-n // rows)
    groups = k // group
    split = 1
    if tiles < (SMS if wgs == 1 else SMS // 4):
        split = max((s for s in range(1, min(MAX_SPLIT, groups // 2) + 1)
                     if GPCS * (GPC_SMS * resident // s) >= tiles),
                    default=1)
    return LaunchPlan("w4a8_wgmma", bt, rows, wgs, split,
                      rank_ranges(groups, split), ns, kb, smem,
                      (-(-m // bt), -(-n // rows), split), (wgs + 1) * 128)


def _library() -> ctypes.CDLL:
    lib = build.load("w4a8_gemm")
    if not getattr(lib, "_typed", False):
        lib.w4a8_gemm_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                         _P]
        lib.w4a8_gemm_launch.restype = _I
        lib.w4a8_wgmma_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                          _I, _I, _I, _I, _I, _P]
        lib.w4a8_wgmma_launch.restype = _I
        lib.w4a8_wgmma_smem.argtypes = [_I, _I, _I, _I]
        lib.w4a8_wgmma_smem.restype = _I
        lib.w4a8_gemm_error.argtypes = [_I]
        lib.w4a8_gemm_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(qx, sx, qw, sg, group) -> None:
    if qx.ndim != 2 or qw.ndim != 2 or qx.shape[1] != qw.shape[1]:
        raise ValueError(f"need qx (M, K) and qw (N, K), got "
                         f"{tuple(qx.shape)} and {tuple(qw.shape)}")
    m, k = qx.shape
    if group < 1 or k % group:
        raise ValueError(f"K={k} is not divisible by group={group}")
    if tuple(sg.shape) != (qw.shape[0], k // group) or sx.numel() != m:
        raise ValueError(f"need sx (M={m}, 1) and sg (N, K/group)="
                         f"{(qw.shape[0], k // group)}, got "
                         f"{tuple(sx.shape)} and {tuple(sg.shape)}")


def w4a8_gemm_plain(qx, sx, qw, sg, *, group: int = 128) -> torch.Tensor:
    """The plain version (``kernels/ref.py``), on any device."""
    _check(qx, sx, qw, sg, group)
    return ref.w4a8_matmul_ref(qx, sx.reshape(-1, 1), qw, sg)


def w4a8_gemm_ordered(qx, sx, qw, sg, *, group: int,
                      plan: LaunchPlan) -> torch.Tensor:
    """``w4a8_wgmma``'s own order in plain torch, on any device: the exact
    int32 group dots (a float64 einsum, then int32), each to f32; per rank
    of ``plan``, ``acc = acc + part_g * sg[:, g]`` over its groups in
    increasing g from zero; the ranks' sums added in rank order; then
    ``* sx``. Every step rounds once in f32, as the kernel's ``_rn``
    intrinsics do."""
    _check(qx, sx, qw, sg, group)
    if plan.kernel != "w4a8_wgmma":
        raise ValueError(f"{plan.kernel} has no stated order of its own")
    m, k = qx.shape
    n, groups = qw.shape[0], k // group
    if plan.ranges[-1][1] != groups:
        raise ValueError(f"the plan's ranges {plan.ranges} do not cover "
                         f"{groups} groups")
    part = torch.einsum("mgi,ngi->mgn",
                        qx.reshape(m, groups, group).to(torch.float64),
                        qw.reshape(n, groups, group).to(torch.float64))
    part = part.to(torch.int32).to(torch.float32)
    sgf = sg.to(torch.float32)
    total = None
    for lo, hi in plan.ranges:
        acc = torch.zeros((m, n), dtype=torch.float32, device=qx.device)
        for g in range(lo, hi):
            acc = acc + part[:, g] * sgf[:, g]
        total = acc if total is None else total + acc
    return total * sx.to(torch.float32).reshape(m, 1)


def w4a8_gemm_cuda(qx, sx, qw, sg, *, group: int = 128) -> torch.Tensor:
    """f32 (M, N) group-dequant GEMM.

    CPU tensors take the plain version. Anything else must be CUDA
    tensors on one device; the kernel needs int8 codes (any group and any
    K), is built at first use, and a build or launch failure raises."""
    _check(qx, sx, qw, sg, group)
    if qx.device.type == "cpu":
        return w4a8_gemm_plain(qx, sx, qw, sg, group=group)
    lib = _library()
    dev = qx.device
    if dev.type != "cuda" or any(a.device != dev for a in (sx, qw, sg)):
        raise ValueError(f"w4a8_gemm runs on CUDA or CPU tensors on one "
                         f"device, got {[a.device for a in (qx, sx, qw, sg)]}")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"the kernel takes int8 codes, got {qx.dtype} and "
                         f"{qw.dtype}")
    m, k = qx.shape
    n = qw.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    xc, wc = qx.contiguous(), qw.contiguous()
    plan = launch_plan(m, n, k, group, xc.data_ptr(), wc.data_ptr())
    if plan.kernel == "w4a8_dot" and group % 4 == 0:   # 32-bit loads
        if xc.data_ptr() % 4:
            xc = xc.clone()
        if wc.data_ptr() % 4:
            wc = wc.clone()
    sxc = sx.to(torch.float32).reshape(m).contiguous()
    sgc = sg.to(torch.float32).contiguous()
    _launch(lib, xc, sxc, wc, sgc, out, group, plan)
    w4a8_gemm_cuda.launches += 1
    return out


def _launch(lib, qx, sx, qw, sg, out, group: int, plan: LaunchPlan) -> None:
    """Launch ``plan`` on contiguous CUDA qx, qw (int8), sx (M,) and sg
    (f32) into out on the current stream (no count: ``chip_smoke.py`` and
    ``launch/bench_w4a8.py`` time either instance and sweep tilings
    through it); raise on failure."""
    m, k = qx.shape
    n = qw.shape[0]
    stream = torch.cuda.current_stream(qx.device).cuda_stream
    args = (qx.data_ptr(), sx.data_ptr(), qw.data_ptr(), sg.data_ptr(), m, n,
            k, group, out.data_ptr())
    if plan.kernel == "w4a8_dot":
        err = lib.w4a8_gemm_launch(*args, stream)
    else:
        err = lib.w4a8_wgmma_launch(*args, plan.bt, plan.wgs, plan.split,
                                    plan.ns, plan.kb, stream)
    if err != 0:
        raise RuntimeError(f"w4a8_gemm launch failed ({plan.kernel}): "
                           f"{lib.w4a8_gemm_error(err).decode()}")
    note_launch(f"B4.{plan.kernel}", (qx, sx, qw, sg), (out,))


w4a8_gemm_cuda.launches = 0
