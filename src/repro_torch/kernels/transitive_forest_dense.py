"""The Scoreboard forest for plans with T > 8 (CUDA C++,
``csrc/transitive_forest_dense.cu``): two kernels, one launch count.

The T <= 8 kernel (``kernels/transitive_forest.py``) reads a node in one
byte. Wider plans run here, and replace the Pallas kernel
``repro/kernels/transitive_forest.py`` (``transitive_forest_pallas``) for
them; the reference runs a DevicePlan of any T.

  * 9 <= T <= 15: :func:`launch_fused16` runs ``forest_fused16`` from a
    :class:`~repro_torch.core.engine.ForestPlan` with int16 gathers, one
    launch per call, through the two entries of
    ``kernels/transitive_forest.py`` ((K, M) int32 and the serving
    layout's int8 (M, K) codes). It writes the output only: no scratch, no
    workspace, no memset. It reads the nodes' level order from a constant
    table (:func:`level_order`, 2^T uint16) made once per T and device
    and kept. :func:`wide_tiling` picks its tiling on the host (mirrored
    by ``fused16_smem`` in the source).
  * T >= 16 (and any DevicePlan handed to it directly):
    :func:`transitive_forest_dense` runs two passes from the
    :class:`~repro_torch.core.engine.DevicePlan` itself: pass 1 builds each
    tile's 2^T x bm psum table level by level into a (J * 2^T, M) int32
    scratch, pass 2 sums the APE gathers. Pass 1 keeps the tile's
    activation rows ((T + 1) * bm int32) in shared memory, and its two
    level tables (2 * 2^T * bm int32) there too where they fit: bm
    (columns per block) is halved from 16 until they fit 227 KiB, which
    holds up to T = 14. From T = 15 the tables live in a global-memory
    workspace (two per block, bm = min(16, M)) that the wrapper allocates;
    the result is the same.

:func:`transitive_forest_dense` takes int32 x (K, M) and returns (N, M)
ungrouped, (N, G, M) grouped; on CPU tensors it runs the plain version,
``run_device``. Both kernels launch on CUDA tensors or raise. Each launch
of either adds one to ``transitive_forest_dense.launches``; the profiler
names tell them apart (``forest_fused16``, ``forest_dense_*``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from math import comb

import numpy as np
import torch

from repro_torch.core.engine import DevicePlan, ForestPlan, run_device
from repro_torch.kernels import build
from repro_torch.tracepoints import note_launch

__all__ = ["transitive_forest_dense", "launch_fused16", "wide_tiling",
           "WideTiling", "level_order"]

_P = ctypes.c_void_p
_I = ctypes.c_int

_SMEM_LIMIT = 232448            # bytes of shared memory a block may use
_SM_SMEM = 233472               # bytes of shared memory of one SM; each
                                # resident block also takes 1 KiB of it
_WNT = 256                      # threads per forest_fused16 block


def _library() -> ctypes.CDLL:
    lib = build.load("transitive_forest_dense")
    if not getattr(lib, "_typed", False):
        lib.transitive_forest_dense_launch.argtypes = [
            _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
            _P, _P, _P, _P]
        lib.transitive_forest_dense_launch.restype = _I
        lib.transitive_forest_fused16_launch.argtypes = [
            _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _I, _P, _P]
        lib.transitive_forest_fused16_launch.restype = _I
        lib.transitive_forest_fused16_smem.argtypes = [_I] * 6
        lib.transitive_forest_fused16_smem.restype = ctypes.c_size_t
        lib.transitive_forest_dense_error.argtypes = [_I]
        lib.transitive_forest_dense_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _table_bytes(t: int, bm: int) -> int:
    """Shared memory of one pass-1 block with its tables there: two
    2^T x bm tables and the T + 1 activation rows (the last pinned at
    zero), int32."""
    return (2 * (1 << t) * bm + (t + 1) * bm) * 4


def _columns_per_block(t: int, m: int) -> tuple[int, bool]:
    """(bm, whether pass 1's tables fit shared memory): bm halved from
    min(16, M) until two tables fit 227 KiB; where not even one column's
    do (T >= 15), bm = min(16, M) with the tables in global memory."""
    bm = min(16, m)
    while bm > 1 and _table_bytes(t, bm) > _SMEM_LIMIT:
        bm //= 2
    if _table_bytes(t, bm) <= _SMEM_LIMIT:
        return bm, True
    return min(16, m), False


def fused16_smem(t: int, s: int, bm: int, jb: int, nbuf: int, bn: int
                 ) -> int:
    """Shared memory of one ``forest_fused16`` block, the kernel's carve-up:
    jb tables of 2^T x bm int32, the round's activations (padded to 4
    words), the level order (2^T uint16), the binomials (16 x 16 uint16),
    the plane weights (8 int32), nbuf x jb x 2^T producer bytes and nbuf x
    jb x S rows rows of bn + 8 int16."""
    size = 1 << t
    return (jb * size * bm * 4 + ((jb * t * bm + 3) & ~3) * 4 + size * 2
            + 256 * 2 + 8 * 4 + nbuf * jb * size + nbuf * jb * s * (bn + 8)
            * 2)


@dataclasses.dataclass(frozen=True)
class WideTiling:
    """The launch of ``forest_fused16``: bm columns and bn outputs per
    block, jb tiles per round, nbuf plan buffers (2: the next round's bytes
    load during this one), a cluster of ``cluster`` blocks per group."""
    bm: int
    jb: int
    nbuf: int
    bn: int
    cluster: int
    smem: int


# wide_tiling's cost model, fitted to the kernel's device time over 351
# tilings at seven shapes (T = 9, 10, 12, 14; M = 4) on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md): per wave of clusters a fixed cost of ~53
# steps (~11.2 us), and per round one step per _STEP_NODES nodes a thread
# builds in each level (~0.21 us), slowed by the share of an SM each
# block gets.
_WAVE_STEPS = 53
_STEP_NODES = 4
_GPC_SMS = 18                   # SMs per GPC: a cluster of C blocks runs
                                # inside one (7 on an H100's 132 SMs)


@functools.lru_cache(maxsize=1024)
def wide_tiling(t: int, s: int, n: int, m: int, jg: int, groups: int,
                sms: int) -> WideTiling:
    """The tiling of ``forest_fused16`` for width T, S planes, N outputs,
    M columns, jg tiles per group and ``sms`` SMs: of every tiling that
    fits (bm a power of two up to the one >= M and <= 8, jb <= 8 and <=
    jg tables a round, double buffered where that fits, bn in {64, 128,
    256}; the cluster covers the group with up to 16 ranks, each with a
    tile in the first round), the one the cost model gives the least time.

    The model: a block's chain is ``rounds`` rounds of ``steps`` build
    steps (per level, the level's nodes over the table's NT / jb threads,
    _STEP_NODES at a time), slowed by ``share`` (resident blocks per SM)
    and repeated per wave of clusters; each wave costs _WAVE_STEPS more. A
    cluster runs inside one GPC, so a wave holds floor(16 x blocks per SM
    / cluster) clusters in each of sms // _GPC_SMS GPCs (on the H100: 7,
    as ``cudaOccupancyMaxActiveClusters`` gave for 16-block clusters)."""
    best = None
    bm_max = min(8, 1 << max(0, m - 1).bit_length())
    gpcs = max(1, sms // _GPC_SMS)
    for jb in (1, 2, 4, 8):                     # ties: the fewest tables,
        if jb > jg:
            break
        cluster = min(16, -(-jg // jb))
        rounds = -(-jg // (cluster * jb))
        steps = sum(-(-comb(t, lv) // (_WNT // jb * _STEP_NODES))
                    for lv in range(1, t + 1))
        for bm in (8, 4, 2, 1):                 # the most columns
            if bm > bm_max or jb * t * bm > 4 * _WNT:
                continue
            for bn in (256, 128, 64):           # and outputs per block
                nbuf = next((b for b in (2, 1) if fused16_smem(
                    t, s, bm, jb, b, bn) <= _SMEM_LIMIT), None)
                if nbuf is None:
                    continue
                smem = fused16_smem(t, s, bm, jb, nbuf, bn)
                per_sm = _SM_SMEM // (smem + 1024)
                per_wave = gpcs * max(1, 16 * per_sm // cluster)
                clusters = groups * -(-n // bn) * -(-m // bm)
                waves = -(-clusters // per_wave)
                share = max(1.0, min(clusters, per_wave) * cluster / sms)
                cost = waves * (_WAVE_STEPS + rounds * steps * share)
                if best is None or cost < best[0]:
                    best = (cost, WideTiling(bm, jb, nbuf, bn, cluster,
                                             smem))
    if best is None:
        raise ValueError(f"forest_fused16 has no tiling that fits T={t}")
    return best[1]


def level_order(t: int) -> np.ndarray:
    """The 2^T nodes of width T in level order: by popcount, then by value
    (uint16). ``forest_fused16`` builds each level's nodes in this order."""
    nodes = np.arange(1 << t)
    pop = np.array([bin(v).count("1") for v in nodes])
    return nodes[np.lexsort((nodes, pop))].astype(np.uint16)


# the level order of each T on each device, made once
_ORDER: dict = {}
# per ForestPlan: its device and the launch arguments that do not change
# from call to call, made at its first launch and kept while it lives
_ARGS: "weakref.WeakKeyDictionary[ForestPlan, tuple]" = (
    weakref.WeakKeyDictionary())


def _order_on(t: int, device) -> torch.Tensor:
    key = (t, device)
    if key not in _ORDER:
        _ORDER[key] = torch.from_numpy(level_order(t).view(np.int16)).to(
            device)
    return _ORDER[key]


def _plan_args(fplan: ForestPlan) -> tuple:
    args = _ARGS.get(fplan)
    if args is None:
        device = fplan.rows.device
        if device.type != "cuda":
            raise ValueError(f"forest_fused16 runs a plan on a CUDA "
                             f"device, got {device}")
        if fplan.lead:
            raise ValueError(f"one plan per call, got stacked axes "
                             f"{fplan.lead}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        args = (device, sms, fplan.producer.data_ptr(),
                fplan.rows.data_ptr(), _order_on(fplan.t, device).data_ptr(),
                fplan.signs.data_ptr(), fplan.signs.shape[0])
        _ARGS[fplan] = args
    return args


def launch_fused16(fplan: ForestPlan, x: torch.Tensor, rows_layout: bool,
                   out: torch.Tensor) -> None:
    """One launch of ``forest_fused16`` (9 <= T <= 15) into ``out``: x (K,
    M) int32 -> out (N, G, M), or with ``rows_layout`` x (M, K) int8 -> out
    (M, G, N); x and out contiguous CUDA tensors on the plan's device.
    Raises if the kernel cannot be built or the launch fails."""
    lib = _library()
    device, sms, producer, rows, order, signs, s = _plan_args(fplan)
    if x.device != device:
        raise ValueError(f"forest_fused16 runs on CUDA tensors on one "
                         f"device, got x on {x.device} and the plan on "
                         f"{device}")
    m = x.shape[0] if rows_layout else x.shape[1]
    t, n, g = fplan.t, fplan.n, fplan.groups
    tl = wide_tiling(t, s, n, m, fplan.k // t // g, g, sms)
    err = lib.transitive_forest_fused16_launch(
        x.data_ptr(), int(rows_layout), fplan.k, m, producer, rows, order,
        signs, t, s, n, g, tl.bm, tl.jb, tl.nbuf, tl.bn, tl.cluster,
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"forest_fused16 launch failed: "
                           f"{lib.transitive_forest_dense_error(err).decode()}")
    transitive_forest_dense.launches += 1
    note_launch("B1.forest_fused16",
                (x, fplan.producer, fplan.rows, fplan.signs), (out,))


def transitive_forest_dense(dplan: DevicePlan, x: torch.Tensor
                            ) -> torch.Tensor:
    """Forest execution of ``x`` (K, M) -> int32 (N, M) / (N, G, M) from a
    tile-local DevicePlan of any T.

    CPU tensors take the plain version (``run_device``). Anything else
    must be a CUDA tensor, with the plan on the same device; the kernel is
    built at first use, and a build or launch failure raises."""
    if not isinstance(dplan, DevicePlan):
        raise TypeError(f"the dense forest kernel runs a DevicePlan, got "
                        f"{type(dplan).__name__}")
    if x.ndim != 2 or x.shape[0] != dplan.k:
        raise ValueError(f"x must be (K={dplan.k}, M), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return run_device(dplan, x)
    lib = _library()
    if x.device.type != "cuda":
        raise ValueError(f"transitive_forest_dense runs on CUDA or CPU "
                         f"tensors, got {x.device}")
    if dplan.lead:
        raise ValueError(f"one plan per call, got stacked axes {dplan.lead}")
    if not dplan.tile_local:
        raise ValueError("the CUDA forest needs a tile-local plan (compile "
                         "it with core.engine.compile_plan)")
    leaves = dplan.leaves()
    for name, a in leaves.items():
        if a.device != x.device or a.dtype != torch.int32 \
                or not a.is_contiguous():
            raise ValueError(f"plan leaf {name} must be contiguous int32 on "
                             f"{x.device}, got {a.dtype} on {a.device}")
    t, s = dplan.t, dplan.signs.shape[0]
    n, g, k = dplan.n, dplan.groups, dplan.k
    m = x.shape[1]
    out = torch.empty((n * g, m), dtype=torch.int32, device=x.device)
    if m:
        bm, in_smem = _columns_per_block(t, m)
        xt = x.to(torch.int32).contiguous()
        scratch = torch.empty(((k // t) << t, m), dtype=torch.int32,
                              device=x.device)
        work = None if in_smem else torch.empty(
            (k // t) * -(-m // bm) * 2 * (bm << t), dtype=torch.int32,
            device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.transitive_forest_dense_launch(
            xt.data_ptr(), k, m, leaves["level_src"].data_ptr(),
            leaves["level_xsrc"].data_ptr(), leaves["direct_idx"].data_ptr(),
            leaves["direct_bits"].data_ptr(), leaves["direct_idx"].shape[0],
            leaves["gather_idx"].data_ptr(), leaves["signs"].data_ptr(),
            t, s, n, g, bm, None if work is None else work.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"transitive_forest_dense launch failed: "
                f"{lib.transitive_forest_dense_error(err).decode()}")
        transitive_forest_dense.launches += 1
        note_launch("B1.forest_dense", (xt, *leaves.values()),
                    tuple(a for a in (work, scratch, out) if a is not None))
    out = out.reshape(n, g, m)
    return out[:, 0] if g == 1 else out


transitive_forest_dense.launches = 0
