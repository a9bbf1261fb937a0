"""The Scoreboard forest for plans with T >= 16 (CUDA C++,
``csrc/transitive_forest_sparse.cu``): ``forest_sparse``, one fused launch
per call from a :class:`~repro_torch.core.engine.SparseForestPlan`.

Replaces the Pallas kernel ``repro/kernels/transitive_forest.py``
(``transitive_forest_pallas``) for such plans. From T = 16 a node no longer
fits the int16 gathers of ``forest_fused16`` and one column of a tile's
full table no longer fits a block's shared memory; the sparse plan keeps
only the nodes the planner makes (~8,700 of 65,536 per tile at N = 1536,
W4), renumbered densely in level order, so a slot fits int16 and a column
of the table ~35 KB.

:func:`launch_sparse` is the launch both entries of
``kernels/transitive_forest.py`` make ((K, M) int32 and the serving
layout's int8 (M, K) codes), on CUDA tensors only; each launch adds one to
``launch_sparse.launches``. :func:`sparse_tiling` picks the tiling on the
host (mirrored by ``sparse_smem`` in the source), and :func:`sparse_fits`
says whether a plan's table fits shared memory at all: where it does not,
the wrappers run the DevicePlan through the two-pass kernel of
``kernels/transitive_forest_dense.py`` instead, a route picked from the
plan's size alone, never from a failed build or launch (which raise).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch

from repro_torch.core.engine import SPARSE_MAX_SLOT, SparseForestPlan
from repro_torch.kernels import build
from repro_torch.tracepoints import note_launch

__all__ = ["launch_sparse", "sparse_tiling", "SparseTiling", "sparse_smem",
           "sparse_fits"]

_P = ctypes.c_void_p
_I = ctypes.c_int

_SMEM_LIMIT = 232448            # bytes of shared memory a block may use
_MAX_CLUSTER = 16


def _library() -> ctypes.CDLL:
    lib = build.load("transitive_forest_sparse")
    if not getattr(lib, "_typed", False):
        lib.transitive_forest_sparse_launch.argtypes = [
            _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _I, _P, _P]
        lib.transitive_forest_sparse_launch.restype = _I
        lib.transitive_forest_sparse_smem.argtypes = [_I] * 6
        lib.transitive_forest_sparse_smem.restype = ctypes.c_size_t
        lib.transitive_forest_sparse_error.argtypes = [_I]
        lib.transitive_forest_sparse_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def sparse_smem(t: int, s: int, u: int, bm: int, nbuf: int, bn: int) -> int:
    """Shared memory of one ``forest_sparse`` block, the kernel's carve-up:
    the table (max(U, BN + 1 rounded up to 4) rows of bm int32), the
    round's T x bm activations (padded to 4 words), 32 level bounds, 8
    plane weights, nbuf x U codes (int32) and nbuf x S rows rows of bn + 8
    int16."""
    rows = max(u, (bn + 4) & ~3)
    return (rows * bm * 4 + ((t * bm + 3) & ~3) * 4 + 32 * 4 + 8 * 4
            + nbuf * u * 4 + nbuf * s * (bn + 8) * 2)


@dataclasses.dataclass(frozen=True)
class SparseTiling:
    """The launch of ``forest_sparse``: bm columns and bn outputs per
    block, nbuf plan buffers (2: the next round's bytes load during this
    one), a cluster of ``cluster`` blocks per group."""
    bm: int
    nbuf: int
    bn: int
    cluster: int
    smem: int


def sparse_fits(t: int, s: int, u: int) -> bool:
    """Whether a plan of width T, S planes and U table rows fits
    ``forest_sparse`` at all: U - 1 slots fit int16 and the smallest
    tiling (one column, 64 outputs, one buffer) fits 227 KiB. The forest
    wrappers and ``engine_cuda`` route a plan that does not to the
    two-pass kernel."""
    return u - 1 <= SPARSE_MAX_SLOT and sparse_smem(t, s, u, 1, 1, 64) \
        <= _SMEM_LIMIT


@functools.lru_cache(maxsize=1024)
def sparse_tiling(t: int, s: int, u: int, n: int, m: int, jg: int
                  ) -> SparseTiling:
    """The tiling of ``forest_sparse`` for width T, S planes, U table rows,
    N outputs, M columns and jg tiles per group: a cluster of min(16, jg)
    ranks (every rank has a tile in the first round); then, of the tilings
    that fit 227 KiB, the most columns (bm a power of two up to the one >=
    M and <= 8), then the most outputs per block (bn in {64, ..., 512} up
    to the power of two >= N: each block builds its tables anew, so fewer
    blocks per column build less), then two plan buffers where a group has
    more than one round. Raises if none fits (:func:`sparse_fits`)."""
    cluster = min(_MAX_CLUSTER, jg)
    rounds = -(-jg // cluster)
    bm_max = min(8, 1 << max(0, m - 1).bit_length())
    bn_max = min(512, max(64, 1 << max(0, n - 1).bit_length()))
    for bm in (8, 4, 2, 1):
        if bm > bm_max:
            continue
        for bn in (512, 256, 128, 64):
            if bn > bn_max:
                continue
            for nbuf in ((2, 1) if rounds > 1 else (1,)):
                smem = sparse_smem(t, s, u, bm, nbuf, bn)
                if smem <= _SMEM_LIMIT:
                    return SparseTiling(bm, nbuf, bn, cluster, smem)
    raise ValueError(f"forest_sparse has no tiling that fits T={t}, S={s}, "
                     f"U={u}: the two-pass kernel runs such plans")


# per SparseForestPlan: its device and the launch arguments that do not
# change from call to call, made at its first launch and kept while it lives
_ARGS: "weakref.WeakKeyDictionary[SparseForestPlan, tuple]" = (
    weakref.WeakKeyDictionary())


def _plan_args(splan: SparseForestPlan) -> tuple:
    args = _ARGS.get(splan)
    if args is None:
        device = splan.rows.device
        if device.type != "cuda":
            raise ValueError(f"forest_sparse runs a plan on a CUDA device, "
                             f"got {device}")
        if splan.lead:
            raise ValueError(f"one plan per call, got stacked axes "
                             f"{splan.lead}")
        args = (device, splan.codes.data_ptr(), splan.bounds.data_ptr(),
                splan.rows.data_ptr(), splan.signs.data_ptr(),
                splan.signs.shape[0])
        _ARGS[splan] = args
    return args


def launch_sparse(splan: SparseForestPlan, x: torch.Tensor,
                  rows_layout: bool, out: torch.Tensor) -> None:
    """One launch of ``forest_sparse`` into ``out``: x (K, M) int32 -> out
    (N, G, M), or with ``rows_layout`` x (M, K) int8 -> out (M, G, N); x
    and out contiguous CUDA tensors on the plan's device. Raises if the
    kernel cannot be built or the launch fails."""
    lib = _library()
    device, codes, bounds, rows, signs, s = _plan_args(splan)
    if x.device != device:
        raise ValueError(f"forest_sparse runs on CUDA tensors on one "
                         f"device, got x on {x.device} and the plan on "
                         f"{device}")
    m = x.shape[0] if rows_layout else x.shape[1]
    t, n, g, u = splan.t, splan.n, splan.groups, splan.slots
    tl = sparse_tiling(t, s, u, n, m, splan.k // t // g)
    err = lib.transitive_forest_sparse_launch(
        x.data_ptr(), int(rows_layout), splan.k, m, codes, bounds, rows,
        signs, t, s, n, g, u, tl.bm, tl.nbuf, tl.bn, tl.cluster,
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"forest_sparse launch failed: "
            f"{lib.transitive_forest_sparse_error(err).decode()}")
    launch_sparse.launches += 1
    note_launch("B1.forest_sparse", (x, *splan.leaves().values()), (out,))


launch_sparse.launches = 0
