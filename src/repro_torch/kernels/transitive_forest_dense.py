"""The Scoreboard forest from a dense DevicePlan of any T (CUDA C++,
``csrc/transitive_forest_dense.cu``).

The compact :class:`~repro_torch.core.engine.ForestPlan` that the fused
forest kernel (``kernels/transitive_forest.py``) executes holds a node in
one byte, so it takes T <= 8. Tile-local plans with T > 8 run here, from
the :class:`~repro_torch.core.engine.DevicePlan` itself, in two passes:
pass 1 builds each tile's 2^T x bm psum table in shared memory level by
level into a (J * 2^T, M) int32 scratch, pass 2 sums the APE gathers.
Together they replace the Pallas kernel
``repro/kernels/transitive_forest.py`` (``transitive_forest_pallas``) for
those plans; the reference runs a DevicePlan of any T.

:func:`transitive_forest_dense` takes int32 x (K, M) and returns (N, M)
ungrouped, (N, G, M) grouped. On CPU tensors it runs the plain version,
``run_device``; on CUDA tensors it launches the kernel or raises. Each
launch adds one to ``transitive_forest_dense.launches``. Pass 1 keeps the
tile's activation rows ((T + 1) * bm int32) in shared memory, and its two
level tables (2 * 2^T * bm int32) there too where they fit: bm (columns
per block) is halved from 16 until they fit 227 KiB, which holds up to
T = 14. From T = 15 the tables live in a global-memory workspace (two
per block, bm = min(16, M)) that the wrapper allocates; the result is
the same.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import DevicePlan, run_device
from repro_torch.kernels import build

__all__ = ["transitive_forest_dense"]

_P = ctypes.c_void_p
_I = ctypes.c_int

_SMEM_LIMIT = 232448            # bytes of shared memory a block may use


def _library() -> ctypes.CDLL:
    lib = build.load("transitive_forest_dense")
    if not getattr(lib, "_typed", False):
        lib.transitive_forest_dense_launch.argtypes = [
            _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
            _P, _P, _P, _P]
        lib.transitive_forest_dense_launch.restype = _I
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
    out = out.reshape(n, g, m)
    return out[:, 0] if g == 1 else out


transitive_forest_dense.launches = 0
