"""The Scoreboard forest kernel (CUDA C++, ``csrc/transitive_forest.cu``).

Replaces the Pallas kernel ``repro/kernels/transitive_forest.py``
(``transitive_forest_pallas``). The kernel executes a compact
:class:`~repro_torch.core.engine.ForestPlan` (one byte per node and per
APE gather, :func:`~repro_torch.core.engine.pack_forest_plan`) in one
fused pass: each block keeps its tiles' psum tables in shared memory from
the first level to the APE sum. Two entries, one launch each:

  * :func:`transitive_forest` — the reference's contract: int32 x (K, M)
    -> (N, M) ungrouped, (N, G, M) grouped, from a ``ForestPlan`` or a
    ``DevicePlan`` (packed at its first call and kept: the route of
    ``kernels.ops`` and of callers holding dense plans);
  * :func:`transitive_forest_rows` — the serving layout: int8 codes
    (B, K) as ``quantize_per_token`` makes them -> (B, N) or (B, G, N),
    with no cast, transpose or copy around the call (backend
    ``engine_cuda``).

On CPU tensors both run the plain version of the route's kernel
(:func:`forest_plan_plain`, :func:`sparse_forest_plain` or ``run_device``);
on CUDA tensors they launch the kernel or raise. Bound and design notes are
in the CUDA sources.

The route, the same for both entries:

  * T <= 8 (uint8 gathers): ``forest_narrow`` / ``forest_wide`` of
    ``csrc/transitive_forest.cu``; each launch adds one to
    ``transitive_forest.launches``;
  * 9 <= T <= 15 (int16 gathers): ``forest_fused16`` of
    ``csrc/transitive_forest_dense.cu``
    (:func:`~repro_torch.kernels.transitive_forest_dense.launch_fused16`),
    from the same ForestPlan, also one fused launch with no cast or
    transpose around it; it counts in ``transitive_forest_dense.launches``;
  * T >= 16: a :class:`SparseForestPlan` (a DevicePlan is packed into one
    at its first call and kept, as above) runs through ``forest_sparse``
    of ``csrc/transitive_forest_sparse.cu``
    (:func:`~repro_torch.kernels.transitive_forest_sparse.launch_sparse`),
    one fused launch, counted in ``launch_sparse.launches``;
  * T >= 16 where one column of a tile's compact table does not fit
    shared memory (``sparse_fits``, from the plan's made nodes alone,
    :func:`~repro_torch.core.engine.sparse_forest_slots`): the DevicePlan
    is not packed, and the two-pass dense kernel
    (:func:`~repro_torch.kernels.transitive_forest_dense.transitive_forest_dense`,
    counted in ``transitive_forest_dense.launches``) runs it, or
    ``run_device`` on CPU tensors.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.core.engine import (FOREST_MAX_T, FOREST_WIDE_MAX_T,
                                     DevicePlan, ForestPlan,
                                     SparseForestPlan, forest_plan_plain,
                                     pack_forest_plan,
                                     pack_sparse_forest_plan, run_device,
                                     sparse_forest_plain,
                                     sparse_forest_slots)
from repro_torch.kernels import build
from repro_torch.kernels.transitive_forest_dense import (
    launch_fused16, transitive_forest_dense)
from repro_torch.kernels.transitive_forest_sparse import (launch_sparse,
                                                          sparse_fits)
from repro_torch.tracepoints import note_launch

__all__ = ["transitive_forest", "transitive_forest_rows", "forest_plain",
           "forest_plan_plain", "sparse_forest_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("transitive_forest")
    if not getattr(lib, "_typed", False):
        lib.transitive_forest_launch.argtypes = [
            _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P]
        lib.transitive_forest_launch.restype = _I
        lib.transitive_forest_error.argtypes = [_I]
        lib.transitive_forest_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def forest_plain(dplan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """The dense plan's plain version (``run_device``), on any device."""
    return run_device(dplan, x)


# The packing of each DevicePlan handed to an entry, per device, kept while
# the DevicePlan lives: a dense plan is packed at its first call only (None:
# too wide to pack, the two-pass kernel runs the DevicePlan itself).
_PACKED: "weakref.WeakKeyDictionary[DevicePlan, dict]" = (
    weakref.WeakKeyDictionary())


def _pack(dplan: DevicePlan, device):
    if dplan.t <= FOREST_WIDE_MAX_T:
        return pack_forest_plan(dplan, device=device)
    if sparse_fits(dplan.t, dplan.bits, sparse_forest_slots(dplan)):
        return pack_sparse_forest_plan(dplan, device=device)
    return None


def _compact(plan, device):
    """The plan the kernels run: a ForestPlan or SparseForestPlan as it
    is; a DevicePlan's packing (made at its first call on ``device``), or
    the DevicePlan itself where it is too wide to pack."""
    if isinstance(plan, (ForestPlan, SparseForestPlan)):
        return plan
    if isinstance(plan, DevicePlan):
        per_device = _PACKED.setdefault(plan, {})
        if device not in per_device:
            per_device[device] = _pack(plan, device)
        packed = per_device[device]
        return plan if packed is None else packed
    raise TypeError(f"plan must be a ForestPlan, a SparseForestPlan or a "
                    f"DevicePlan, got {type(plan).__name__}")


def _plain(plan, x: torch.Tensor) -> torch.Tensor:
    if isinstance(plan, SparseForestPlan):
        return sparse_forest_plain(plan, x)
    return forest_plan_plain(plan, x)


def _launch(fplan, x: torch.Tensor, rows_layout: bool,
            out: torch.Tensor) -> None:
    if isinstance(fplan, SparseForestPlan):
        launch_sparse(fplan, x, rows_layout, out)
        return
    if fplan.t > FOREST_MAX_T:
        launch_fused16(fplan, x, rows_layout, out)
        return
    lib = _library()
    if x.device.type != "cuda" or fplan.rows.device != x.device:
        raise ValueError(f"transitive_forest runs on CUDA or CPU tensors on "
                         f"one device, got x on {x.device} and the plan on "
                         f"{fplan.rows.device}")
    if fplan.lead:
        raise ValueError(f"one plan per call, got stacked axes {fplan.lead}")
    m = x.shape[0] if rows_layout else x.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.transitive_forest_launch(
        x.data_ptr(), int(rows_layout), fplan.k, m,
        fplan.producer.data_ptr(), fplan.rows.data_ptr(),
        fplan.signs.data_ptr(), fplan.t, fplan.signs.shape[0], fplan.n,
        fplan.groups, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"transitive_forest launch failed: "
                           f"{lib.transitive_forest_error(err).decode()}")
    transitive_forest.launches += 1
    note_launch("B1.forest_narrow" if m <= 8 else "B1.forest_wide",
                (x, fplan.producer, fplan.rows, fplan.signs), (out,))


def transitive_forest(plan, x: torch.Tensor) -> torch.Tensor:
    """Forest execution of ``x`` (K, M) -> int32 (N, M) / (N, G, M).

    ``plan`` is a :class:`ForestPlan` or :class:`SparseForestPlan`, used
    as it is, or a :class:`DevicePlan`, packed at its first call on a
    device (the packing is kept while the DevicePlan lives; see the module
    docstring for the route). CPU tensors take the plain version. Anything
    else must be a CUDA tensor, with the plan on the same device; the
    kernel is built at first use and a build or launch failure raises."""
    if x.ndim != 2 or x.shape[0] != plan.k:
        raise ValueError(f"x must be (K={plan.k}, M), got {tuple(x.shape)}")
    fplan = _compact(plan, x.device)
    if isinstance(fplan, DevicePlan):
        return transitive_forest_dense(fplan, x)
    if x.device.type == "cpu":
        return _plain(fplan, x)
    n, g, m = fplan.n, fplan.groups, x.shape[1]
    out = torch.empty((n, g, m), dtype=torch.int32, device=x.device)
    if m:
        xt = x if x.dtype == torch.int32 else x.to(torch.int32)
        _launch(fplan, xt.contiguous(), False, out)
    return out[:, 0] if g == 1 else out


def transitive_forest_rows(plan, qx: torch.Tensor) -> torch.Tensor:
    """Forest execution of token rows: int8 ``qx`` (B, K) -> int32 (B, N)
    ungrouped, (B, G, N) grouped (``x @ W^T`` per group).

    Same plan types and device rules as :func:`transitive_forest`; on a
    CUDA tensor the codes must be int8 (the quantized linear's)."""
    if qx.ndim != 2 or qx.shape[1] != plan.k:
        raise ValueError(f"qx must be (B, K={plan.k}), got "
                         f"{tuple(qx.shape)}")
    fplan = _compact(plan, qx.device)
    if isinstance(fplan, DevicePlan) or qx.device.type == "cpu":
        y = (transitive_forest_dense(fplan, qx.T.to(torch.int32))
             if isinstance(fplan, DevicePlan) else _plain(fplan, qx.T))
        return y.T if y.ndim == 2 else y.permute(2, 1, 0)
    if qx.dtype != torch.int8:
        raise ValueError(f"transitive_forest_rows takes int8 codes on "
                         f"CUDA, got {qx.dtype}")
    n, g, b = fplan.n, fplan.groups, qx.shape[0]
    out = torch.empty((b, g, n), dtype=torch.int32, device=qx.device)
    if b:
        _launch(fplan, qx.contiguous(), True, out)
    return out[:, 0] if g == 1 else out


transitive_forest.launches = 0
