"""The Scoreboard forest kernel (CUDA C++, ``csrc/transitive_forest.cu``).

Replaces the Pallas kernel ``repro/kernels/transitive_forest.py``
(``transitive_forest_pallas``). :func:`transitive_forest` has the contract
of :func:`repro_torch.core.engine.run_device` — int32 (N, M) ungrouped,
(N, G, M) grouped — and is the ``engine_cuda`` backend's forest. On CPU
tensors it runs ``run_device``, the plain version; on CUDA tensors it
launches the kernel (two passes on the current stream, scratch and output
allocated here) or raises. Each launch adds one to
``transitive_forest.launches``.

The kernel needs a tile-local plan (``DevicePlan.tile_local``, checked
once when the plan is compiled): one CUDA block then owns one T-tile's
``2^T x bm`` psum table in shared memory. Bound and design notes are in
the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.engine import DevicePlan, run_device
from repro_torch.kernels import build

__all__ = ["transitive_forest", "forest_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("transitive_forest")
    if not getattr(lib, "_typed", False):
        lib.transitive_forest_launch.argtypes = [
            _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
            _P, _P, _P]
        lib.transitive_forest_launch.restype = _I
        lib.transitive_forest_smem.argtypes = [_I, _I]
        lib.transitive_forest_smem.restype = ctypes.c_size_t
        lib.transitive_forest_error.argtypes = [_I]
        lib.transitive_forest_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def forest_plain(dplan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (``run_device``), on any device."""
    return run_device(dplan, x)


def transitive_forest(dplan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Forest execution of ``x`` (K, M) through the CUDA kernel.

    CPU tensors take the plain version. Anything else must be a CUDA
    tensor, with the plan on the same device; the kernel is built at first
    use and a build or launch failure raises."""
    if x.device.type == "cpu":
        return run_device(dplan, x)
    lib = _library()
    if x.device.type != "cuda":
        raise ValueError(f"transitive_forest runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    if x.ndim != 2 or x.shape[0] != dplan.k:
        raise ValueError(f"x must be (K={dplan.k}, M), got {tuple(x.shape)}")
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
    xt = x.to(torch.int32).contiguous()
    out = torch.empty((n * g, m), dtype=torch.int32, device=x.device)
    if m == 0:
        return out.reshape(n, g, 0)[:, 0] if g == 1 else out.reshape(n, g, 0)
    bm = min(16, m)                  # columns per pass-1 block
    scratch = torch.empty(((k // t) << t, m), dtype=torch.int32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.transitive_forest_launch(
        xt.data_ptr(), k, m, leaves["level_src"].data_ptr(),
        leaves["level_xsrc"].data_ptr(), leaves["direct_idx"].data_ptr(),
        leaves["direct_bits"].data_ptr(), leaves["direct_idx"].shape[0],
        leaves["gather_idx"].data_ptr(), leaves["signs"].data_ptr(),
        t, s, n, g, bm, scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"transitive_forest launch failed: "
                           f"{lib.transitive_forest_error(err).decode()}")
    transitive_forest.launches += 1
    out = out.reshape(n, g, m)
    return out[:, 0] if g == 1 else out


transitive_forest.launches = 0
