"""The group-dequant W4/W8 x A8 GEMM kernel (CUDA C++,
``csrc/w4a8_gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/w4a8_gemm.py``
(``w4a8_gemm_pallas``). :func:`w4a8_gemm_cuda` computes f32 (M, N) =
(sum over groups of the exact int32 group dot x the group scale) x the
token scale, for qx (M, K) int8, sx (M, 1) f32, qw (N, K) int8 and sg
(N, K // group) f32. On CPU tensors it runs the plain version
(``kernels/ref.py::w4a8_matmul_ref``); on CUDA tensors it launches the
kernel or raises. Each launch adds one to ``w4a8_gemm_cuda.launches``.
The kernel walks K in activation tiles that fit shared memory (any K) and
dots four codes per instruction when ``group % 4 == 0``, one otherwise. It
sums the f32 group terms in another order than the plain version, so the
two agree within a tolerance. Bound and design notes are
in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

__all__ = ["w4a8_gemm_cuda", "w4a8_gemm_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("w4a8_gemm")
    if not getattr(lib, "_typed", False):
        lib.w4a8_gemm_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                         _P]
        lib.w4a8_gemm_launch.restype = _I
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
    if group % 4 == 0:                         # 32-bit loads of 4 codes
        if xc.data_ptr() % 4:
            xc = xc.clone()
        if wc.data_ptr() % 4:
            wc = wc.clone()
    sxc = sx.to(torch.float32).reshape(m).contiguous()
    sgc = sg.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.w4a8_gemm_launch(xc.data_ptr(), sxc.data_ptr(), wc.data_ptr(),
                               sgc.data_ptr(), m, n, k, group,
                               out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"w4a8_gemm launch failed: "
                           f"{lib.w4a8_gemm_error(err).decode()}")
    w4a8_gemm_cuda.launches += 1
    return out


w4a8_gemm_cuda.launches = 0
