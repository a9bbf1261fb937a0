"""The linear-recurrence kernel (CUDA C++, ``csrc/rg_lru.cu``).

Replaces the Pallas kernel ``repro/kernels/rg_lru.py`` (``rg_lru_pallas``).
:func:`rg_lru_cuda` computes ``h_t = a_t * h_{t-1} + x_t`` over x, a
(B, S, D) from h0 (B, D) with an f32 carry, h (B, S, D) in x's dtype. On
CPU tensors it runs the plain version (``kernels/ref.py::rg_lru_ref``, a
sequential f32 loop); on CUDA tensors it launches the kernel or raises.
Each launch adds one to ``rg_lru_cuda.launches``. x and a may each be
float32, bfloat16, float16 or float64; both compute in f32 and round h
once to x's dtype. Kernel and plain version round the same operations in
the same order, so they agree bit for bit; the reference's doubling scan
rounds otherwise. Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

__all__ = ["rg_lru_cuda", "rg_lru_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}


def _library() -> ctypes.CDLL:
    lib = build.load("rg_lru")
    if not getattr(lib, "_typed", False):
        lib.rg_lru_launch.argtypes = [_P, _I, _P, _I, _P, _I, _I, _I, _P,
                                      _P]
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rg_lru_launch(xc.data_ptr(), _DTYPE_CODE[x.dtype],
                            ac.data_ptr(), _DTYPE_CODE[a.dtype],
                            h0c.data_ptr(), b, s, d, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rg_lru launch failed: "
                           f"{lib.rg_lru_error(err).decode()}")
    rg_lru_cuda.launches += 1
    return out


rg_lru_cuda.launches = 0
