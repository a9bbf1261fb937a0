"""The doubling-LUT transitive GEMM kernel (CUDA C++,
``csrc/transitive_gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/transitive_gemm.py``
(``transitive_gemm_pallas``). :func:`transitive_gemm_cuda` computes the
int32 ``qx (M, K) @ qw (N, K)^T`` of int8 operands (``qw`` holding
``w_bits``-bit values) with transitive result reuse, in one launch for
all ``groups`` equal slices of K: out (M, groups, N). On CPU tensors it
runs the plain version (:mod:`repro_torch.kernels.ref`); on CUDA tensors
it launches the kernel ``tgemm_lut`` or raises, and each launch adds one
to ``transitive_gemm_cuda.launches``.

The reference's T (any T with (K / groups) % T == 0; T <= 32, its
TransRow patterns being 32-bit) only blocks K: every T gives the same
int32 result. So every T runs through the one kernel, at a subtile width
of the kernel's own that :func:`lut_width` picks from K and groups: 8 or
4 in the aligned instances, else 4 in the unaligned one (bytes staged by
plain loads, each group's last subtile zero-filled).

The kernel reads the int8 weight directly (no packed TransRows), keeps
two activation rows per 32-bit LUT word, masks ragged M and N itself and,
when there are few output tiles, splits K across the blocks of a thread
block cluster (:func:`k_split` picks the split; the cluster adds its
partial sums through distributed shared memory). Bound and design notes
are in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.tracepoints import note_launch

__all__ = ["transitive_gemm_cuda", "transitive_gemm_plain", "lut_width",
           "k_split"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# The kernel's tiling (csrc/transitive_gemm.cu): columns per block,
# subtiles per chunk, blocks per cluster at most.
_NT, _CH, _MAX_SPLIT = 128, 8, 8

_LIB: list[ctypes.CDLL] = []
_SMS: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("transitive_gemm")
        lib.transitive_gemm_launch.argtypes = [
            _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
        lib.transitive_gemm_launch.restype = _I
        lib.transitive_gemm_error.argtypes = [_I]
        lib.transitive_gemm_error.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _sm_count(device: torch.device) -> int:
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lut_width(k: int, groups: int) -> tuple[int, bool]:
    """The kernel's subtile width for K in ``groups`` groups, and whether
    the aligned instance takes it: 8 where K / groups is a multiple of 8,
    else 4 where it is a multiple of 4 (K, a multiple of K / groups, is
    one too, so every row and group starts on a width-byte boundary, as
    the aligned instances' cp.async copies need), else 4 in the unaligned
    instance."""
    kg = k // groups
    if kg % 8 == 0:
        return 8, True
    return 4, kg % 4 == 0


def k_split(m: int, n: int, k: int, groups: int, width: int,
            sms: int) -> int:
    """Blocks per output tile along K (one thread block cluster, <= 8).

    Output tiles are 128 columns x 4 (M <= 4), 8 (M <= 8) or 16 rows per
    group. With fewer tiles than two per SM, each group's chunks of 8
    subtiles of the kernel's ``width`` (a ragged last one included) are
    split as far as a cluster allows: the fewest chunks per block that
    keep the split at 8 or below."""
    rows = 4 if m <= 4 else 8 if m <= 8 else 16
    chunks = _cdiv(_cdiv(k // groups, width), _CH)
    tiles = _cdiv(n, _NT) * _cdiv(m, rows) * groups
    if tiles >= 2 * sms:
        return 1
    return _cdiv(chunks, _cdiv(chunks, _MAX_SPLIT))


def _check(qx: torch.Tensor, qw: torch.Tensor, t: int, groups: int) -> None:
    if qx.ndim != 2 or qw.ndim != 2 or qx.shape[1] != qw.shape[1]:
        raise ValueError(f"need qx (M, K) and qw (N, K), got "
                         f"{tuple(qx.shape)} and {tuple(qw.shape)}")
    k = qx.shape[1]
    if groups < 1 or k % groups or (k // groups) % t:
        raise ValueError(f"K={k} must split into {groups} groups whose "
                         f"length is divisible by T={t}")
    if qx.device.type != "cpu" and not 1 <= t <= 32:
        raise ValueError(f"TransRow patterns are 32-bit, as the "
                         f"reference's: T <= 32 on the card, got T={t}")


def transitive_gemm_plain(qx: torch.Tensor, qw: torch.Tensor, *,
                          w_bits: int = 8, t: int = 8,
                          groups: int = 1) -> torch.Tensor:
    """The plain version (``kernels/ref.py``), on any device: int32
    (M, groups, N)."""
    _check(qx, qw, t, groups)
    m, k = qx.shape
    g = k // groups
    return ref.transitive_matmul_grouped_ref(
        qx.reshape(m, groups, g), qw.reshape(qw.shape[0], groups, g),
        w_bits, t)


def _operands(qx: torch.Tensor, qw: torch.Tensor, w_bits: int):
    """The kernel's operand checks; returns contiguous int8 operands with
    x 4-byte and w 8-byte aligned."""
    if qx.device.type != "cuda" or qw.device != qx.device:
        raise ValueError(f"transitive_gemm runs on CUDA or CPU tensors on "
                         f"one device, got {qx.device} and {qw.device}")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"the kernel takes int8 operands, got {qx.dtype} "
                         f"and {qw.dtype}")
    if not 2 <= w_bits <= 8:
        raise ValueError(f"the kernel covers w_bits in 2..8, got {w_bits}")
    xc = qx.contiguous()
    wc = qw.contiguous()
    if xc.data_ptr() % 4:                      # the kernel loads 4 bytes
        xc = xc.clone()
    if wc.data_ptr() % 8:                      # and up to 8 weight bytes
        wc = wc.clone()
    return xc, wc


def transitive_gemm_cuda(qx: torch.Tensor, qw: torch.Tensor, *,
                         w_bits: int = 8, t: int = 8,
                         groups: int = 1) -> torch.Tensor:
    """int32 (M, groups, N) = per group g: qx[:, g] @ qw[:, g]^T.

    CPU tensors take the plain version. Anything else must be a CUDA
    tensor; the kernel needs int8 operands, w_bits in 2..8 and T <= 32, is
    built at first use, and a build or launch failure raises. Every T is
    one launch of the kernel, at the width :func:`lut_width` picks."""
    _check(qx, qw, t, groups)
    if qx.device.type == "cpu":
        return transitive_gemm_plain(qx, qw, w_bits=w_bits, t=t,
                                     groups=groups)
    lib = _library()
    xc, wc = _operands(qx, qw, w_bits)
    m, k = qx.shape
    n = qw.shape[0]
    out = torch.empty((m, groups, n), dtype=torch.int32, device=qx.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    width = lut_width(k, groups)[0]
    ksplit = k_split(m, n, k, groups, width, _sm_count(qx.device))
    stream = torch.cuda.current_stream(qx.device).cuda_stream
    err = lib.transitive_gemm_launch(
        xc.data_ptr(), wc.data_ptr(), m, n, k, groups, w_bits, width, ksplit,
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"transitive_gemm launch failed: "
                           f"{lib.transitive_gemm_error(err).decode()}")
    transitive_gemm_cuda.launches += 1
    note_launch("B3.tgemm_lut", (xc, wc), (out,))
    return out


transitive_gemm_cuda.launches = 0
