"""Public wrappers over the port's kernels (port of ``repro.kernels.ops``).

The signatures, output shapes and dtypes are the reference's, without its
``interpret`` argument: the tensors' device decides. On CPU tensors every
function runs its kernel's plain PyTorch version; on CUDA tensors it
launches the hand-written kernel (``repro_torch/csrc``) or raises. The
kernels mask ragged shapes themselves, so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rg_lru import rg_lru as _rg_lru
from repro_torch.kernels.transitive_forest import transitive_forest
from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
from repro_torch.kernels.w4a8_gemm import w4a8_gemm_cuda

__all__ = ["transitive_gemm", "transitive_gemm_grouped", "transitive_forest",
           "w4a8_gemm", "rg_lru"]


def transitive_gemm(qx: torch.Tensor, qw: torch.Tensor, *, w_bits: int = 8,
                    t: int = 8) -> torch.Tensor:
    """int32 [qx (..., K)] @ [qw (N, K)]^T via the transitive LUT kernel."""
    batch = qx.shape[:-1]
    out = transitive_gemm_cuda(qx.reshape(-1, qx.shape[-1]), qw,
                               w_bits=w_bits, t=t)
    return out.reshape(batch + (qw.shape[0],))


def transitive_gemm_grouped(xg: torch.Tensor, wg: torch.Tensor, *,
                            w_bits: int = 8, t: int = 8) -> torch.Tensor:
    """xg (..., G, g) x wg (N, G, g) -> (..., G, N) int32 group partials,
    all groups in one launch."""
    n, groups, g = wg.shape
    if tuple(xg.shape[-2:]) != (groups, g):
        raise ValueError(f"xg (..., G={groups}, g={g}) expected, got "
                         f"{tuple(xg.shape)}")
    batch = xg.shape[:-2]
    out = transitive_gemm_cuda(xg.reshape(-1, groups * g),
                               wg.reshape(n, groups * g), w_bits=w_bits,
                               t=t, groups=groups)
    return out.reshape(batch + (groups, n))


def w4a8_gemm(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
              sg: torch.Tensor, *, group: int = 128) -> torch.Tensor:
    """f32 (..., N): fused group-dequant GEMM."""
    batch = qx.shape[:-1]
    out = w4a8_gemm_cuda(qx.reshape(-1, qx.shape[-1]), sx.reshape(-1, 1),
                         qw, sg, group=group)
    return out.reshape(batch + (qw.shape[0],))


def rg_lru(x: torch.Tensor, a: torch.Tensor,
           h0: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + x_t over (B, S, D),
    differentiable in x, a and h0 (the backward runs the kernel over time
    reversed, ``kernels.rg_lru.rg_lru_grad``)."""
    return _rg_lru(x, a, h0)
