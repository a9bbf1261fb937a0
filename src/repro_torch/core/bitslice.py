"""Bit-slicing of quantized integer matrices into binary TransRow planes.

The paper (Sec. 2.1-2.2) decomposes an S-bit 2's-complement integer matrix
``W (N, K)`` into S binary planes ``B_s (N, K)`` such that

    W = sum_s  sigma_s * 2^s * B_s,      sigma_{S-1} = -1, else +1.

Planes are then chunked along K into T-bit **TransRows** — unsigned integers
in [0, 2^T) — which are the fundamental unit of transitive sparsity.

The numpy half is the host planner's; the torch half
(:func:`bit_planes_torch`, :func:`pack_transrows_torch`, the
counterparts of the reference's ``*_jnp`` pair) runs on any device for
the plain LUT GEMM in ``kernels/ref.py``. Both are shape-static and
bit-exact. TransRows are ``uint32`` in numpy and ``int64`` in torch (CPU
torch has little ``uint32`` arithmetic); the values are the same.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bit_planes",
    "plane_signs",
    "reconstruct_from_planes",
    "pack_transrows",
    "unpack_transrows",
    "transrow_matrix",
    "bit_planes_torch",
    "pack_transrows_torch",
]


def plane_signs(bits: int) -> np.ndarray:
    """Per-plane signed weights (+2^s, MSB gets -2^(S-1)) for 2's complement."""
    if bits < 2:
        raise ValueError(f"need >=2 bits for signed slicing, got {bits}")
    w = 2.0 ** np.arange(bits)
    signs = np.ones(bits)
    signs[-1] = -1.0
    return (signs * w).astype(np.int64)


def bit_planes(w: np.ndarray, bits: int) -> np.ndarray:
    """Slice an integer matrix into its binary planes.

    Args:
      w: integer array, values in [-2^(bits-1), 2^(bits-1)).
      bits: S, the quantized bit width.

    Returns:
      uint8 array of shape (bits,) + w.shape with entries in {0, 1};
      plane ``s`` holds bit ``s`` of the 2's-complement representation.
    """
    # widen first: narrow int dtypes (int8 weights) overflow the 2's
    # complement shift below under NumPy 2 scalar promotion
    w = np.asarray(w).astype(np.int64, copy=False)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if w.min(initial=0) < lo or w.max(initial=0) > hi:
        raise ValueError(f"values outside int{bits} range [{lo}, {hi}]")
    # 2's complement of negatives within `bits` bits.
    u = np.where(w < 0, w + (1 << bits), w).astype(np.uint32)
    planes = np.stack([(u >> s) & 1 for s in range(bits)]).astype(np.uint8)
    return planes


def reconstruct_from_planes(planes: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of :func:`bit_planes` (int64, bit-exact)."""
    signs = plane_signs(bits)
    return np.tensordot(signs, planes.astype(np.int64), axes=(0, 0))


def pack_transrows(planes: np.ndarray, t: int) -> np.ndarray:
    """Pack binary planes into T-bit TransRow integers along the last axis.

    Args:
      planes: uint8 {0,1} array (..., K) with K divisible by ``t``.
      t: TransRow width T.

    Returns:
      uint32 array (..., K // t); element j encodes bits
      planes[..., j*t : (j+1)*t] with **bit i = column (j*t + i)**
      (column 0 is the least-significant bit).
    """
    k = planes.shape[-1]
    if k % t:
        raise ValueError(f"K={k} not divisible by T={t}")
    chunks = planes.reshape(planes.shape[:-1] + (k // t, t)).astype(np.uint32)
    weights = (1 << np.arange(t)).astype(np.uint32)
    return (chunks * weights).sum(-1).astype(np.uint32)


def unpack_transrows(rows: np.ndarray, t: int) -> np.ndarray:
    """Inverse of :func:`pack_transrows` → uint8 planes (..., K)."""
    rows = np.asarray(rows, dtype=np.uint32)
    bits = ((rows[..., None] >> np.arange(t, dtype=np.uint32)) & 1).astype(np.uint8)
    return bits.reshape(rows.shape[:-1] + (rows.shape[-1] * t,))


def transrow_matrix(w: np.ndarray, bits: int, t: int) -> np.ndarray:
    """Full pipeline: int matrix (N, K) → TransRows (bits, N, K//t) uint32.

    Axis 0 is the bit level (shift s); the paper's flattened (S*N, K//t)
    layout is a reshape of this.
    """
    return pack_transrows(bit_planes(w, bits), t)


# --- torch variants (any device; used by the plain LUT GEMM) ---------------

def bit_planes_torch(w: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 {0, 1} planes (bits,) + w.shape of the ``bits``-bit 2's
    complement of integer ``w`` (no range check, like the reference's
    ``bit_planes_jnp``: bits above ``bits`` are dropped)."""
    w = w.to(torch.int64)
    u = torch.where(w < 0, w + (1 << bits), w)
    return torch.stack([(u >> s) & 1 for s in range(bits)]).to(torch.uint8)


def pack_transrows_torch(planes: torch.Tensor, t: int) -> torch.Tensor:
    """int64 TransRows (..., K // t) of uint8 planes (..., K): bit i of
    element j is column j*t + i, as :func:`pack_transrows`."""
    k = planes.shape[-1]
    if k % t:
        raise ValueError(f"K={k} not divisible by T={t}")
    chunks = planes.reshape(planes.shape[:-1] + (k // t, t)).to(torch.int64)
    weights = 1 << torch.arange(t, dtype=torch.int64, device=planes.device)
    return (chunks * weights).sum(-1)
