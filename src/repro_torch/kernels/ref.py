"""Plain PyTorch versions of the GEMM and recurrence kernels (port of
``repro.kernels.ref``), bit-exact where the reference's are.

The transitive versions run the paper's result-reuse dataflow with a
*dense doubling LUT*: per T-wide k-tile, all 2^T subset sums of the input
rows are built in T concat-add steps — ``LUT[p] = LUT[p & (p-1)] +
x[lsb(p)]``, the complete Hasse graph with every node's prefix at
distance 1. Weight TransRows gather their subset sum and shift-accumulate
across bit planes with 2's-complement signs. Integer work is done in
int64 and cast to int32 at the end, which is the reference's wrapping
int32 accumulator modulo 2^32.

They run on any device: the ``lut`` backend calls them directly, and
each kernel wrapper (``kernels/transitive_gemm.py``, ``w4a8_gemm.py``,
``rg_lru.py``) calls them for CPU tensors and ``chip_smoke.py`` holds
the kernels against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice

__all__ = ["lut_build_ref", "transitive_matmul_ref",
           "transitive_matmul_grouped_ref", "w4a8_matmul_ref", "rg_lru_ref"]


def lut_build_ref(xt: torch.Tensor) -> torch.Tensor:
    """Subset-sum LUT by doubling. xt (..., t) int -> (..., 2^t) int32."""
    t = xt.shape[-1]
    xt = xt.to(torch.int64)
    lut = torch.zeros(xt.shape[:-1] + (1,), dtype=torch.int64,
                      device=xt.device)
    for b in range(t):
        lut = torch.cat([lut, lut + xt[..., b:b + 1]], dim=-1)
    return lut.to(torch.int32)


def _transrows(qw: torch.Tensor, w_bits: int, t: int) -> torch.Tensor:
    """(N, K) int -> (S, N, K//t) int64 TransRow patterns."""
    planes = bitslice.bit_planes_torch(qw, w_bits)
    return bitslice.pack_transrows_torch(planes, t)


def transitive_matmul_ref(qx: torch.Tensor, qw: torch.Tensor,
                          w_bits: int = 8, t: int = 8) -> torch.Tensor:
    """int32 [qx (..., K)] @ [qw (N, K)]^T via transitive-reuse execution."""
    k = qx.shape[-1]
    n = qw.shape[0]
    if qw.shape[1] != k or k % t:
        raise ValueError(f"need qw (N, K={k}) with K divisible by T={t}; "
                         f"got qx {tuple(qx.shape)}, qw {tuple(qw.shape)}")
    rows = _transrows(qw, w_bits, t)                     # (S, N, J)
    signs = bitslice.plane_signs(w_bits).tolist()
    xt = qx.reshape(qx.shape[:-1] + (k // t, t))
    lut = lut_build_ref(xt).to(torch.int64)              # (..., J, 2^t)
    out = torch.zeros(qx.shape[:-1] + (n,), dtype=torch.int64,
                      device=qx.device)
    j_idx = torch.arange(k // t, device=qx.device)
    for s in range(w_bits):
        # gather LUT[..., j, rows[s, n, j]] and reduce over j
        g = lut[..., j_idx[None, :], rows[s]]            # (..., N, J)
        out = out + signs[s] * g.sum(-1)
    return out.to(torch.int32)


def transitive_matmul_grouped_ref(xg: torch.Tensor, wg: torch.Tensor,
                                  w_bits: int = 8, t: int = 8
                                  ) -> torch.Tensor:
    """Grouped variant: xg (..., G, g) x wg (N, G, g) -> (..., G, N) int32."""
    return torch.stack([transitive_matmul_ref(xg[..., gi, :], wg[:, gi, :],
                                              w_bits, t)
                        for gi in range(wg.shape[1])], dim=-2)


def w4a8_matmul_ref(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                    sg: torch.Tensor, out_dtype=torch.float32
                    ) -> torch.Tensor:
    """Group-dequant GEMM: qx (M, K) i8, sx (M, 1) f32, qw (N, K) i8,
    sg (N, K//group) f32 -> (M, N) f32. The per-group integer dots are
    exact (float64 holds every partial sum of int8 products), then summed
    in f32 with the group scales and times the token scales."""
    m, k = qx.shape
    n, groups = sg.shape
    g = k // groups
    xg = qx.reshape(m, groups, g).to(torch.float64)
    wg = qw.reshape(n, groups, g).to(torch.float64)
    part = torch.einsum("mgi,ngi->mgn", xg, wg)           # exact integers
    y = torch.einsum("mgn,ng->mn", part.to(torch.float32),
                     sg.to(torch.float32))
    return (y * sx.to(torch.float32)).to(out_dtype)


def rg_lru_ref(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t * h_{t-1} + x_t, a sequential f32 loop
    (the reference's ``lax.scan``). x, a: (B, S, D); h0: (B, D). Returns
    h (B, S, D) in x's dtype."""
    h = h0.to(torch.float32)
    af = a.to(torch.float32)
    xf = x.to(torch.float32)
    out = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out.to(x.dtype)
