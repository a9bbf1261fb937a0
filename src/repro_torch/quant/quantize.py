"""Symmetric integer quantization (port of ``repro.quant.quantize``).

Per-token dynamic activation quantization and group-wise weight
quantization with f32 scales. Each call keeps its input's working dtype
(f32 stays f32, bf16 stays bf16), divides with true division on every
device (:func:`true_div`) and rounds half to even (``torch.round`` and
``jnp.round`` agree), so codes and scales from f32 inputs equal the
reference's exactly.
Training's ``fake_quant`` is not part of this slice.
"""
from __future__ import annotations

import torch

__all__ = ["absmax_scale", "quantize", "quantize_groupwise",
           "quantize_per_token", "true_div"]

_DIVISORS: dict = {}


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device. torch's CUDA kernels
    multiply by the reciprocal of a Python-scalar divisor, which can move
    a quotient by an ulp (and a quantizer scale with it); a divisor that
    is a tensor on x's device is divided by, as on the CPU."""
    if x.device.type == "cpu":
        return x / d
    key = (d, x.dtype, x.device)
    if key not in _DIVISORS:
        _DIVISORS[key] = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / _DIVISORS[key]


def absmax_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Symmetric absmax scale; keeps reduced dims (``axis`` given)."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return true_div(torch.clamp(amax, min=1e-8), float(_qmax(bits)))


def quantize(x: torch.Tensor, bits: int, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x / scale)
    return torch.clamp(q, -_qmax(bits) - 1, _qmax(bits)).to(torch.int8)


def quantize_groupwise(w: torch.Tensor, bits: int, group: int = 128):
    """Quantize ``w (..., K)`` with one scale per ``group`` along K.

    Returns (q int8 (..., K), scales (..., K//group) in w's dtype).
    """
    k = w.shape[-1]
    if k % group:
        raise ValueError(f"K={k} not divisible by group={group}")
    wg = w.reshape(w.shape[:-1] + (k // group, group))
    scale = absmax_scale(wg, bits, axis=-1)            # (..., K//g, 1)
    q = quantize(wg, bits, scale)
    return q.reshape(w.shape), scale[..., 0]


def quantize_per_token(x: torch.Tensor, bits: int = 8):
    """Dynamic per-token activation quantization over the last axis.

    Returns (int8 codes, scale (..., 1) in x's dtype)."""
    scale = absmax_scale(x, bits, axis=-1)
    return quantize(x, bits, scale), scale
