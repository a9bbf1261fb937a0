"""Symmetric integer quantization (port of ``repro.quant.quantize``).

Per-token dynamic activation quantization and group-wise weight
quantization with f32 scales. Each call keeps its input's working dtype
(f32 stays f32, bf16 stays bf16), divides with true division on every
device (:func:`true_div`) and rounds half to even (``torch.round`` and
``jnp.round`` agree), so codes and scales from f32 inputs equal the
reference's exactly. :func:`fake_quant`, QAT's weight quantizer, is a
``torch.autograd.Function`` whose backward passes the gradient straight
through (the reference's ``custom_vjp``).
"""
from __future__ import annotations

import torch

__all__ = ["absmax_scale", "quantize", "dequantize", "quantize_groupwise",
           "dequantize_groupwise", "quantize_per_token", "fake_quant",
           "true_div"]

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


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


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


def dequantize_groupwise(q: torch.Tensor, scales: torch.Tensor, group: int,
                         dtype=torch.float32) -> torch.Tensor:
    k = q.shape[-1]
    qg = q.reshape(q.shape[:-1] + (k // group, group))
    w = qg.to(torch.float32) * scales[..., None]
    return w.reshape(q.shape).to(dtype)


def quantize_per_token(x: torch.Tensor, bits: int = 8):
    """Dynamic per-token activation quantization over the last axis.

    Returns (int8 codes, scale (..., 1) in x's dtype)."""
    scale = absmax_scale(x, bits, axis=-1)
    return quantize(x, bits, scale), scale


class _FakeQuant(torch.autograd.Function):
    """Forward: ``dequantize_groupwise(quantize_groupwise(x))`` in x's
    dtype; backward: the straight-through estimator, ``g`` for x and
    nothing for ``bits`` and ``group``."""

    @staticmethod
    def forward(ctx, x, bits: int, group: int):
        q, s = quantize_groupwise(x, bits, group)
        return dequantize_groupwise(q, s, group, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """QAT's group-wise fake quantization of ``x (..., K)`` (straight-through
    gradient)."""
    return _FakeQuant.apply(x, bits, group)
