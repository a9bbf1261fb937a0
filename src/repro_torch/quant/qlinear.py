"""TransitiveLinear — the paper's technique as a linear layer (port of
``repro.quant.qlinear``).

Three operating modes, the reference's: ``none`` (dense matmul in the
working dtype), ``qat`` (the same product of the weight's group-wise fake
quantization, :func:`~repro_torch.quant.quantize.fake_quant`, whose
gradient passes straight through) and ``ptq`` (weights stored as int8
codes + f32 scales, activations quantized per token at run time, the
integer GEMM through a registered backend of
:mod:`repro_torch.core.backend`).

Layers are functional: ``linear_init`` builds a params dict,
``linear_apply`` consumes it. Weight layout is (d_out, d_in), reduction
axis last (TransRows slice along it).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

import repro_torch.quant.quantize as Q
from repro_torch.core.backend import EngineConfig, get_backend

__all__ = ["QuantConfig", "linear_init", "linear_apply"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "none"        # none | qat | ptq
    w_bits: int = 8
    a_bits: int = 8
    group: int = 128          # group size along d_in (0: per-channel)
    backend: str = "int_dot"  # integer-GEMM backend, a registry name
    transrow_t: int = 8       # TransRow width for transitive backends

    def with_(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


def _effective_group(cfg: QuantConfig, d_in: int) -> int:
    g = cfg.group
    if g <= 0 or d_in % g:
        return d_in               # fall back to per-channel
    return g


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                cfg: QuantConfig = QuantConfig(),
                dtype=torch.bfloat16) -> dict[str, Any]:
    """Random layer params drawn from ``gen``, on the generator's device."""
    scale = 1.0 / (d_in ** 0.5)
    w = torch.randn((d_out, d_in), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    if cfg.mode != "ptq":
        return {"w": w.to(dtype)}
    g = _effective_group(cfg, d_in)
    qw, sg = Q.quantize_groupwise(w, cfg.w_bits, g)
    return {"qw": qw, "sg": sg.to(torch.float32)}


def _resolve_device_plan(params, backend, qw: torch.Tensor,
                         ecfg: EngineConfig):
    """The compiled plan a device-resident planned backend executes (a
    DevicePlan, or ``engine_cuda``'s ForestPlan / SparseForestPlan; all
    carry the signature fields checked here): the one embedded in the
    params, else a process-cache lookup (hashes the weight bytes: serve
    with attached plans)."""
    if not (backend.needs_plan and backend.device_resident):
        return None
    dplan = params.get("dplan")
    if dplan is not None:
        sig = (dplan.bits, dplan.t, dplan.n, dplan.k, dplan.groups)
        want = (ecfg.w_bits, ecfg.t, qw.shape[-2], qw.shape[-1],
                ecfg.groups)
        if sig != want:
            raise ValueError(
                f"attached plan signature (bits, t, n, k, groups)="
                f"{sig} does not match the layer's {want} — re-attach "
                f"with the serving QuantConfig")
        return dplan
    from repro_torch.core import plancache
    return plancache.default_cache().get_or_build_device(
        qw, ecfg, backend=backend.name, device=qw.device)


def _ptq_apply(params, x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    backend = get_backend(cfg.backend)
    qw, sg = params["qw"], params["sg"]
    d_out, d_in = qw.shape
    if d_in % sg.shape[-1]:
        raise ValueError(
            f"grouped PTQ layer mis-shaped: weight ({d_out}, {d_in}) "
            f"carries {sg.shape[-1]} scale groups, but d_in={d_in} is not "
            f"divisible by the group count")
    g = d_in // sg.shape[-1]
    qx, sx = Q.quantize_per_token(x, cfg.a_bits)
    if sg.shape[-1] == 1:
        # per-channel: one integer GEMM + epilogue scale
        ecfg = EngineConfig.from_quant(cfg, groups=1)
        dplan = _resolve_device_plan(params, backend, qw, ecfg)
        y32 = backend.execute(qx, qw, None, dplan, ecfg)
        y = y32.to(torch.float32) * sx * sg[:, 0]
    else:
        # group-wise: per-group int partials rescaled in the epilogue
        n_groups = d_in // g
        if not backend.supports_groups:
            raise ValueError(
                f"backend '{backend.name}' does not support group-wise "
                f"quantization; use group=0 (per-channel)")
        ecfg = EngineConfig.from_quant(cfg, groups=n_groups)
        dplan = _resolve_device_plan(params, backend, qw, ecfg)
        xg = qx.reshape(qx.shape[:-1] + (n_groups, g))
        wg = qw.reshape(d_out, n_groups, g)
        part = backend.execute(xg, wg, None, dplan, ecfg)    # (..., G, N)
        # one layout for every backend (the int32 partials are copied
        # once, into contiguous f32): the einsum's f32 sum over the
        # groups then runs in one order, so equal int32 partials give
        # equal outputs bit for bit, whichever backend made them
        part = part.to(torch.float32,
                       memory_format=torch.contiguous_format)
        y = torch.einsum("...gn,ng->...n", part, sg) * sx
    return y.to(x.dtype)


def linear_apply(params: dict[str, Any], x: torch.Tensor,
                 cfg: QuantConfig = QuantConfig()) -> torch.Tensor:
    """y = x @ W^T under the configured quantization mode."""
    if cfg.mode == "ptq":
        return _ptq_apply(params, x, cfg)
    w = params["w"]
    if cfg.mode == "qat":
        w = Q.fake_quant(w, cfg.w_bits, _effective_group(cfg, w.shape[-1]))
    elif cfg.mode != "none":
        raise NotImplementedError(
            f"unknown quant mode {cfg.mode!r} (none | qat | ptq)")
    return torch.matmul(x, w.to(x.dtype).T)
