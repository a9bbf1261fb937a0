"""Serving config and the serve cells' shape stand-ins and placements (port
of the serve half of ``repro.launch.specs``).

Nothing is allocated here: params come from ``Model.init`` run under a
fake-tensor mode and caches from ``Model.init_cache`` on the ``meta``
device (the reference's ``jax.eval_shape``), and placements come from the
logical rules of ``distributed/sharding.py``, as a tuple of DTensor
placements per array where the reference has a ``PartitionSpec``. A mesh
is a DeviceMesh or an abstract ordered ``{axis: size}`` mapping, so the
specs of a production layout need no process group.
``train_cell_specs`` and ``effective_accum`` (the training cells) are
ROADMAP item A10.2.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import mesh_axes, param_specs
from repro_torch.quant import QuantConfig

__all__ = ["serve_config", "serve_cell_specs", "prefill_cell_specs",
           "named", "NamedPlacement", "cache_specs", "mesh_decode_report",
           "mesh_serve_report"]


def serve_config(cfg: ModelConfig, w_bits: int = 4,
                 backend: str = "int_dot") -> ModelConfig:
    """Serving variant: PTQ W{w_bits}A8 linears with per-channel epilogue
    scales (``group=0``), dynamic int8 attention and an int8 KV cache.
    ``backend`` names the integer-GEMM backend (a registry name of
    :mod:`repro_torch.core.backend`); all are bit-exact on the int32
    accumulator."""
    return cfg.replace(
        quant=QuantConfig(mode="ptq", w_bits=w_bits, a_bits=8, group=0,
                          backend=backend),
        quant_attention=not cfg.is_encdec,
        kv_cache_bits=8 if not cfg.is_encdec else 16)


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """An array's placements on a mesh: the reference's
    ``NamedSharding(mesh, spec)``."""
    mesh: Any
    placements: tuple


def named(mesh, spec_tree):
    """Every placements tuple of ``spec_tree`` bound to ``mesh`` (``()``,
    a spec made with no mesh, is replicated on every mesh dimension)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    if not spec_tree:
        from torch.distributed.tensor import Replicate
        spec_tree = (Replicate(),) * len(mesh_axes(mesh))
    return NamedPlacement(mesh, spec_tree)


def _n_ranks(mesh) -> int:
    n = 1
    for s in mesh_axes(mesh).values():
        n *= s
    return n


def _mesh_rows(mesh, batch: int, what: str) -> tuple[str, str]:
    """The mesh's ``axis=size`` spelling, and how many of ``batch`` rows
    each rank carries (or that they replicate: the extent did not
    divide)."""
    axes = ",".join(f"{a}={s}" for a, s in mesh_axes(mesh).items())
    dp = _axis_size(mesh, _batch_axes(mesh))
    if dp > 1 and batch % dp == 0:
        rows = f"{batch // dp} {what} rows/rank"
    elif dp > 1:
        rows = f"{what} {batch} REPLICATED ({dp} does not divide it)"
    else:
        rows = "no data axes > 1"
    return axes, rows


def mesh_decode_report(mesh, batch: int, n_tokens: int, dt: float) -> str:
    """One-line per-rank decode summary for the mesh serve cell.

    ``dt`` is wall time for ``batch`` sequences x ``n_tokens`` greedy
    tokens, prefill included: the end-to-end number, not steady-state
    decode. Under data parallelism wall time is shared by all ranks; the
    line says how many batch rows each rank carried (or that the batch
    replicated: the extent did not divide). The reference's line, with
    ranks where it says devices (the port has no compile to include and
    no steady-state bench yet: ROADMAP A4)."""
    axes, rows = _mesh_rows(mesh, batch, "batch")
    per_tok_ms = dt / max(n_tokens, 1) * 1e3
    return (f"[mesh] {axes} ({_n_ranks(mesh)} ranks) | {rows} | "
            f"{batch}x{n_tokens} tokens in {dt:.2f}s "
            f"({per_tok_ms:.1f} ms/token wall incl. prefill)")


def mesh_serve_report(mesh, n_slots: int, n_requests: int, n_tokens: int,
                      steps: int, dt: float) -> str:
    """:func:`mesh_decode_report`'s line for a ``ServeEngine`` run: the
    rows split over the ranks are the ``n_slots`` packed slots; the work
    is ``n_requests`` requests, ``n_tokens`` tokens in all, served in
    ``dt`` seconds of wall time (prefill included) over ``steps`` packed
    decode steps."""
    axes, rows = _mesh_rows(mesh, n_slots, "slot")
    tok_ms = dt / max(n_tokens, 1) * 1e3
    step_ms = dt / max(steps, 1) * 1e3
    return (f"[mesh] {axes} ({_n_ranks(mesh)} ranks) | {rows} | "
            f"{n_requests} requests, {n_tokens} tokens in {dt:.2f}s "
            f"({tok_ms:.1f} ms/token wall incl. prefill; {steps} packed "
            f"decode steps, {step_ms:.1f} ms/step)")


def _batch_axes(mesh) -> tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, axes) -> int:
    shape = mesh_axes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape.get(a, 1)
    return n


def _fit(parts, shape, mesh) -> tuple:
    """Placements from per-dim mesh-axis parts (None, an axis name or a
    tuple of them), dropping parts whose mesh extent does not divide the
    dim; a part naming an axis the mesh lacks places nothing."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_axes(mesh))
    out = [Replicate()] * len(order)
    for i, (dim, part) in enumerate(zip(shape, parts)):
        if part is None or dim % _axis_size(mesh, part):
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            if a in order:
                out[order.index(a)] = Shard(i)
    return tuple(out)


def _tree_with_names(tree, fn, keys=()):
    if isinstance(tree, dict):
        return {k: _tree_with_names(v, fn, keys + (str(k),))
                for k, v in tree.items()}
    return fn(keys, tree)


def cache_specs(cfg: ModelConfig, caches_shape, mesh):
    """Placements for serve caches: KV heads on "model" when divisible,
    else the cache sequence axis (sequence parallelism); recurrent state
    shards its feature axis; the batch axis goes on the batch axes."""
    model_n = mesh_axes(mesh).get("model", 1)
    dp = _batch_axes(mesh)

    def one(keys, leaf):
        name = keys[-1]
        shp = tuple(leaf.shape)
        if name in ("k", "v", "ks", "vs") and len(shp) >= 4:
            # (R?, B, S, KV, HD|1): values and their KV8 scales
            lead = (None,) * (len(shp) - 4)
            if shp[-2] % model_n == 0:
                parts = (*lead, dp, None, "model", None)
            elif shp[-3] % model_n == 0:
                parts = (*lead, dp, "model", None, None)
            else:
                parts = (*lead, dp, None, None, None)
        elif name == "C" and len(shp) >= 5:     # mLSTM (R?, B, H, dk, dv)
            lead = (None,) * (len(shp) - 4)
            parts = (*lead, dp, "model", None, None)
        elif name == "n" and len(shp) >= 4:     # mLSTM (R?, B, H, dk)
            lead = (None,) * (len(shp) - 3)
            parts = (*lead, dp, "model", None)
        else:                                   # recurrent vectors (R?, B, D)
            lead = (None,) * (len(shp) - 2)
            parts = (*lead, dp, "model")
        return _fit(parts, shp, mesh)

    return _tree_with_names(caches_shape, one)


def _meta(tree):
    """Meta-device stand-ins (shape and dtype only) for a tree of
    tensors."""
    import torch
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def param_shapes(model) -> dict:
    """``model.init``'s params as meta tensors: run under a fake-tensor
    mode, so no weight of any size is drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model.init(0)
    return _meta(fake)


def _serve_fsdp(pshape, mesh) -> bool:
    """Serving keeps weights TP-resident (no ZeRO-3 gather per step) unless
    the model is too large for model-parallel shards alone (~12 GB/chip)."""
    leaves = []

    def collect(keys, leaf):
        leaves.append(leaf)
    _tree_with_names(pshape, collect)
    total = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    model_n = mesh_axes(mesh).get("model", 1)
    return (total / model_n) > 12e9


def _model(cfg):
    from repro_torch.models.model import Model
    return Model(cfg, device="meta")


def serve_cell_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Specs for decode cells: (model, params, caches, token, param
    placements, cache placements, token placement), every array a meta
    tensor. As in the reference, the params' placements follow the
    ambient mesh (``sharding.set_mesh``; replicated without one), the
    caches' and the token's follow ``mesh``."""
    import torch
    model = _model(cfg)
    pshape = param_shapes(model)
    pspec = param_specs(pshape, fsdp=_serve_fsdp(pshape, mesh))
    b = shape.global_batch
    cshape = model.init_cache(b, shape.seq_len)
    cspec = cache_specs(cfg, cshape, mesh)
    dp = _batch_axes(mesh)
    tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
    tspec = _fit((dp, None), tuple(tok.shape), mesh)
    return (model, pshape, cshape, tok, named(mesh, pspec),
            named(mesh, cspec), NamedPlacement(mesh, tspec))


def prefill_cell_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Specs for prefill cells: (model, params, batch, prompt length,
    param placements, batch placements), every array a meta tensor."""
    import torch
    model = _model(cfg)
    pshape = param_shapes(model)
    pspec = param_specs(pshape, fsdp=_serve_fsdp(pshape, mesh))
    b = shape.global_batch
    s = shape.seq_len
    if cfg.max_target_positions:
        s = min(s, cfg.max_target_positions)
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device="meta")}
    dp = _batch_axes(mesh)
    bspec = {"tokens": _fit((dp, None), (b, s), mesh)}
    if cfg.n_context_tokens or cfg.is_encdec:
        batch["context"] = torch.empty(
            (b, cfg.n_context_tokens, cfg.d_model), dtype=torch.float32,
            device="meta")
        bspec["context"] = _fit((dp, None, None),
                                tuple(batch["context"].shape), mesh)
    return (model, pshape, batch, s, named(mesh, pspec),
            named(mesh, bspec))
