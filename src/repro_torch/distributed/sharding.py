"""Logical-axis sharding rules -> DTensor placements (port of
``repro.distributed.sharding``).

Logical axes:
  batch   -> ("pod", "data")   data parallelism (pod = DCN-level DP)
  heads   -> "model"           tensor parallelism over attention heads
  kv_heads-> "model"           (replicated when GQA kv count not divisible)
  ffn     -> "model"           tensor parallelism over FFN inner dim
  vocab   -> "model"           sharded embedding / logits
  experts -> "model"           expert parallelism
  kv_seq  -> "model"           sequence parallelism for decode KV caches
  seq     -> "model" iff cfg.seq_shard (Megatron-SP activations)
  fsdp    -> "data"            ZeRO-3-ish parameter sharding on the DP axis

Where the reference returns a ``PartitionSpec``, :func:`spec` returns the
DTensor placements: one ``Shard(i)`` or ``Replicate()`` per mesh
dimension, in the mesh's dimension order (``P(("pod", "data"), None)`` on
a ``pod=2,data=2`` mesh is ``(Shard(0), Shard(0))``: dim 0 split over
``pod``, then each part over ``data``, as the reference's product axis).
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or an abstract
ordered ``{axis: size}`` mapping (``launch.mesh.parse_mesh_spec``'s
output; any object with ``axis_names`` and ``shape`` works too), so the
specs of a 2 x 16 x 16 layout are computed with no process group, as the
reference computes them from an abstract mesh.

The port runs eager SPMD: every rank runs the same ops on its own rows, so
inside the model :func:`shard` places nothing (the batch axes are already
split when the rows reach it); it only checks the rule and warns on a
drop. Placements matter where arrays are handed over: the batch
(:func:`distribute`), the caches, the plan leaves
(``core.backend.shard_device_plan``) and the tokens (:func:`gather_rows`).
Dropping an axis for non-divisibility is legal but not silent: the first
time a given (logical axis, mesh axes, dim, extent) replicates instead of
sharding, :func:`spec` emits a ``ShardingDropWarning``.

The ambient mesh (:func:`set_mesh`, :func:`get_abstract_mesh`) is the
port's own copy of the two ``jax_compat`` helpers it needs. Only the
batch axes serve here: a mesh whose ``model`` extent is above 1 is
refused where arrays would be placed on it (:func:`require_batch_mesh`;
ROADMAP A10.2), while specs and plan placements may name it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from collections.abc import Mapping
from typing import Any

import torch

__all__ = ["RULES", "ShardingDropWarning", "spec", "shard",
           "mesh_axis_size", "param_specs", "set_mesh", "get_abstract_mesh",
           "mesh_axes", "require_batch_mesh", "distribute", "wrap_local",
           "local_tree", "local_chunks", "batch_index", "mesh_device",
           "gather_rows", "host_all_gather"]


class ShardingDropWarning(UserWarning):
    """A sharding rule's mesh axes were dropped (replicated) because the
    mesh extent does not divide the dimension."""


# (logical axis, mesh axes, dim, extent) combinations already warned about:
# spec() runs on every layer of every step, the warning must fire once
_WARNED_DROPS: set[tuple] = set()


def _warn_drop(name: str, mesh_axes: tuple[str, ...], dim: int,
               size: int) -> None:
    key = (name, mesh_axes, dim, size)
    if key in _WARNED_DROPS:
        return
    _WARNED_DROPS.add(key)
    axes = "+".join(mesh_axes)
    product = " (product of present axes)" if len(mesh_axes) > 1 else ""
    warnings.warn(
        f"sharding rule '{name}' -> mesh axes {mesh_axes} dropped: "
        f"dim {dim} is not divisible by the mesh extent {size} of "
        f"{axes}{product}; the dimension is REPLICATED on every device. "
        f"Pad the dimension or resize the mesh to actually shard it.",
        ShardingDropWarning, stacklevel=3)


RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "kv_seq": ("model",),
    "seq_sp": ("model",),
    "fsdp": ("data",),
    "none": (),
}


# -- meshes ---------------------------------------------------------------

_AMBIENT = threading.local()


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` ambient for :func:`spec` / :func:`shard` inside the
    block (None: no mesh)."""
    stack = _AMBIENT.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def get_abstract_mesh():
    """The ambient mesh, or None when no mesh context is active."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def mesh_axes(mesh) -> dict[str, int]:
    """The ordered ``{axis: size}`` of a DeviceMesh, an abstract mapping,
    or any object with ``axis_names`` and ``shape``; ``{}`` for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(a): int(s) for a, s in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.axis_names, (int(s) for s in shape)))


def require_batch_mesh(mesh, what: str) -> dict[str, int]:
    """The mesh's axes, after refusing a ``model`` extent above 1: this
    slice serves the batch axes only (tensor-parallel weights, sequence-
    and expert-parallel serving are ROADMAP item A10.2)."""
    axes = mesh_axes(mesh)
    if axes.get("model", 1) > 1:
        raise NotImplementedError(
            f"{what}: mesh {axes} has a 'model' axis of "
            f"{axes['model']}; the port serves the batch axes (pod, data) "
            f"only — the model axis (tensor-parallel weights, sequence- "
            f"and expert-parallel caches) is ROADMAP item A10.2")
    return axes


def mesh_axis_size(name: str) -> int:
    """The ambient mesh's extent along ``name`` (1 without one)."""
    return mesh_axes(get_abstract_mesh()).get(name, 1)


def spec(*logical_axes: str | None, shape: tuple[int, ...] | None = None,
         mesh=None) -> tuple:
    """DTensor placements from logical axis names (None -> replicated dim).

    When ``shape`` is given, axes whose mesh extent does not divide the dim
    are dropped (replicated), e.g. 8 GQA kv heads on a 16-way model axis.
    For multi-axis rules (``batch`` -> ``("pod", "data")``) the *product*
    of the present axes must divide. A drop emits a
    ``ShardingDropWarning`` once per (rule, axes, dim, extent). ``mesh``
    defaults to the ambient mesh; with none the result is ``()``.
    """
    from torch.distributed.tensor import Replicate, Shard

    axes = mesh_axes(get_abstract_mesh() if mesh is None else mesh)
    order = list(axes)
    out: list = [Replicate()] * len(order)
    for i, name in enumerate(logical_axes):
        if name is None or name == "none":
            continue
        present = tuple(a for a in RULES[name] if a in axes)
        if not present:
            continue
        size = 1
        for a in present:
            size *= axes[a]
        if shape is not None and shape[i] % size:
            if size > 1:
                _warn_drop(name, present, shape[i], size)
            continue
        for a in present:
            j = order.index(a)
            if not out[j].is_replicate():
                raise ValueError(f"mesh axis {a!r} is used by two dims "
                                 f"of {logical_axes}")
            out[j] = Shard(i)
    return tuple(out)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """The reference's sharding constraint. Under eager SPMD a rank already
    holds its rows, so this places nothing; under an ambient mesh it
    checks the rule against ``x``'s shape (warning on a drop)."""
    if get_abstract_mesh() is None:
        return x
    assert len(logical_axes) == x.ndim, (logical_axes, x.shape)
    spec(*logical_axes, shape=tuple(x.shape))
    return x


# -- parameter sharding rules (Megatron TP + ZeRO-3 FSDP on the data axis) --

# row-parallel linears: contraction (input) dim carries the TP shard
_ROW_PARALLEL = {"wo", "down", "w_out"}
# leaves sharded over experts on "model" (+ FSDP on a wide inner dim)
_EXPERT = {"w_gate", "w_up", "w_down"}


def _leaf_logical(path_keys: list[str], shape) -> tuple[str | None, ...]:
    name = None
    for k in reversed(path_keys):
        if k not in ("w", "qw", "sg"):
            name = k
            break
    ndim = len(shape)
    lead = (None,) * (ndim - 2)                    # stacked axes

    if name in ("embed", "unembed"):
        return ("vocab", "fsdp")
    if name in _EXPERT and ndim >= 3:
        # (R?, E, d_in, d_out): experts on model, last dim ZeRO-3
        logical = [None] * ndim
        logical[ndim - 3] = "experts"
        logical[ndim - 1] = "fsdp"
        return tuple(logical)
    if ndim < 2:
        return (None,) * ndim                      # norms, scalars, lam
    if name == "router":
        return lead + (None, None)
    if name in _ROW_PARALLEL:
        return lead + ("fsdp", "heads")            # (out, in): in = model
    # column-parallel default: (out, in) with out on model, in on data
    return lead + ("heads", "fsdp")


def param_specs(params, fsdp: bool = True, mesh=None):
    """The tree of placements for a params/opt-state tree (dicts, lists
    and tensors; meta tensors work), under ``mesh`` (default: the ambient
    mesh).

    Layout convention: qlinear weights are (d_out, d_in) (possibly with
    leading stacked axes). Column-parallel weights shard d_out on
    "model"; row-parallel ({wo, down, w_out}) shard d_in on "model"; the
    other big dim takes ZeRO-3 ("data") where divisible. MoE expert
    stacks shard experts on "model" and their widest dim on "data";
    scales/norms replicate. ``fsdp=False`` drops the ZeRO-3 ("data")
    axis: the serving layout."""
    def one(keys, leaf):
        logical = _leaf_logical(keys, tuple(leaf.shape))
        if not fsdp:
            logical = tuple(None if ax == "fsdp" else ax for ax in logical)
        return spec(*logical, shape=tuple(leaf.shape), mesh=mesh)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [str(k)]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, keys + [str(i)])
                              for i, v in enumerate(tree))
        return one(keys, tree)

    return walk(params, [])


# -- placing arrays on a DeviceMesh -----------------------------------------

def _is_dtensor(x) -> bool:
    return callable(getattr(x, "to_local", None)) and hasattr(
        x, "placements")


def batch_index(mesh) -> int:
    """This rank's position along the mesh's flattened dimensions (the
    chunk of a dim sharded over every mesh dimension that it holds)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {torch.distributed.get_rank()} is not in "
                           f"the mesh {mesh_axes(mesh)}")
    idx = 0
    for c, s in zip(coord, mesh.shape):
        idx = idx * int(s) + int(c)
    return idx


def _local_chunk(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of the full ``x`` under ``placements`` (nested
    left to right over the mesh dimensions, as DTensor lays them out);
    every placement must divide its dim evenly."""
    coord = mesh.get_coordinate()
    for c, s, p in zip(coord, mesh.shape, placements):
        if p.is_shard():
            d, n = p.dim, int(s)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split {n} ways")
            step = x.shape[d] // n
            x = x.narrow(d, int(c) * step, step)
    return x


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` keeps its arrays on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(x: torch.Tensor, mesh, placements) -> Any:
    """A DTensor of the full ``x`` (the same on every rank) whose local
    tensor is this rank's chunk: a slice, no communication."""
    from torch.distributed.tensor import DTensor
    x = torch.as_tensor(x).to(mesh_device(mesh))
    local = _local_chunk(x, mesh, placements).contiguous()
    return DTensor.from_local(local, mesh, list(placements),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def wrap_local(local: torch.Tensor, mesh, placements) -> Any:
    """A DTensor over this rank's ``local`` chunk (every rank holds a
    same-shaped chunk): the global shape is the local one times the mesh
    extents along each sharded dim."""
    from torch.distributed.tensor import DTensor
    shape = list(local.shape)
    for s, p in zip(mesh.shape, placements):
        if p.is_shard():
            shape[p.dim] *= int(s)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, list(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _map_leaves(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every DTensor leaf (an attached
    plan's leaves included); a subtree holding none comes back as the
    same object."""
    if isinstance(tree, (dict, list, tuple)):
        keys = list(tree) if isinstance(tree, dict) else range(len(tree))
        out = [_map_leaves(tree[k], fn) for k in keys]
        if all(o is tree[k] for o, k in zip(out, keys)):
            return tree
        if isinstance(tree, dict):
            return dict(zip(keys, out))
        return type(tree)(out)
    if _is_dtensor(tree):
        return fn(tree)
    leaves = getattr(tree, "leaves", None)
    if callable(leaves) and dataclasses.is_dataclass(tree):
        lv = leaves()
        if any(_is_dtensor(a) for a in lv.values()):
            return dataclasses.replace(
                tree, **{f: _map_leaves(a, fn) for f, a in lv.items()})
    return tree


def _whole(x):
    if all(p.is_replicate() for p in x.placements):
        return x.to_local()
    return x.full_tensor()


def local_tree(tree: Any) -> Any:
    """``tree`` with every DTensor leaf replaced by the whole array as
    this rank holds it: the local tensor where every placement is
    ``Replicate()``, else the gathered full tensor (a collective every
    rank of the mesh must join). Attached plans are rebuilt with local
    leaves; a tree without DTensors comes back as the same object."""
    return _map_leaves(tree, _whole)


def local_chunks(tree: Any) -> Any:
    """``tree`` with every DTensor leaf replaced by this rank's local
    tensor (its rows, where the tensor is sharded)."""
    return _map_leaves(tree, lambda x: x.to_local())


# -- host collectives -------------------------------------------------------

def host_all_gather(buf: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's same-shaped ``buf``, in flattened mesh order, through
    host memory: ranks that share one card run ``gloo``, whose
    collectives on CUDA tensors are partial, so the bytes go through the
    CPU. One all-gather per mesh dimension, the last first, over that
    dimension's group."""
    import torch.distributed as dist
    rows = buf.detach().to("cpu").contiguous().reshape(1, -1)
    for dim in reversed(range(mesh.ndim)):
        parts = [torch.empty_like(rows) for _ in range(mesh.size(dim))]
        dist.all_gather(parts, rows, group=mesh.get_group(dim))
        rows = torch.cat(parts)
    return [r.reshape(buf.shape) for r in rows]


def gather_rows(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole array from each rank's ``local`` rows: ``local`` itself
    where ``placements`` replicate, else the ranks' chunks concatenated
    along the sharded dim (all sharded placements name one dim), on
    ``local``'s device."""
    dims = {p.dim for p in placements if p.is_shard()}
    if not dims:
        return local
    if len(dims) > 1:
        raise ValueError(f"gather_rows takes one sharded dim, got "
                         f"{placements}")
    parts = host_all_gather(local, mesh)
    return torch.cat(parts, dim=dims.pop()).to(local.device)
