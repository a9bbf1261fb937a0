"""Op-trace walker: every aten op and hand-written kernel launch of one
call (port of ``repro.analysis.walker``).

The reference walks a jaxpr, recursing into ``scan``/``while``/``cond``
sub-jaxprs. The port runs eagerly, so its counterpart of a jaxpr is an
**op trace**: :func:`record` runs one call under a
``TorchDispatchMode`` and keeps an :class:`OpSite` for every aten op the
dispatcher sees, plus one ``kernel:<B#>.<instance>`` site for every
ctypes launch of a CUDA kernel, which the dispatcher cannot see
(:func:`note_launch`, called at each launch site of ``kernels/``). The
hooks :func:`scope` and :func:`note_launch` live in
:mod:`repro_torch.tracepoints`, below the code that calls them, and are
re-exported here. An
op that runs in a loop is recorded each time it runs. Each site carries

* ``path``: its index in the call with the scope components in front,
  e.g. ``"level/17:aten.index_select"``, printable in a finding;
* ``in_loop``: whether a loop scope (``scope(..., loop=True)``, the
  counterpart of a ``scan`` body) encloses it;
* ``scopes``: the names of every enclosing :func:`scope` (the
  counterpart of ``jax.named_scope``);
* the shapes, dtypes, devices and storages of its input and output
  tensors (:class:`TensorInfo`; a storage is
  ``untyped_storage().data_ptr()``, so a view shares its base's).

The op-name sets several rules share live here, spelled as the
dispatcher spells them (``str(func.overloadpacket)``, or the full
overload where only one overload qualifies). Ops that are composite in
torch never reach the dispatcher and so need no entry:
``take_along_dim`` arrives as ``aten.gather``, ``repeat_interleave`` with
an int count as ``expand`` + ``clone``, ``Tensor.item()`` / ``int()`` /
``bool()`` as ``aten._local_scalar_dense``, ``torch.tensor`` /
``torch.as_tensor`` of host data as ``aten.lift_fresh``.
:func:`spelling_report` runs one probe per spelling on a device and
says which set caught it; ``tests/test_torch_tracelint.py`` holds it on
torch 2.13 (CPU), ``chip_smoke.py`` phase 21 on torch 2.11+cu128
(``cuda`` and CPU). No spelling differs between the two versions: every
probe dispatched the same ops on both, and ``torch.tensor(x,
device="cuda")`` is one ``aten.lift_fresh`` (its copy to the card is
inside the constructor, below the dispatcher).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.tracepoints import (current_scopes, note_launch,
                                     recording, scope)

__all__ = ["OpSite", "OpTrace", "TensorInfo", "record", "scope",
           "note_launch", "host_sync", "is_dynamic_shape", "named_tensors",
           "spelling_report", "SYNC_OPS", "COPY_OPS", "SCATTER_OPS",
           "DYNAMIC_SHAPE_OPS", "GATHER_OPS", "KERNEL_PREFIX"]

# host round trips: a read back to the host, or host data entering the
# program (the eager counterpart of CALLBACK_PRIMS)
SYNC_OPS = frozenset({"aten._local_scalar_dense", "aten.equal",
                      "aten.is_nonzero", "aten.lift_fresh",
                      "aten.lift_fresh_copy"})
# copies: a host round trip where they cross between the host and a device
COPY_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten._copy_from",
                      "aten._copy_from_and_resize"})
# the scatter family (the counterpart of SCATTER_PRIMS)
SCATTER_OPS = frozenset({
    "aten.index_put", "aten.index_put_", "aten._index_put_impl_",
    "aten.scatter", "aten.scatter_", "aten.scatter_add",
    "aten.scatter_add_", "aten.scatter_reduce", "aten.scatter_reduce_",
    "aten.index_add", "aten.index_add_", "aten.index_copy",
    "aten.index_copy_", "aten.masked_scatter", "aten.masked_scatter_"})
# output shapes that depend on input values (with boolean-mask
# ``aten.index.Tensor``, see :func:`is_dynamic_shape`)
DYNAMIC_SHAPE_OPS = frozenset({
    "aten.nonzero", "aten.masked_select", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive",
    "aten.unique_dim_consecutive", "aten.repeat_interleave.Tensor",
    "aten.repeat_interleave.self_Tensor"})
# reads through an index tensor
GATHER_OPS = frozenset({"aten.index.Tensor", "aten.index_select",
                        "aten.gather", "aten.embedding"})
KERNEL_PREFIX = "kernel:"


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """What a site keeps of one tensor: no values, no reference."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    storage: int                  # untyped_storage().data_ptr(); 0: none
    storage_nbytes: int

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize

    def signature(self) -> tuple:
        return (self.shape, self.dtype)


def _info(t: torch.Tensor) -> TensorInfo:
    try:
        s = t.untyped_storage()
        ptr, nbytes = s.data_ptr(), s.nbytes()
    except (RuntimeError, NotImplementedError):
        ptr, nbytes = 0, 0
    return TensorInfo(tuple(t.shape), t.dtype, t.device, ptr, nbytes)


def _infos(tree: Any) -> tuple[TensorInfo, ...]:
    return tuple(_info(t) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One recorded op or kernel launch with its context."""
    op: str                       # "aten.index_put_.default", "kernel:B2.x"
    path: str                     # "level/17:aten.index_put_"
    in_loop: bool
    scopes: frozenset[str]
    inputs: tuple[TensorInfo, ...]
    outputs: tuple[TensorInfo, ...]

    @property
    def packet(self) -> str:
        """The op without its overload (``aten.index_put_``), or the
        kernel without its instance (``kernel:B2``)."""
        if self.op.startswith(KERNEL_PREFIX):
            return self.op.split(".", 1)[0]
        return self.op.rsplit(".", 1)[0]

    @property
    def is_kernel(self) -> bool:
        return self.op.startswith(KERNEL_PREFIX)

    def is_in(self, ops: frozenset[str]) -> bool:
        return self.packet in ops or self.op in ops

    def signature(self) -> tuple:
        """What must not depend on input values: the op and its tensors'
        shapes and dtypes."""
        return (self.op, tuple(i.signature() for i in self.inputs),
                tuple(o.signature() for o in self.outputs))


@dataclasses.dataclass(frozen=True)
class OpTrace:
    """The sites of one call, the storages of its arguments (live from
    the start) and its result (the tensors themselves: the rules read
    where they live)."""
    sites: tuple[OpSite, ...]
    args: tuple[TensorInfo, ...]
    result: Any

    def __iter__(self) -> Iterator[OpSite]:
        return iter(self.sites)

    def __len__(self) -> int:
        return len(self.sites)


# -- the recorder ------------------------------------------------------------

class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.sites: list[OpSite] = []

    def add(self, op: str, packet: str, inputs, outputs) -> None:
        stack = current_scopes()
        names = [n for n, _ in stack]
        prefix = "".join(n + "/" for n in names)
        self.sites.append(OpSite(
            op=op, path=f"{prefix}{len(self.sites)}:{packet}",
            in_loop=any(loop for _, loop in stack),
            scopes=frozenset(names), inputs=inputs, outputs=outputs))

    def launch(self, name: str, inputs, outputs) -> None:
        """A ``kernel:<name>`` site for a launch :func:`note_launch` saw."""
        op = KERNEL_PREFIX + name
        self.add(op, op.split(".", 1)[0], _infos(inputs), _infos(outputs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.add(str(func), str(func.overloadpacket),
                 _infos((args, kwargs)), _infos(out))
        return out


def record(fn, *args, **kw) -> OpTrace:
    """Run ``fn(*args, **kw)`` once under the recorder and return its
    :class:`OpTrace` (iterable over the :class:`OpSite`\\ s)."""
    rec = _Recorder()
    with recording(rec), rec:
        result = fn(*args, **kw)
    return OpTrace(sites=tuple(rec.sites), args=tuple(
        _info(t) for t in named_tensors((args, kw)).values()), result=result)


# -- classification ---------------------------------------------------------

def host_sync(site: OpSite) -> str | None:
    """Why ``site`` is a host round trip, or None."""
    if site.is_in(SYNC_OPS):
        return ("host data entering the program"
                if site.packet.startswith("aten.lift_fresh")
                else "a read back to the host")
    if site.is_in(COPY_OPS):
        src = {i.device.type for i in site.inputs}
        dst = {o.device.type for o in site.outputs}
        if "cpu" in dst and src - {"cpu"}:
            return "a copy from the device to the host"
        if "cpu" in src and dst - {"cpu"}:
            return "a copy from the host onto the device"
    return None


def is_dynamic_shape(site: OpSite) -> bool:
    """Whether the output shape of ``site`` depends on input values."""
    if site.is_in(DYNAMIC_SHAPE_OPS):
        return True
    return site.op == "aten.index.Tensor" and any(
        i.dtype in (torch.bool, torch.uint8) for i in site.inputs[1:])


def named_tensors(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{path: tensor}`` over dicts, lists, tuples and attached plans
    (objects with ``leaves()``), paths like ``"[1].body.c0.k"``."""
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(named_tensors(v, f"{prefix}.{k}" if prefix else
                                     str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(named_tensors(v, f"{prefix}[{i}]"))
    elif callable(getattr(tree, "leaves", None)):
        out.update(named_tensors(tree.leaves(), prefix))
    return out


# -- spelling probes ----------------------------------------------------------

def _probes(device) -> dict[str, tuple[Any, Any]]:
    """probe -> (call, the classifier that must catch one of its sites)."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    idx = torch.arange(2, device=device)
    sync = lambda s: host_sync(s) is not None            # noqa: E731
    dyn = is_dynamic_shape
    scat = lambda s: s.is_in(SCATTER_OPS)                # noqa: E731
    gath = lambda s: s.is_in(GATHER_OPS)                 # noqa: E731
    probes = {
        "item": (lambda: x.sum().item(), sync),
        "int": (lambda: int(x[1]), sync),
        "bool": (lambda: bool(x[1] > 0), sync),
        "torch.tensor": (lambda: torch.tensor(1.5, device=device), sync),
        "as_tensor(list)": (lambda: torch.as_tensor([1, 2], device=device),
                            sync),
        "nonzero": (lambda: torch.nonzero(x), dyn),
        "masked_select": (lambda: torch.masked_select(x, x > 3), dyn),
        "bool-mask index": (lambda: x[x > 3], dyn),
        "unique": (lambda: torch.unique(x), dyn),
        "repeat_interleave(tensor)": (
            lambda: torch.repeat_interleave(x[:2], idx + 1), dyn),
        "index_put_": (lambda: x.clone().index_put_((idx,), x[:2]), scat),
        "setitem": (lambda: x.clone().__setitem__(idx, 0.0), scat),
        "scatter": (lambda: x.scatter(0, idx, x[:2]), scat),
        "scatter_add": (lambda: x.scatter_add(0, idx, x[:2]), scat),
        "index_add_": (lambda: x.clone().index_add_(0, idx, x[:2]), scat),
        "index_copy_": (lambda: x.clone().index_copy_(0, idx, x[:2]), scat),
        "masked_scatter_": (lambda: x.clone().masked_scatter_(x > 3, x),
                            scat),
        "index": (lambda: x[idx], gath),
        "index_select": (lambda: x.index_select(0, idx), gath),
        "gather": (lambda: x.gather(0, idx), gath),
        "take_along_dim": (lambda: torch.take_along_dim(x, idx), gath),
        "embedding": (lambda: torch.nn.functional.embedding(
            idx, x.reshape(4, 2)), gath),
    }
    if torch.device(device).type != "cpu":
        probes["cpu()"] = (lambda: x.cpu(), sync)
        probes["to(device)"] = (lambda: torch.zeros(2).to(device), sync)
    return probes


def spelling_report(device="cpu") -> dict[str, dict]:
    """Run each probe on ``device`` and report the ops it dispatched and
    whether the set meant to catch it did (``caught``)."""
    out = {}
    for name, (call, catch) in _probes(device).items():
        trace = record(call)
        out[name] = {"ops": [s.op for s in trace],
                     "caught": any(catch(s) for s in trace)}
    return out
