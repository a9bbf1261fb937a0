"""Execution backends for the integer GEMM: a registry with capability flags
(port of ``repro.core.backend``).

Five backends; each maps to a reference backend:

  ==================  ==================  ==================================
  port                reference           what runs
  ==================  ==================  ==================================
  ``int_dot``         ``int_dot``         dense integer GEMM (float64
                                          matmul, exact: every partial sum
                                          of int8 x int8 products over
                                          K <= 2^20 stays below 2^53)
  ``lut``             ``lut``             the doubling-LUT transitive GEMM
                                          in plain torch (kernels/ref.py),
                                          on either device
  ``lut_cuda``        ``pallas``          the doubling-LUT GEMM as the CUDA
                                          kernel (its plain version on CPU
                                          tensors); no plan
  ``engine_torch``    ``engine_jit``      the planned forest, ``run_device``
                                          in plain torch gathers
  ``engine_cuda``     ``engine_pallas``   the planned forest as the CUDA
                                          kernel, from compact
                                          ``ForestPlan``s (its plain
                                          version on CPU tensors)
  ==================  ==================  ==================================

The reference's host ``engine`` (a ``pure_callback`` oracle) is not
ported. ``execute`` contract (all integer, bit-exact with the
``int_dot`` int32 accumulator):

  * ungrouped (``cfg.groups == 1``): ``x (..., K) x w (N, K) -> (..., N)``
  * grouped   (``cfg.groups == G``): ``x (..., G, g) x w (N, G, g) ->
    (..., G, N)`` per-group partial sums.

CUDA has no int8/int32 ``torch.matmul``; float64 is exact here and is the
one path on both devices (``torch._int_mm`` is kept out of the port).

Run ``python -m repro_torch.core.backend`` to print the registry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.engine import (FOREST_WIDE_MAX_T, DevicePlan,
                                     ExecutionPlan, ForestPlan,
                                     SparseForestPlan, compile_plan,
                                     compile_plans, pack_forest_plan,
                                     pack_sparse_forest_plan, run_device,
                                     sparse_forest_slots)
from repro_torch.tracepoints import scope

__all__ = ["EngineConfig", "TransitiveBackend", "register_backend",
           "get_backend", "list_backends", "int_matmul"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The engine-side execution signature ``(w_bits, t, groups)``."""
    w_bits: int = 8
    t: int = 8                 # TransRow width
    groups: int = 1

    @classmethod
    def from_quant(cls, qcfg: Any, groups: int = 1) -> "EngineConfig":
        return cls(w_bits=qcfg.w_bits, t=qcfg.transrow_t, groups=groups)

    def key(self) -> tuple[int, int, int]:
        return (int(self.w_bits), int(self.t), int(self.groups))


CAPABILITY_FLAGS = ("device_resident", "supports_groups", "needs_plan",
                    "cpu_ok")


class TransitiveBackend:
    """Base class for one online execution strategy.

    ``device_resident``: ``execute`` runs on the tensors' device and, with
    ``needs_plan``, from a compiled plan (:class:`DevicePlan`,
    :class:`ForestPlan` or :class:`SparseForestPlan`). ``supports_groups``:
    grouped inputs are accepted. ``needs_plan``: there is an offline
    weight-only half (the plan cache builds it; :meth:`compile` lowers
    it). ``cpu_ok``: runs on CPU tensors (the CUDA backend does, through
    its kernel's plain version).

    ``lint_exempt`` names the tracelint rules (``repro_torch.analysis``)
    that do not apply to the backend, with a reason per tag in the
    class docstring. No port backend has one: the reference's one
    exemption belongs to its host ``engine`` oracle, which is not ported.
    """
    name: str = ""
    device_resident: bool = False
    supports_groups: bool = True
    needs_plan: bool = False
    cpu_ok: bool = True
    lint_exempt: frozenset[str] = frozenset()

    def compile(self, plan, device=None
                ) -> DevicePlan | ForestPlan | SparseForestPlan | None:
        """Lower one plan (or a sequence of same-signature plans -> one
        stacked plan) to device tensors; None if there is no lowering."""
        return None

    def execute(self, x: torch.Tensor, w: torch.Tensor,
                plan: ExecutionPlan | None,
                dplan: DevicePlan | ForestPlan | SparseForestPlan | None,
                cfg: EngineConfig) -> torch.Tensor:
        raise NotImplementedError

    def capabilities(self) -> dict[str, bool]:
        return {f: bool(getattr(self, f)) for f in CAPABILITY_FLAGS}

    def __repr__(self) -> str:
        caps = ", ".join(f for f in CAPABILITY_FLAGS if getattr(self, f))
        return f"{type(self).__name__}(name={self.name!r}, {caps})"


_REGISTRY: dict[str, TransitiveBackend] = {}


def register_backend(backend: TransitiveBackend, *,
                     replace: bool = False) -> TransitiveBackend:
    """Register ``backend`` under ``backend.name`` (duplicates raise unless
    ``replace=True``)."""
    name = getattr(backend, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError(f"backend must declare a non-empty string name, "
                         f"got {name!r}")
    if name in _REGISTRY and not replace:
        raise ValueError(
            f"backend '{name}' is already registered "
            f"({_REGISTRY[name]!r}); pass replace=True to override")
    _REGISTRY[name] = backend
    return backend


def list_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def _unknown_msg(name) -> str:
    return (f"unknown backend {name!r}; registered backends: "
            f"{', '.join(sorted(_REGISTRY))}")


def get_backend(name) -> TransitiveBackend:
    """Resolve a registry name, a backend instance (returned as is), or a
    ``QuantConfig``-shaped object with a ``backend`` name."""
    if isinstance(name, TransitiveBackend):
        return name
    if not isinstance(name, str) and isinstance(
            getattr(name, "backend", None), str):
        name = name.backend
    try:
        return _REGISTRY[name]
    except (KeyError, TypeError):
        raise KeyError(_unknown_msg(name)) from None


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` for int8-range operands -> int32.

    float64 holds every partial sum exactly while it stays below 2^53,
    which int8 x int8 products reach only past K = 2^39; the result is the
    int32 accumulator the reference's ``preferred_element_type=int32``
    dots give."""
    with scope("int_matmul"):
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
            .to(torch.int32)


class IntDotBackend(TransitiveBackend):
    """Dense integer GEMM — the bit-exactness reference for the others."""
    name = "int_dot"
    device_resident = True

    def execute(self, x, w, plan, dplan, cfg):
        if cfg.groups > 1:
            # (..., G, g) x (N, G, g) -> (..., G, N), batched over G
            xg = x.movedim(-2, 0)                         # (G, ..., g)
            out = int_matmul(xg.reshape(xg.shape[0], -1, xg.shape[-1]),
                             w.permute(1, 2, 0))          # (G, B, N)
            out = out.reshape(xg.shape[:-1] + (w.shape[0],))
            return out.movedim(0, -2)
        return int_matmul(x, w.transpose(0, 1))


class LutBackend(TransitiveBackend):
    """The dense doubling-LUT transitive GEMM in plain torch
    (``kernels/ref.py``) on the tensors' device — the paper's result-reuse
    dataflow in software, data-independent; the counterpart of ``lut``."""
    name = "lut"
    device_resident = True

    def execute(self, x, w, plan, dplan, cfg):
        from repro_torch.kernels import ref
        if cfg.groups > 1:
            return ref.transitive_matmul_grouped_ref(x, w, cfg.w_bits, cfg.t)
        return ref.transitive_matmul_ref(x, w, cfg.w_bits, cfg.t)


class LutCudaBackend(TransitiveBackend):
    """The doubling-LUT schedule through the hand-written CUDA kernel
    (``kernels/transitive_gemm.py``; its plain version on CPU tensors);
    the counterpart of ``pallas``. Needs no plan."""
    name = "lut_cuda"
    device_resident = True

    def execute(self, x, w, plan, dplan, cfg):
        from repro_torch.kernels import ops
        if cfg.groups > 1:
            return ops.transitive_gemm_grouped(x, w, w_bits=cfg.w_bits,
                                               t=cfg.t)
        return ops.transitive_gemm(x, w, w_bits=cfg.w_bits, t=cfg.t)


class EngineTorchBackend(TransitiveBackend):
    """The planned forest from a DevicePlan in plain torch (``run_device``);
    the counterpart of the reference's ``engine_jit``."""
    name = "engine_torch"
    needs_plan = True
    device_resident = True

    def compile(self, plan, device=None):
        if isinstance(plan, ExecutionPlan):
            return compile_plan(plan, device=device)
        if isinstance(plan, Sequence):
            return compile_plans(list(plan), device=device)
        raise TypeError(f"plan must be an ExecutionPlan or a sequence "
                        f"of them, got {type(plan).__name__}")

    def execute(self, x, w, plan, dplan, cfg):
        if dplan is None:
            raise ValueError(
                f"backend '{self.name}' executes from a DevicePlan: pass "
                f"one, or serve through plancache.attach_device_plans")
        if cfg.groups > 1:
            n_groups, g = x.shape[-2], x.shape[-1]
            flat = x.reshape(-1, n_groups * g).to(torch.int32).T
            y = run_device(dplan, flat)                    # (N, G, B)
            return y.permute(2, 1, 0).reshape(x.shape[:-1] + (dplan.n,))
        flat = x.reshape(-1, x.shape[-1]).to(torch.int32).T      # (K, B)
        y = run_device(dplan, flat)                              # (N, B)
        return y.T.reshape(x.shape[:-1] + (dplan.n,))


class EngineCudaBackend(EngineTorchBackend):
    """The same forest through the hand-written CUDA kernel
    (kernels/transitive_forest.py); the counterpart of ``engine_pallas``.

    Compiles plans with T <= 15 to compact :class:`ForestPlan`s (the dense
    DevicePlan is lowered on the host and packed; only the ForestPlan is
    placed on ``device``): uint8 gathers up to T = 8, run by the fused
    kernel of ``csrc/transitive_forest.cu``; int16 gathers for 9 <= T <=
    15, run by the fused kernel of ``csrc/transitive_forest_dense.cu``.
    ``execute`` hands the int8 codes (..., K) to the kernels' row entry as
    they are and gets (..., N) / (..., G, N) back: no cast, transpose or
    copy. A DevicePlan passed in is packed at its first call
    (``kernels/transitive_forest.py`` keeps the packing). From T = 16 a
    node does not fit int16: plans compile to :class:`SparseForestPlan`s
    (the made nodes only, renumbered per tile), run by the fused kernel of
    ``csrc/transitive_forest_sparse.cu``, where one column of a tile's
    table fits shared memory (``kernels/transitive_forest_sparse.py::
    sparse_fits``); a plan whose table does not fit stays a DevicePlan on
    ``device``, which the same entry runs through the two-pass dense
    kernel (``kernels/transitive_forest_dense.py``)."""
    name = "engine_cuda"

    def compile(self, plan, device=None):
        return self.lower(super().compile(plan), device)   # on the host

    def lower(self, dplan: DevicePlan, device=None):
        """The kernel's plan from a host DevicePlan (stacked or not): what
        :meth:`compile` places on ``device``, and what a loaded plan
        bundle's DevicePlan is packed into. Packing is not planning."""
        from repro_torch.kernels.transitive_forest_sparse import sparse_fits
        if dplan.t <= FOREST_WIDE_MAX_T:
            return pack_forest_plan(dplan, device=device)
        if sparse_fits(dplan.t, dplan.bits, sparse_forest_slots(dplan)):
            return pack_sparse_forest_plan(dplan, device=device)
        if device is None:
            return dplan
        return dataclasses.replace(dplan, **{
            f: a.to(device) for f, a in dplan.leaves().items()})

    def execute(self, x, w, plan, dplan, cfg):
        from repro_torch.kernels.transitive_forest import (
            transitive_forest_rows)
        if dplan is None:
            raise ValueError(
                f"backend '{self.name}' executes from a device plan: pass "
                f"one, or serve through plancache.attach_device_plans")
        y = transitive_forest_rows(dplan, x.reshape(-1, dplan.k))
        return y.reshape(x.shape[:-1] + (dplan.n,))


for _b in (IntDotBackend(), LutBackend(), LutCudaBackend(),
           EngineTorchBackend(), EngineCudaBackend()):
    register_backend(_b)
del _b


if __name__ == "__main__":
    for n in list_backends():
        print(f"{n:16s} {get_backend(n).capabilities()}")
