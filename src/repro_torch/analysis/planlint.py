"""Plan-IR verifier: machine-check the transitive DAG before it runs (port
of ``repro.analysis.planlint``).

This module guards the *plan artifacts* the port executes: the
:class:`~repro_torch.core.engine.ExecutionPlan` schedule, its compiled
:class:`~repro_torch.core.engine.DevicePlan` gather maps, the compact
:class:`~repro_torch.core.engine.ForestPlan` /
:class:`~repro_torch.core.engine.SparseForestPlan` that the CUDA forest
kernels run (``engine_cuda``), and the persisted plan bundles the fleet
layer ships planner→server. A corrupted plan is refused with a named
finding *before* it can silently compute the wrong GEMM.

Rules are registered objects (one process-level registry, loud
duplicates) over numpy copies of the plan IR; a tensor leaf on any
device is read with ``.detach().cpu().numpy()``. Verification is
**fail-fast at rule granularity**: rules run in registration order and
the first rule that fires reports alone — downstream rules assume
upstream invariants (bounds before graph shape before DAG order), so one
corruption yields exactly one finding whose path names the bad field.

The reference's twelve rules keep their names, order, finding paths and
messages. Six more are registered after them: ``device-tile-local`` (a
DevicePlan's int32 leaves and tile-local edges, which the kernels and
the sparse packer rely on), and five over the compact plans (artifact
kind ``"forest"``), which the reference's gates pass through unexamined
but which are what the card executes: ``forest-shape``,
``forest-producers``, ``forest-gathers``, ``sparse-forest`` and
``plan-forest-agreement``.

The verifier is wired as a *gate* at the three trust boundaries a plan
crosses (set ``REPRO_PLANLINT=0`` to disable all three). The switch
turns off verification, not the checks a kernel's raw-pointer reads rely
on: where a plan enters a server from outside its own planner (bundle
load, swap staging), the rules marked ``guards_kernel``
(``device-tile-local``, ``forest-shape``, ``sparse-forest``) run all the
same.

* ``PlanCache`` publish (``core/plancache.py``) — a freshly built plan
  (``cache-publish``) and its device lowering (``cache-lowering``) are
  verified before other callers can coalesce onto them;
* ``fleet.bundles.load_bundles`` on the server role (``bundle-load``) —
  the manifest is a checked artifact, every bundle file is structurally
  verified **before** its SHA-256 is checked (a truncated npz is a
  planlint refusal, not a hash mismatch), and the attached, lowered
  plan is verified again;
* ``ServeEngine.swap_params`` staging (``swap-staging``) — a hot-swap
  generation's embedded plans are verified before they are staged, so a
  corrupt replan can never reach the decode step.

Entry points: :func:`verify_plan`, :func:`verify_device_plan` (a
DevicePlan, ForestPlan or SparseForestPlan), :func:`verify_bundle_file`,
:func:`verify_manifest`, the raising ``gate_*`` twins, and
:func:`lint_plans` (the plan half of the serve launcher's ``--lint``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.analysis.rules import Finding
from repro_torch.core.engine import (FOREST_DIRECT, FOREST_UNUSED,
                                     FOREST_WIDE_MAX_T, SPARSE_MAX_SLOT,
                                     SPARSE_MAX_T, DevicePlan, ExecutionPlan,
                                     ForestPlan, SparseForestPlan,
                                     check_tile_local, forest_rows_dtype,
                                     sparse_forest_fault)

__all__ = ["PlanArtifact", "PlanRule", "PlanVerificationError",
           "register_plan_rule", "unregister_plan_rule", "get_plan_rule",
           "list_plan_rules", "enabled", "verify_plan",
           "verify_device_plan", "verify_bundle_file", "verify_manifest",
           "gate_plan", "gate_device", "gate_manifest", "gate_bundle_file",
           "gate_params", "iter_device_plans", "lint_plans"]


def enabled() -> bool:
    """The gates' kill switch: ``REPRO_PLANLINT=0`` disables them."""
    return os.environ.get("REPRO_PLANLINT", "1").lower() not in (
        "0", "false", "no", "off")


class PlanVerificationError(ValueError):
    """A plan artifact failed verification at a trust boundary."""

    def __init__(self, findings: list[Finding], where: str) -> None:
        self.findings = list(findings)
        self.where = where
        lines = "\n  ".join(f.format() for f in self.findings)
        super().__init__(
            f"planlint: {len(self.findings)} finding(s) at gate "
            f"'{where}':\n  {lines}")


@dataclasses.dataclass
class PlanArtifact:
    """One verifiable plan artifact with everything plan rules inspect.

    ``kind`` selects which rules apply: ``"plan"`` (host
    ``ExecutionPlan``), ``"device"`` (compiled ``DevicePlan``, possibly
    stacked/padded), ``"forest"`` (a ``ForestPlan`` or
    ``SparseForestPlan``, possibly stacked), ``"manifest"`` (a fleet
    bundle manifest dict, with ``bundle_dir`` for on-disk file checks).
    ``device`` holds the device or forest plan and ``device_np`` its
    leaves as host numpy. ``plan`` rides along on device and forest
    artifacts when the caller has it, enabling the agreement rules.
    """
    kind: str
    name: str                       # Finding.program label
    backend: str | None = None
    plan: Any = None                # ExecutionPlan
    device: Any = None              # DevicePlan / ForestPlan / Sparse...
    device_np: dict[str, np.ndarray] | None = None
    manifest: dict[str, Any] | None = None
    bundle_dir: str | None = None


class PlanRule:
    """Base class for one plan-IR invariant.

    ``kinds`` names the artifact kinds the rule applies to; a rule
    reports **at most one finding** (the first violation, with the
    total count in the message) so the fail-fast driver's
    one-corruption-one-finding contract holds. ``guards_kernel`` marks a
    rule that holds what a kernel reads through raw pointers: it runs at
    bundle load and swap staging even with ``REPRO_PLANLINT=0``.
    """
    name: str = ""
    severity: str = "error"
    kinds: tuple[str, ...] = ("plan",)
    guards_kernel: bool = False
    description: str = ""

    def check(self, art: PlanArtifact) -> list[Finding]:
        raise NotImplementedError

    def _finding(self, art: PlanArtifact, message: str, *,
                 path: str = "", field: str | None = None) -> Finding:
        return Finding(rule=self.name, severity=self.severity,
                       program=art.name, backend=art.backend,
                       path=path, primitive=field, message=message)


_PLAN_REGISTRY: dict[str, PlanRule] = {}


def register_plan_rule(rule: PlanRule, *, replace: bool = False) -> PlanRule:
    name = getattr(rule, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError(f"plan rule must declare a non-empty string "
                         f"name, got {name!r}")
    if name in _PLAN_REGISTRY and not replace:
        raise ValueError(f"plan rule '{name}' is already registered "
                         f"({_PLAN_REGISTRY[name]!r}); pass replace=True "
                         f"to override")
    _PLAN_REGISTRY[name] = rule
    return rule


def unregister_plan_rule(name: str) -> PlanRule:
    if name not in _PLAN_REGISTRY:
        raise KeyError(f"unknown plan rule {name!r}; registered: "
                       f"{', '.join(sorted(_PLAN_REGISTRY))}")
    return _PLAN_REGISTRY.pop(name)


def get_plan_rule(name: str) -> PlanRule:
    try:
        return _PLAN_REGISTRY[name]
    except (KeyError, TypeError):
        raise KeyError(f"unknown plan rule {name!r}; registered: "
                       f"{', '.join(sorted(_PLAN_REGISTRY))}") from None


def list_plan_rules() -> tuple[str, ...]:
    return tuple(_PLAN_REGISTRY)


def _run(art: PlanArtifact, *, guards_only: bool = False
         ) -> list[Finding]:
    """Registration-order fail-fast: first firing rule reports alone
    (only the ``guards_kernel`` rules with ``guards_only``)."""
    for rule in _PLAN_REGISTRY.values():
        if art.kind not in rule.kinds or (guards_only
                                          and not rule.guards_kernel):
            continue
        findings = rule.check(art)
        if findings:
            return findings
    return []


# ---------------------------------------------------------------------------
# numpy helpers shared by several rules
# ---------------------------------------------------------------------------

def _popcount(v: np.ndarray, t: int) -> np.ndarray:
    v = np.asarray(v, np.int64)
    return ((v[..., None] >> np.arange(t)) & 1).sum(-1)


def _first_bad(mask: np.ndarray) -> tuple[int, ...]:
    """Index tuple of the first True entry of a boolean mask."""
    flat = int(np.flatnonzero(np.asarray(mask).reshape(-1))[0])
    return tuple(int(i) for i in
                 np.unravel_index(flat, np.asarray(mask).shape))


def _idx(name: str, where: tuple[int, ...]) -> str:
    return f"{name}[{', '.join(map(str, where))}]"


def _host(a: Any) -> np.ndarray:
    """A leaf as host numpy: tensors on any device are copied down."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# ExecutionPlan rules (host plan IR)
# ---------------------------------------------------------------------------

class PlanShape(PlanRule):
    """The plan's arrays agree on one layer signature."""
    name = "plan-shape"
    kinds = ("plan",)
    description = ("rows/signs/steps/direct arrays all match the "
                   "(t, bits, n, k, groups) signature; k divides into "
                   "whole tiles and groups into whole tile sets")

    def check(self, art):
        p = art.plan
        t, bits = int(p.t), int(p.bits)
        if t <= 0 or bits <= 0 or p.n <= 0 or p.k <= 0:
            return [self._finding(
                art, f"non-positive signature (t={p.t}, bits={p.bits}, "
                f"n={p.n}, k={p.k})", path="t", field="t")]
        if p.k % t:
            return [self._finding(
                art, f"k={p.k} is not a whole number of t={t} tiles",
                path="k", field="k")]
        j = p.k // t
        if p.groups < 1 or j % p.groups:
            return [self._finding(
                art, f"groups={p.groups} does not divide the "
                f"{j}-tile axis", path="groups", field="groups")]
        rows = np.asarray(p.rows)
        if rows.shape != (bits, p.n, j):
            return [self._finding(
                art, f"rows shape {rows.shape} != (bits, n, k//t)="
                f"({bits}, {p.n}, {j})", path="rows", field="rows")]
        if np.asarray(p.signs).shape != (bits,):
            return [self._finding(
                art, f"signs shape {np.asarray(p.signs).shape} != "
                f"(bits,)=({bits},)", path="signs", field="signs")]
        d = np.asarray(p.direct_tile).shape
        if (np.asarray(p.direct_node).shape != d
                or np.asarray(p.direct_bits).shape != d + (t,)):
            return [self._finding(
                art, f"direct arrays disagree: tile{d} node"
                f"{np.asarray(p.direct_node).shape} bits"
                f"{np.asarray(p.direct_bits).shape} (want (D,), (D,), "
                f"(D, {t}))", path="direct_bits", field="direct_bits")]
        if len(p.steps) > t:
            return [self._finding(
                art, f"{len(p.steps)} level steps > t={t} (a node has "
                f"at most t bits)", path="steps", field="steps")]
        for i, s in enumerate(p.steps):
            ln = {np.asarray(a).shape for a in
                  (s.tile, s.node, s.prefix, s.bit)}
            if len(ln) != 1 or any(len(sh) != 1 for sh in ln):
                return [self._finding(
                    art, f"steps[{i}] edge arrays disagree on length: "
                    f"{sorted(ln)}", path=f"steps[{i}]", field="steps")]
        return []


class PlanBounds(PlanRule):
    """Every plan index is inside the structure it addresses."""
    name = "plan-bounds"
    kinds = ("plan",)
    description = ("rows < 2^t, step tiles/nodes/prefixes/bits and "
                   "direct nodes inside the (J, 2^t, t) index spaces, "
                   "direct_bits in {0, 1}")

    def check(self, art):
        p = art.plan
        t, size, j = int(p.t), 1 << int(p.t), p.k // p.t
        checks = [("rows", np.asarray(p.rows), 0, size),
                  ("direct_tile", np.asarray(p.direct_tile), 0, j),
                  ("direct_node", np.asarray(p.direct_node), 0, size)]
        for i, s in enumerate(p.steps):
            checks += [(f"steps[{i}].tile", np.asarray(s.tile), 0, j),
                       (f"steps[{i}].node", np.asarray(s.node), 0, size),
                       (f"steps[{i}].prefix", np.asarray(s.prefix), 0,
                        size),
                       (f"steps[{i}].bit", np.asarray(s.bit), 0, t)]
        for name, arr, lo, hi in checks:
            bad = (arr < lo) | (arr >= hi)
            if bad.any():
                w = _first_bad(bad)
                return [self._finding(
                    art, f"{int(bad.sum())} value(s) outside [{lo}, "
                    f"{hi}): first {_idx(name, w)} = "
                    f"{int(arr[w])}", path=_idx(name, w),
                    field=name.split("[")[0].split(".")[-1])]
        db = np.asarray(p.direct_bits)
        bad = (db != 0) & (db != 1)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"direct_bits must be a {{0,1}} mask; first "
                f"{_idx('direct_bits', w)} = {int(db[w])}",
                path=_idx("direct_bits", w), field="direct_bits")]
        return []


class PlanDirectPattern(PlanRule):
    """Direct-dispatch bit masks reconstruct their node values."""
    name = "plan-direct-pattern"
    kinds = ("plan",)
    description = ("each direct node's {0,1} bit mask is the binary "
                   "decomposition of its node value — direct dispatch "
                   "computes subset sums straight from the mask")

    def check(self, art):
        p = art.plan
        db = np.asarray(p.direct_bits, np.int64)
        if db.size == 0:
            return []
        got = (db << np.arange(p.t)).sum(-1)
        bad = got != np.asarray(p.direct_node, np.int64)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} direct bit mask(s) do not "
                f"decompose their node: first direct_bits[{w[0]}] sums "
                f"to {int(got[w])} but direct_node[{w[0]}] = "
                f"{int(p.direct_node[w[0]])}",
                path=f"direct_bits[{w[0]}]", field="direct_bits")]
        return []


class PlanScheduleLevels(PlanRule):
    """Steps are level-homogeneous with single-bit covering edges."""
    name = "plan-schedule-levels"
    kinds = ("plan",)
    description = ("steps[i] holds exactly the Hamming-level-(i+1) "
                   "nodes and every edge covers: node ^ prefix is the "
                   "single bit the step names")

    def check(self, art):
        p = art.plan
        for i, s in enumerate(p.steps):
            node = np.asarray(s.node, np.int64)
            if node.size == 0:
                continue
            lv = _popcount(node, p.t)
            bad = lv != (i + 1)
            if bad.any():
                w = _first_bad(bad)
                return [self._finding(
                    art, f"{int(bad.sum())} node(s) in steps[{i}] "
                    f"(level {i + 1}) at the wrong Hamming level: first "
                    f"{_idx(f'steps[{i}].node', w)} = {int(node[w])} "
                    f"(level {int(lv[w])}) — a reordered level executes "
                    f"before its prefixes exist",
                    path=_idx(f"steps[{i}].node", w), field="node")]
            edge = node ^ np.asarray(s.prefix, np.int64)
            want = np.int64(1) << np.asarray(s.bit, np.int64)
            bad = edge != want
            if bad.any():
                w = _first_bad(bad)
                return [self._finding(
                    art, f"{int(bad.sum())} non-covering edge(s) in "
                    f"steps[{i}]: first {_idx(f'steps[{i}].prefix', w)} "
                    f"= {int(s.prefix[w])} vs node {int(node[w])} "
                    f"(xor {int(edge[w])}, declared bit "
                    f"{int(s.bit[w])})",
                    path=_idx(f"steps[{i}].prefix", w), field="prefix")]
        return []


class PlanScheduleDag(PlanRule):
    """The reuse schedule is an acyclic, level-monotone forest."""
    name = "plan-schedule-dag"
    kinds = ("plan",)
    description = ("each (tile, node) is produced at most once, and "
                   "every level-l edge's prefix was produced strictly "
                   "earlier (direct dispatch, an earlier level, or the "
                   "empty node 0)")

    def check(self, art):
        # the reference walks every edge in execution order; here each
        # (tile, node) is a key ``tile << t | node`` (plan-bounds holds
        # both in range) and the first violation in that order is found
        # with array ops: the same finding, without the Python loop
        p = art.plan
        t = int(p.t)
        key = lambda tile, node: (np.asarray(tile, np.int64).reshape(-1)
                                  << t) | np.asarray(node, np.int64
                                                     ).reshape(-1)
        direct = key(p.direct_tile, p.direct_node)
        if np.unique(direct).size != np.asarray(p.direct_tile).size:
            return [self._finding(
                art, "duplicate (tile, node) in direct dispatch — a "
                "node produced twice races its own scatter",
                path="direct_node", field="direct_node")]
        made, pre, start = [direct], [], []
        for s in p.steps:
            tile, node, prefix = (np.asarray(a, np.int64).reshape(-1)
                                  for a in (s.tile, s.node, s.prefix))
            n = min(tile.size, node.size, prefix.size)      # zip's length
            start.append(np.full(n, sum(m.size for m in made), np.int64))
            made.append(key(tile[:n], node[:n]))
            pre.append(np.stack([tile[:n], prefix[:n]]))
        if not pre:
            return []
        keys = np.concatenate(made)
        uniq, first = np.unique(keys, return_index=True)

        def first_made(k):
            """Each key's first production position (past the end if never
            made)."""
            i = np.minimum(np.searchsorted(uniq, k), uniq.size - 1)
            return np.where(uniq[i] == k, first[i], keys.size)
        step_pos = np.arange(direct.size, keys.size)
        dup = first_made(keys[direct.size:]) < step_pos
        tile, prefix = np.concatenate(pre, axis=1)
        start = np.concatenate(start)
        stale = (prefix != 0) & (first_made(key(tile, prefix)) >= start)
        bad = dup | stale
        if not bad.any():
            return []
        q = int(np.flatnonzero(bad)[0])
        i = int(np.searchsorted(np.cumsum([m.size for m in made[1:]]), q,
                                side="right"))
        e = q - (int(start[q]) - direct.size)
        tl, nd = int(tile[q]), int(keys[direct.size + q] & ((1 << t) - 1))
        if dup[q]:
            return [self._finding(
                art, f"(tile {tl}, node {nd}) produced twice — "
                f"second production at steps[{i}].node[{e}]",
                path=f"steps[{i}].node[{e}]", field="node")]
        return [self._finding(
            art, f"steps[{i}].prefix[{e}] gathers (tile "
            f"{tl}, node {int(prefix[q])}) which is not produced at "
            f"any earlier level — the schedule is not a "
            f"DAG in execution order (a same-level or "
            f"later production would read a stale psum "
            f"row)", path=f"steps[{i}].prefix[{e}]",
            field="prefix")]


# ---------------------------------------------------------------------------
# DevicePlan rules (compiled gather maps, possibly stacked/padded)
# ---------------------------------------------------------------------------

def _device_np(device: Any) -> dict[str, np.ndarray]:
    """The leaves of a DevicePlan, ForestPlan or SparseForestPlan as host
    numpy."""
    return {f: _host(a) for f, a in device.leaves().items()}


def _device_dims(device: Any) -> tuple[int, int, int, int]:
    """(t, J, R, K) of a device plan's metadata signature."""
    t = int(device.t)
    j = int(device.k) // t
    return t, j, j * (1 << t), int(device.k)


class DeviceShape(PlanRule):
    """Stack-axis consistency: every leaf agrees on one lead shape."""
    name = "device-shape"
    kinds = ("device",)
    description = ("all DevicePlan leaves share the same leading "
                   "(stack) axes and their core dims match the "
                   "(t, bits, n, k, groups) signature — the contract "
                   "compile_plans/pad_device_plan preserve")

    def check(self, art):
        d, f = art.device, art.device_np
        t = int(d.t)
        if t <= 0 or d.k <= 0 or d.k % t:
            return [self._finding(
                art, f"signature k={d.k} is not a whole number of "
                f"t={t} tiles", path="k", field="k")]
        tt, j, r, _k = _device_dims(d)
        if int(d.groups) < 1 or j % int(d.groups):
            return [self._finding(
                art, f"groups={d.groups} does not divide the {j}-tile "
                f"axis", path="groups", field="groups")]
        ls = f["level_src"]
        if ls.ndim < 2 or ls.shape[-2:] != (tt, r):
            return [self._finding(
                art, f"level_src core shape {ls.shape[-2:] if ls.ndim >= 2 else ls.shape} != (t, J*2^t)="
                f"({tt}, {r})", path="level_src", field="level_src")]
        lead = ls.shape[:-2]
        dwidth = f["direct_idx"].shape[-1] if f["direct_idx"].ndim else 0
        want = {"level_xsrc": lead + (tt, r),
                "direct_idx": lead + (dwidth,),
                "direct_x_idx": lead + (dwidth, tt),
                "direct_bits": lead + (dwidth, tt),
                "gather_idx": lead + (int(d.bits), int(d.n), j),
                "signs": lead + (int(d.bits),)}
        for name, shape in want.items():
            if f[name].shape != shape:
                return [self._finding(
                    art, f"{name} shape {f[name].shape} != {shape} — "
                    f"leaves disagree on the stack axes / signature "
                    f"(lead {lead})", path=name, field=name)]
        if dwidth < 1:
            return [self._finding(
                art, "direct_idx width 0: compile_plan always emits at "
                "least one (possibly dead) direct lane",
                path="direct_idx", field="direct_idx")]
        return []


class DeviceBounds(PlanRule):
    """Every gather/scatter index is inside its table (or the
    sanctioned one-past-end row)."""
    name = "device-bounds"
    kinds = ("device",)
    description = ("level_src/gather_idx < J*2^t, level_xsrc <= K "
                   "(K = the pinned zero activation row), direct_idx "
                   "<= J*2^t (= the dropped pad target), direct_x_idx "
                   "< K, direct_bits in {0, 1}")

    def check(self, art):
        d, f = art.device, art.device_np
        _t, _j, r, k = _device_dims(d)
        checks = [("level_src", f["level_src"], r),
                  ("level_xsrc", f["level_xsrc"], k + 1),
                  ("direct_idx", f["direct_idx"], r + 1),
                  ("direct_x_idx", f["direct_x_idx"], k),
                  ("gather_idx", f["gather_idx"], r)]
        for name, arr, hi in checks:
            bad = (arr < 0) | (arr >= hi)
            if bad.any():
                w = _first_bad(bad)
                return [self._finding(
                    art, f"{int(bad.sum())} index value(s) outside "
                    f"[0, {hi}): first {_idx(name, w)} = "
                    f"{int(arr[w])} — an out-of-bounds gather clamps "
                    f"silently on device and corrupts the GEMM",
                    path=_idx(name, w), field=name)]
        db = f["direct_bits"]
        bad = (db != 0) & (db != 1)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"direct_bits must be a {{0,1}} mask; first "
                f"{_idx('direct_bits', w)} = {int(db[w])}",
                path=_idx("direct_bits", w), field="direct_bits")]
        return []


class DeviceIdentityLanes(PlanRule):
    """Identity lanes gather themselves plus exactly the zero row."""
    name = "device-identity-lanes"
    kinds = ("device",)
    description = ("level_src[l, r] == r iff level_xsrc[l, r] == K: a "
                   "self-gather adding a real activation row double-"
                   "counts it; a cross-gather adding the zero row "
                   "overwrites a psum with a copy")

    def check(self, art):
        d, f = art.device, art.device_np
        t, _j, r, k = _device_dims(d)
        ls = f["level_src"].reshape(-1, t, r)
        lx = f["level_xsrc"].reshape(-1, t, r)
        rid = np.arange(r, dtype=ls.dtype)
        identity = ls == rid[None, None, :]
        zero = lx == k
        bad = identity != zero
        if bad.any():
            s, lv, row = _first_bad(bad)
            kind = ("identity lane adds real activation row "
                    f"{int(lx[s, lv, row])}" if identity[s, lv, row]
                    else f"executed lane (src {int(ls[s, lv, row])}) "
                    f"adds the pinned zero row")
            where = ((s, lv, row) if f["level_src"].ndim > 2
                     else (lv, row))
            return [self._finding(
                art, f"{int(bad.sum())} lane(s) break the identity "
                f"contract: first {_idx('level_xsrc', where)} — {kind}",
                path=_idx("level_xsrc", where), field="level_xsrc")]
        return []


class DeviceLevelMonotone(PlanRule):
    """The gather schedule is acyclic: sources settle strictly
    earlier."""
    name = "device-level-monotone"
    kinds = ("device",)
    description = ("each psum row is executed at most once across the "
                   "level maps, and an executed row's source row is "
                   "never executed at the same or a later level — the "
                   "device-side statement of DAG acyclicity")

    def check(self, art):
        d, f = art.device, art.device_np
        t, _j, r, _k = _device_dims(d)
        stacked = f["level_src"].ndim > 2
        ls_all = f["level_src"].reshape(-1, t, r)
        rid = np.arange(r, dtype=ls_all.dtype)
        for s in range(ls_all.shape[0]):
            ls = ls_all[s]
            execd = ls != rid[None, :]
            times = execd.sum(0)
            if (times > 1).any():
                row = int(np.flatnonzero(times > 1)[0])
                lvls = np.flatnonzero(execd[:, row]).tolist()
                where = ((s, lvls[1], row) if stacked
                         else (lvls[1], row))
                return [self._finding(
                    art, f"psum row {row} is executed at "
                    f"{int(times[row])} levels {lvls} — a node is "
                    f"computed once; the later execution overwrites it",
                    path=_idx("level_src", where), field="level_src")]
            exec_level = np.where(execd.any(0), execd.argmax(0), -1)
            lv_i, row_i = np.nonzero(execd)
            src = ls[lv_i, row_i]
            bad = exec_level[src] >= lv_i
            if bad.any():
                b = int(np.flatnonzero(bad)[0])
                lv, row = int(lv_i[b]), int(row_i[b])
                where = (s, lv, row) if stacked else (lv, row)
                return [self._finding(
                    art, f"{int(bad.sum())} edge(s) violate level "
                    f"monotonicity: first {_idx('level_src', where)} "
                    f"gathers row {int(src[b])}, which is itself "
                    f"executed at level {int(exec_level[src[b]])} (>= "
                    f"{lv}) — a cycle or reordered level in the reuse "
                    f"graph reads an unsettled psum",
                    path=_idx("level_src", where), field="level_src")]
        return []


class DeviceDirectDispatch(PlanRule):
    """Pad lanes are provably dead; live lanes are one-writer."""
    name = "device-direct-dispatch"
    kinds = ("device",)
    description = ("pad lanes (target J*2^t) carry all-zero bit masks "
                   "(the pad_device_plan contract), live targets are "
                   "unique, and no live target is also level-executed")

    def check(self, art):
        d, f = art.device, art.device_np
        t, _j, r, _k = _device_dims(d)
        stacked = f["direct_idx"].ndim > 1
        di_all = f["direct_idx"].reshape(-1, f["direct_idx"].shape[-1])
        db_all = f["direct_bits"].reshape(-1,
                                          f["direct_bits"].shape[-2], t)
        ls_all = f["level_src"].reshape(-1, t, r)
        rid = np.arange(r)
        for s in range(di_all.shape[0]):
            di, db = di_all[s], db_all[s]
            pad = di == r
            live_bits = db.any(-1)
            bad = pad & live_bits
            if bad.any():
                lane = int(np.flatnonzero(bad)[0])
                bit = int(np.flatnonzero(db[lane])[0])
                where = (s, lane, bit) if stacked else (lane, bit)
                return [self._finding(
                    art, f"{int(bad.sum())} pad lane(s) are not dead: "
                    f"first {_idx('direct_bits', where)} = "
                    f"{int(db[lane, bit])} on a lane whose scatter "
                    f"target is the dropped row {r} — pad lanes must "
                    f"be bit-exact no-ops (pad_device_plan contract) "
                    f"or a hot-swap pad changes the GEMM",
                    path=_idx("direct_bits", where),
                    field="direct_bits")]
            live = di[~pad]
            if live.size != np.unique(live).size:
                vals, counts = np.unique(live, return_counts=True)
                dup = int(vals[counts > 1][0])
                lane = int(np.flatnonzero(di == dup)[1])
                where = (s, lane) if stacked else (lane,)
                return [self._finding(
                    art, f"direct target row {dup} is scattered by "
                    f"multiple lanes — last-writer-wins makes the "
                    f"psum nondeterministic",
                    path=_idx("direct_idx", where), field="direct_idx")]
            execd_rows = rid[(ls_all[s] != rid[None, :]).any(0)]
            clash = np.isin(live, execd_rows)
            if clash.any():
                lane = int(np.flatnonzero(~pad)[np.flatnonzero(clash)[0]])
                where = (s, lane) if stacked else (lane,)
                return [self._finding(
                    art, f"direct target row {int(di[lane])} is also "
                    f"executed by the level maps — the node would be "
                    f"computed twice",
                    path=_idx("direct_idx", where), field="direct_idx")]
        return []


def _divergence(rule: PlanRule, art: PlanArtifact, want: dict,
                noun: str, verb: str) -> list[Finding]:
    """The agreement rules' comparison, bit for bit: the first leaf of
    ``art`` that differs from ``want``, the host numpy leaves of the host
    plan's ``noun`` (what the plan ``verb`` to)."""
    for name, exp in want.items():
        got = art.device_np[name]
        if exp.shape != got.shape or not np.array_equal(exp, got):
            w = (_first_bad(exp != got) if exp.shape == got.shape
                 else ())
            return [rule._finding(
                art, f"{name} does not match the host plan's {noun}"
                + (f": first divergence at {_idx(name, w)} "
                   f"(got {int(got[w])}, plan {verb} to "
                   f"{int(exp[w])})" if w else
                   f" (shape {got.shape} vs {exp.shape})"),
                path=_idx(name, w) if w else name, field=name)]
    return []


class PlanDeviceAgreement(PlanRule):
    """The device lowering is exactly what the host plan compiles to."""
    name = "plan-device-agreement"
    kinds = ("device",)
    description = ("when the host plan is available and the device "
                   "plan is unstacked, recompiling the plan (at the "
                   "observed direct pad) reproduces every leaf bit-"
                   "exactly — catches content corruption that is "
                   "individually well-formed")

    def check(self, art):
        if art.plan is None:
            return []
        f = art.device_np
        if f["level_src"].ndim != 2:
            return []                 # stacked: per-slice plans unknown
        from repro_torch.core.engine import compile_plan, pad_device_plan
        want = compile_plan(art.plan)
        pad = f["direct_idx"].shape[-1]
        if pad > want.direct_idx.shape[-1]:
            want = pad_device_plan(want, pad)
        return _divergence(self, art, _device_np(want), "compilation",
                           "compiles")


class DeviceTileLocal(PlanRule):
    """The DevicePlan is what the port's executors and packers read."""
    name = "device-tile-local"
    kinds = ("device",)
    guards_kernel = True
    description = ("every leaf is int32, and every forest edge stays "
                   "inside its own T-tile (core.engine.check_tile_local: "
                   "level sources and activation rows in the row's tile "
                   "or the pinned zero row, direct entries sorted and "
                   "reading their own tile, gathers inside the table) — "
                   "what compile_plan emits and the forest packers and "
                   "kernels rely on")

    def check(self, art):
        d, f = art.device, art.device_np
        for name, a in f.items():
            if a.dtype != np.int32:
                return [self._finding(
                    art, f"DevicePlan.{name} must be int32, got "
                    f"{a.dtype}", path=name, field=name)]
        if not check_tile_local(int(d.t), int(d.k), f["level_src"],
                                f["level_xsrc"], f["direct_idx"],
                                f["direct_x_idx"], f["gather_idx"]):
            return [self._finding(
                art, f"DevicePlan (t={d.t}, n={d.n}, k={d.k}) is not "
                f"tile-local: not a compile_plan lowering",
                path="tile_local", field="tile_local")]
        return []


# ---------------------------------------------------------------------------
# ForestPlan / SparseForestPlan rules (the CUDA forest kernels' plans)
# ---------------------------------------------------------------------------

def _forest_dtypes(fp: Any) -> dict[str, torch.dtype]:
    if isinstance(fp, SparseForestPlan):
        return {"codes": torch.int32, "bounds": torch.int32,
                "rows": torch.int16, "signs": torch.int32}
    return {"producer": torch.uint8, "rows": forest_rows_dtype(fp.t),
            "signs": torch.int32}


class ForestShape(PlanRule):
    """The compact plan's leaves are what its kernel reads through raw
    pointers."""
    name = "forest-shape"
    kinds = ("forest",)
    guards_kernel = True
    description = ("T fits the plan's kind (ForestPlan: T <= 15, a node "
                   "in int16; SparseForestPlan: T <= 31), k divides into "
                   "tiles and groups into tile sets, every leaf has its "
                   "dtype, is contiguous and on one device, and the "
                   "leaves agree on (t, bits, n, k) and one lead; a "
                   "SparseForestPlan's slots fit int16 in a table width "
                   "that is a multiple of 4")

    def check(self, art):
        d, f = art.device, art.device_np
        sparse = isinstance(d, SparseForestPlan)
        kind = type(d).__name__
        t = int(d.t)
        t_max = SPARSE_MAX_T if sparse else FOREST_WIDE_MAX_T
        if not 1 <= t <= t_max:
            why = ("a direct node's bits fit 31" if sparse else
                   "a node index fits int16")
            return [self._finding(
                art, f"a {kind} holds T <= {t_max} ({why}), got t={t}",
                path="t", field="t")]
        if d.k <= 0 or d.k % t:
            return [self._finding(
                art, f"k={d.k} is not a whole number of t={t} tiles",
                path="k", field="k")]
        j = int(d.k) // t
        if int(d.groups) < 1 or j % int(d.groups):
            return [self._finding(
                art, f"groups={d.groups} does not divide the {j}-tile "
                f"axis", path="groups", field="groups")]
        leaves = d.leaves()
        for name, dtype in _forest_dtypes(d).items():
            a = leaves[name]
            if a.dtype != dtype or not a.is_contiguous():
                return [self._finding(
                    art, f"{kind}.{name} must be contiguous {dtype}, got "
                    f"{a.dtype} (contiguous: {a.is_contiguous()}) — the "
                    f"kernel reads it through a raw pointer",
                    path=name, field=name)]
        home = leaves["signs"].device
        for name, a in leaves.items():
            if a.device != home:
                return [self._finding(
                    art, f"{kind} leaves must share one device: {name} "
                    f"is on {a.device}, signs on {home}",
                    path=name, field=name)]
        lead = f["signs"].shape[:-1]
        bits, n = int(d.bits), int(d.n)
        if sparse:
            u = f["codes"].shape[-1] if f["codes"].ndim else 0
            want = {"signs": lead + (bits,), "codes": lead + (j, u),
                    "bounds": lead + (j, t + 1),
                    "rows": lead + (j, bits, n)}
        else:
            want = {"signs": lead + (bits,),
                    "producer": lead + (j, 1 << t),
                    "rows": lead + (j, bits, n)}
        for name, shape in want.items():
            if f[name].shape != shape:
                return [self._finding(
                    art, f"{name} shape {f[name].shape} != {shape} — "
                    f"leaves disagree on the stack axes / signature "
                    f"(lead {lead})", path=name, field=name)]
        if sparse and (u % 4 or u < 1):
            return [self._finding(
                art, f"codes' width {u} is not a positive multiple of 4 "
                f"(a tile's codes start on 16 bytes)", path="codes",
                field="codes")]
        if sparse and u - 1 > SPARSE_MAX_SLOT:
            return [self._finding(
                art, f"{u} table rows: a slot must fit int16 (<= "
                f"{SPARSE_MAX_SLOT})", path="codes", field="codes")]
        return []


def _made_nodes(producer: np.ndarray) -> np.ndarray:
    """(..., J, 2^T) bool: the nodes a ForestPlan makes, node 0 (the empty
    sum) counted as made."""
    made = producer != FOREST_UNUSED
    made[..., 0] = True
    return made


class ForestProducers(PlanRule):
    """Every node is made from a prefix the plan makes, one bit down."""
    name = "forest-producers"
    kinds = ("forest",)
    description = ("each producer[j, v] is a bit b < T set in v whose "
                   "prefix v ^ (1 << b) is made (chained or direct) or "
                   "is node 0, or FOREST_DIRECT, or FOREST_UNUSED; node "
                   "0 is never produced")

    def check(self, art):
        if isinstance(art.device, SparseForestPlan):
            return []                   # slots: see sparse-forest
        t = int(art.device.t)
        p = art.device_np["producer"].astype(np.int64)
        v = np.arange(1 << t)
        bad = (p >= t) & (p != FOREST_DIRECT) & (p != FOREST_UNUSED)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} producer code(s) are neither a "
                f"bit < T={t}, FOREST_DIRECT ({FOREST_DIRECT}) nor "
                f"FOREST_UNUSED ({FOREST_UNUSED}): first "
                f"{_idx('producer', w)} = {int(p[w])}",
                path=_idx("producer", w), field="producer")]
        bad = np.zeros(p.shape, bool)
        bad[..., 0] = p[..., 0] != FOREST_UNUSED
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} tile(s) produce node 0, the empty "
                f"sum: first {_idx('producer', w)} = {int(p[w])} (node 0 "
                f"is always 0 and never made)",
                path=_idx("producer", w), field="producer")]
        chained = p < t
        b = np.where(chained, p, 0)
        bad = chained & (((v >> b) & 1) == 0)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} node(s) name a bit they do not "
                f"hold: first {_idx('producer', w)} = {int(p[w])} but "
                f"node {w[-1]} lacks bit {int(p[w])} — its prefix would "
                f"have a bit more, not one fewer",
                path=_idx("producer", w), field="producer")]
        pre = v ^ (1 << b)
        bad = chained & ~np.take_along_axis(_made_nodes(p), pre, -1)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} node(s) are made from a prefix "
                f"the plan never makes: first {_idx('producer', w)} = "
                f"{int(p[w])} makes node {w[-1]} from node "
                f"{int(pre[w])}, which is FOREST_UNUSED — the kernel "
                f"reads an unwritten psum row", path=_idx("producer", w),
                field="producer")]
        return []


class ForestGathers(PlanRule):
    """Every APE gather reads a node the plan makes."""
    name = "forest-gathers"
    kinds = ("forest",)
    description = ("each rows[j, s, n] is below 2^T and names a made "
                   "node or node 0 — the kernel leaves unused nodes "
                   "unwritten, so gathering one computes a wrong GEMM "
                   "silently")

    def check(self, art):
        if isinstance(art.device, SparseForestPlan):
            return []                   # slots: see sparse-forest
        t = int(art.device.t)
        f = art.device_np
        rows = f["rows"].astype(np.int64)
        bad = (rows < 0) | (rows >= 1 << t)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} gather(s) outside [0, {1 << t}): "
                f"first {_idx('rows', w)} = {int(rows[w])}",
                path=_idx("rows", w), field="rows")]
        made = _made_nodes(f["producer"])
        flat = rows.reshape(rows.shape[:-2] + (-1,))
        bad = ~np.take_along_axis(made, flat, -1).reshape(rows.shape)
        if bad.any():
            w = _first_bad(bad)
            return [self._finding(
                art, f"{int(bad.sum())} gather(s) read a node the plan "
                f"never makes: first {_idx('rows', w)} = "
                f"{int(rows[w])}, whose producer is FOREST_UNUSED — the "
                f"kernel reads an unwritten psum row and the GEMM is "
                f"wrong, silently", path=_idx("rows", w), field="rows")]
        return []


class SparseForest(PlanRule):
    """A SparseForestPlan's slots settle in level order."""
    name = "sparse-forest"
    kinds = ("forest",)
    guards_kernel = True
    description = ("each tile's level bounds start at slot 1, never "
                   "fall and stay in the table; every chained slot's "
                   "prefix slot lies in an earlier level (or is slot 0) "
                   "and its bit is below T; every direct slot's node has "
                   "T bits and its own level's popcount; every gathered "
                   "slot is made (or is slot 0) — "
                   "core.engine.sparse_forest_fault")

    def check(self, art):
        if not isinstance(art.device, SparseForestPlan):
            return []
        fault = sparse_forest_fault(art.device)
        if fault is None:
            return []
        path, field, message = fault
        return [self._finding(art, message, path=path, field=field)]


class PlanForestAgreement(PlanRule):
    """The compact plan is exactly what the host plan lowers to."""
    name = "plan-forest-agreement"
    kinds = ("forest",)
    description = ("when the host plan is available and the forest plan "
                   "is unstacked, engine_cuda's lowering of the plan "
                   "(compile_plan, then the packer of the payload's "
                   "kind) reproduces every leaf bit-exactly — catches "
                   "content corruption that is individually well-formed")

    def check(self, art):
        if art.plan is None or art.device.lead:
            return []                 # stacked: per-slice plans unknown
        from repro_torch.core.engine import (_pack_forest,
                                             _pack_sparse_forest,
                                             compile_plan)
        pack = (_pack_sparse_forest
                if isinstance(art.device, SparseForestPlan)
                else lambda d: _pack_forest(d, "cpu"))
        try:
            want = pack(compile_plan(art.plan))
        except ValueError as e:
            return [self._finding(
                art, f"the host plan does not lower to a "
                f"{type(art.device).__name__}: {e}", path="plan",
                field="plan")]
        return _divergence(self, art, _device_np(want), "lowering",
                           "lowers")


# ---------------------------------------------------------------------------
# Bundle rules (fleet manifest + persisted npz files)
# ---------------------------------------------------------------------------

class BundleManifest(PlanRule):
    """The fleet manifest is internally coherent before any file is
    trusted."""
    name = "bundle-manifest"
    kinds = ("manifest",)
    description = ("manifest.json carries the format/backend/"
                   "engine_config/fingerprint keys, layer leads match "
                   "their file lists (unique in-bounds index tuples), "
                   "and every referenced file exists")

    _REQUIRED = ("format", "backend", "engine_config",
                 "weights_fingerprint", "n_layers", "n_files", "layers")

    def check(self, art):
        m = art.manifest
        if not isinstance(m, dict):
            return [self._finding(
                art, f"manifest is {type(m).__name__}, not a dict",
                path="manifest", field="manifest")]
        missing = [k for k in self._REQUIRED if k not in m]
        if missing:
            return [self._finding(
                art, f"manifest is missing key(s) {missing}",
                path=missing[0], field=missing[0])]
        ec = m["engine_config"]
        if not isinstance(ec, dict) or not {"w_bits", "t"} <= set(ec):
            return [self._finding(
                art, f"engine_config {ec!r} lacks w_bits/t",
                path="engine_config", field="engine_config")]
        layers = m["layers"]
        if not isinstance(layers, dict):
            return [self._finding(
                art, f"layers is {type(layers).__name__}, not a dict",
                path="layers", field="layers")]
        if m["n_layers"] != len(layers):
            return [self._finding(
                art, f"n_layers={m['n_layers']} but the manifest "
                f"carries {len(layers)} layer(s)", path="n_layers",
                field="n_layers")]
        n_files = 0
        for lpath, meta in layers.items():
            where = f"layers[{lpath!r}]"
            for key in ("lead", "groups", "files"):
                if key not in meta:
                    return [self._finding(
                        art, f"{where} is missing '{key}'",
                        path=f"{where}.{key}", field=key)]
            lead = tuple(int(v) for v in meta["lead"])
            n_slices = int(np.prod(lead)) if lead else 1
            files = meta["files"]
            if len(files) != n_slices:
                return [self._finding(
                    art, f"{where} lead {list(lead)} implies "
                    f"{n_slices} slice file(s), manifest lists "
                    f"{len(files)}", path=f"{where}.files",
                    field="files")]
            seen: set[tuple[int, ...]] = set()
            for fi, e in enumerate(files):
                fwhere = f"{where}.files[{fi}]"
                miss = [k for k in ("file", "index", "sha256")
                        if k not in e]
                if miss:
                    return [self._finding(
                        art, f"{fwhere} is missing {miss}",
                        path=f"{fwhere}.{miss[0]}", field=miss[0])]
                idx = tuple(int(v) for v in e["index"])
                if len(idx) != len(lead) or any(
                        not 0 <= v < b for v, b in zip(idx, lead)):
                    return [self._finding(
                        art, f"{fwhere}.index {list(idx)} is outside "
                        f"lead {list(lead)}", path=f"{fwhere}.index",
                        field="index")]
                if idx in seen:
                    return [self._finding(
                        art, f"{fwhere}.index {list(idx)} repeats an "
                        f"earlier slice", path=f"{fwhere}.index",
                        field="index")]
                seen.add(idx)
                if art.bundle_dir is not None and not os.path.exists(
                        os.path.join(art.bundle_dir, str(e["file"]))):
                    return [self._finding(
                        art, f"{fwhere}.file {e['file']!r} does not "
                        f"exist in {art.bundle_dir}",
                        path=f"{fwhere}.file", field="file")]
                n_files += 1
        if m["n_files"] != n_files:
            return [self._finding(
                art, f"n_files={m['n_files']} but the layer tables "
                f"list {n_files} file(s)", path="n_files",
                field="n_files")]
        return []


# the reference's twelve in its order, then the port's DevicePlan rule and
# the compact plans' five
for _r in (PlanShape(), PlanBounds(), PlanDirectPattern(),
           PlanScheduleLevels(), PlanScheduleDag(), DeviceShape(),
           DeviceBounds(), DeviceIdentityLanes(), DeviceLevelMonotone(),
           DeviceDirectDispatch(), PlanDeviceAgreement(),
           BundleManifest(), DeviceTileLocal(), ForestShape(),
           ForestProducers(), ForestGathers(), SparseForest(),
           PlanForestAgreement()):
    register_plan_rule(_r)
del _r


# ---------------------------------------------------------------------------
# Verification entry points
# ---------------------------------------------------------------------------

# the artifact kind of each device lowering
_KIND = {DevicePlan: "device", ForestPlan: "forest",
         SparseForestPlan: "forest"}


def verify_plan(plan: Any, *, backend: str | None = None,
                name: str = "plan") -> list[Finding]:
    """Run the ExecutionPlan rules; returns the (fail-fast) findings."""
    return _run(PlanArtifact(kind="plan", name=name, backend=backend,
                             plan=plan))


def verify_device_plan(device: Any, plan: Any = None, *,
                       backend: str | None = None,
                       name: str = "device-plan",
                       guards_only: bool = False) -> list[Finding]:
    """Run the rules of a device lowering: a DevicePlan's (plus
    plan↔device agreement when the host plan is supplied), or a
    ForestPlan's / SparseForestPlan's (plus plan↔forest agreement); only
    the ``guards_kernel`` rules with ``guards_only``. Leaves are pulled
    to host numpy once, from any device."""
    if not isinstance(device, tuple(_KIND)):
        raise TypeError(f"not a device plan: {type(device).__name__}")
    return _run(PlanArtifact(kind=_KIND[type(device)], name=name,
                             backend=backend, plan=plan, device=device,
                             device_np=_device_np(device)),
                guards_only=guards_only)


def verify_manifest(manifest: Any, *, bundle_dir: str | None = None,
                    backend: str | None = None,
                    name: str = "bundle-manifest") -> list[Finding]:
    """Run the manifest-coherence rules over a fleet bundle manifest."""
    return _run(PlanArtifact(kind="manifest", name=name, backend=backend,
                             manifest=manifest, bundle_dir=bundle_dir))


def verify_bundle_file(path: str | os.PathLike, *,
                       backend: str | None = None) -> list[Finding]:
    """Structurally verify one persisted plan bundle ``.npz``.

    Parses the file (an unreadable/truncated npz is itself a finding —
    this runs *before* any hash check at the bundle-load gate), then
    runs the plan rules on the stored ExecutionPlan and, when the file
    carries a device lowering, the device rules plus plan↔device
    agreement against the stored plan.
    """
    name = os.path.basename(str(path))
    try:
        bundle = ExecutionPlan.load_bundle(path)
    except Exception as e:                      # noqa: BLE001 — any parse
        return [Finding(
            rule="bundle-file", severity="error", program=name,
            backend=backend, path=str(path), primitive="npz",
            message=f"bundle file is unreadable as a plan npz "
            f"({type(e).__name__}: {e}) — truncated or corrupt "
            f"artifact refused before any hash comparison")]
    findings = verify_plan(bundle.plan, backend=backend, name=name)
    if not findings and bundle.device is not None:
        findings = verify_device_plan(bundle.device, bundle.plan,
                                      backend=backend, name=name)
    return findings


# ---------------------------------------------------------------------------
# Gates (the raising twins — wired at the trust boundaries)
# ---------------------------------------------------------------------------

def _require(findings: list[Finding], where: str) -> None:
    if findings:
        raise PlanVerificationError(findings, where)


def gate_plan(plan: Any, *, where: str,
              backend: str | None = None) -> None:
    """Raise :class:`PlanVerificationError` unless ``plan`` verifies."""
    if enabled():
        _require(verify_plan(plan, backend=backend), where)


def gate_device(device: Any, plan: Any = None, *, where: str,
                backend: str | None = None,
                guard_kernel: bool = False) -> None:
    """Raise unless the compiled ``device`` plan verifies.

    A DevicePlan, ForestPlan or SparseForestPlan (stacked or not) is
    verified; ``TransitiveBackend.compile`` may return any payload, and
    other payloads pass through unexamined (their backend owns their
    format). With ``guard_kernel`` (a plan from outside the server's own
    planner) the ``guards_kernel`` rules run even when the gates are
    off."""
    if not isinstance(device, tuple(_KIND)):
        return
    if enabled() or guard_kernel:
        _require(verify_device_plan(device, plan, backend=backend,
                                    guards_only=not enabled()), where)


def gate_manifest(manifest: Any, *, where: str,
                  bundle_dir: str | None = None,
                  backend: str | None = None) -> None:
    """Raise unless the bundle manifest is coherent."""
    if enabled():
        _require(verify_manifest(manifest, bundle_dir=bundle_dir,
                                 backend=backend), where)


def gate_bundle_file(path: Any, *, where: str,
                     backend: str | None = None) -> None:
    """Raise unless the persisted bundle file verifies structurally.

    Deliberately runs *before* any sha256 comparison at the load
    boundary: a truncated or hand-edited npz is refused on structure,
    so the integrity check never has to parse attacker-shaped bytes."""
    if enabled():
        _require(verify_bundle_file(path, backend=backend), where)


def iter_device_plans(tree: Any, path: tuple = ()
                      ) -> Iterator[tuple[str, Any]]:
    """Yield ``("a/b/dplan", plan)`` for every DevicePlan, ForestPlan and
    SparseForestPlan (stacked or not) embedded in a params tree
    (dict/list/tuple walk)."""
    if isinstance(tree, tuple(_KIND)):
        yield "/".join(map(str, path)) or "dplan", tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_device_plans(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_device_plans(v, path + (i,))


def gate_params(params: Any, *, where: str,
                guard_kernel: bool = False) -> None:
    """Verify every device plan embedded in a params tree (the
    swap-staging gate: a hot-swap generation's plans are checked before
    they can be staged). With ``guard_kernel`` the ``guards_kernel``
    rules run even when the gates are off."""
    if not (enabled() or guard_kernel):
        return
    for label, dplan in iter_device_plans(params):
        findings = verify_device_plan(dplan, name=label,
                                      guards_only=not enabled())
        _require(findings, where)


# ---------------------------------------------------------------------------
# The plan lint driver (the plan half of the serve launcher's --lint)
# ---------------------------------------------------------------------------

def lint_plans(backend_names: list[str], *, device=None, mesh: Any = None
               ) -> tuple[list[dict], list[Finding]]:
    """Build representative plan artifacts per backend and verify them.

    Per planned backend: an ungrouped plan, a grouped plan, the backend's
    lowering of the plan (``device``), of a stacked pair
    (``device-stacked``) and of a padded DevicePlan (``device-padded``),
    and a full save→``verify_bundle_file`` npz round trip (with the
    DevicePlan lowering and weight fingerprint riding along). A backend
    that lowers to compact forest plans (``engine_cuda``) also verifies
    its lowering of a T = 16 plan (``device-sparse``, a
    SparseForestPlan). Lowerings are placed on ``device``
    (``resolve_device``: ``cuda`` unless asked otherwise). Returns
    (report rows, findings) — zero findings on a healthy tree.
    ``mesh=`` (multi-device placement) waits for ROADMAP item A10.
    """
    if mesh is not None:
        raise NotImplementedError(
            "lint_plans(mesh=): multi-device plan placement is not "
            "ported; it waits for ROADMAP item A10")
    from repro_torch.core.backend import get_backend
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan, complete_forest_plan,
                                         pad_device_plan)
    from repro_torch.core.plancache import weight_fingerprint
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    report, all_findings = [], []
    rng = np.random.default_rng(7)
    for name in backend_names:
        b = get_backend(name)
        row = {"backend": name, "artifacts": [], "findings": []}
        if not b.needs_plan:
            row["skipped"] = "backend plans nothing (needs_plan=False)"
            report.append(row)
            continue
        eng = BatchedTransitiveEngine(bits=8, t=4)
        w = rng.integers(-128, 128, (16, 32)).astype(np.int64)
        w2 = rng.integers(-128, 128, (16, 32)).astype(np.int64)
        plan = eng.plan(w)
        grouped = eng.plan(w, groups=2)
        artifacts = [("plan", lambda: verify_plan(plan, backend=name)),
                     ("plan-grouped",
                      lambda: verify_plan(grouped, backend=name))]
        lowering = None
        if b.device_resident:
            device_plan = b.compile(plan, device=dev)
            stacked = b.compile([plan, eng.plan(w2)], device=dev)
            lowering = compile_plan(plan, device=dev)
            padded = pad_device_plan(
                lowering, int(lowering.direct_idx.shape[-1]) + 3)
            compact = not isinstance(device_plan, DevicePlan)
            if compact:
                padded = b.lower(padded, dev)
            artifacts += [
                ("device", lambda: verify_device_plan(
                    device_plan, plan, backend=name)),
                ("device-stacked", lambda: verify_device_plan(
                    stacked, backend=name, name="device-stacked")),
                ("device-padded", lambda: verify_device_plan(
                    padded, backend=name, name="device-padded")),
            ]
            if compact:
                wide = complete_forest_plan(16, 300, 16)
                artifacts.append(("device-sparse", lambda: (
                    verify_plan(wide, backend=name, name="device-sparse")
                    or verify_device_plan(b.compile(wide, device=dev), wide,
                                          backend=name,
                                          name="device-sparse"))))

        def _roundtrip() -> list[Finding]:
            with tempfile.TemporaryDirectory() as td:
                p = os.path.join(td, "layer.npz")
                plan.save(p, device=lowering,
                          backend=name if lowering is not None else None,
                          fingerprint=weight_fingerprint(w))
                return verify_bundle_file(p, backend=name)

        artifacts.append(("bundle-roundtrip", _roundtrip))
        findings = []
        for label, fn in artifacts:
            findings.extend(fn())
            row["artifacts"].append(label)
        row["findings"] = [f.to_json() for f in findings]
        all_findings.extend(findings)
        report.append(row)
    return report, all_findings
