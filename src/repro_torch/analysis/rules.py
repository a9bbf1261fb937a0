"""Tracelint rules: the serving-path invariants as registered objects
(port of ``repro.analysis.rules``).

Each property is one :class:`Rule` in a process-level registry
(``register_rule`` / ``get_rule`` / ``list_rules``, loud duplicates and
listed unknown names, as ``core/backend.py``'s). A rule inspects one
:class:`LintProgram`: an op trace of one call of a serving program
(``analysis/walker.py``) and, where the check needs them, a second trace
of the same program on other input values, the KV leaves it must update
in place, and the live arrays and mesh. Every violation is a
:class:`Finding` carrying the offending op, its path in the trace and a
severity; findings key into an allowlist baseline
(``analysis/baseline.py``) so new violations fail while known ones stay
explicit. Rule names, :meth:`Finding.key` and the baseline format are the
reference's, so a baseline file written by either package loads in the
other.

Built-in rules (the reference's, read from the op trace):

``no-host-callback``
    no host round trip in a serving program (``walker.host_sync``): no
    ``.item()`` / ``int()`` / ``bool()`` of a tensor, no copy between the
    host and the device, no host data entering the program
    (``aten.lift_fresh``: ``torch.tensor`` of a Python value). In eager
    torch a host round trip is a sync, not a callback.
``gather-only-levels``
    no scatter-family op inside a loop scope: the forest's level loop
    advances by gathers only (the one legal scatter, direct dispatch,
    runs once per call outside the loop).
``static-shapes``
    no op whose output shape depends on input values (``nonzero``,
    boolean-mask indexing, ...), and the program recorded a second time
    on other input values of the same signature runs the same sequence of
    ops, shapes, dtypes and kernel sites (a differing sequence is the
    counterpart of a data-dependent ``while``).
``kv-donation``
    every KV leaf the program must update in place
    (``LintProgram.donate_expect``) comes back in its own storage, and no
    op reads a leaf and writes a fresh tensor as large as the whole leaf
    (a copy per step: the counterpart of a donation lowering dropped).
``dtype-purity``
    no bf16/f16 output inside a quantize scope (``scope("quantize_kv")``:
    the KV8 divergence class), and no float64 output outside the exact
    integer products: the port runs int8 x int8 products as float64
    matmuls, exact below 2^53 (``scope("int_einsum")``,
    ``scope("int_matmul")``), where the reference's XLA dots accumulate
    in int32 and it admits no float64 at all.
``sharding-integrity``
    under a multi-rank mesh no large array is fully replicated (DTensor
    placements all ``Replicate()``); needs ``arrays`` and a mesh, which
    the ``decode`` program carries when it is built under a mesh
    (``build_programs(mesh=)``: its batch-sharded, really prefilled
    caches); elsewhere it is skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.analysis.walker import (SCATTER_OPS, OpTrace, host_sync,
                                         is_dynamic_shape, named_tensors)

__all__ = ["Finding", "LintProgram", "Rule", "EXACT_SCOPES",
           "register_rule", "unregister_rule", "get_rule", "list_rules",
           "run_rules"]


# the scopes of the port's exact integer products (int8 x int8 as float64
# matmuls, exact below 2^53), where dtype-purity allows float64
EXACT_SCOPES = frozenset({"int_einsum", "int_matmul"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, locatable and baselinable."""
    rule: str
    severity: str                 # "error" | "warning"
    program: str                  # "decode", "prefill", "forest", ...
    backend: str | None
    path: str                     # op path ("" = program-level)
    primitive: str | None
    message: str

    def key(self) -> str:
        """Baseline key: stable across unrelated edits (no path — the path
        is for humans, the key is for the allowlist)."""
        return "::".join((self.rule, self.backend or "-", self.program,
                          self.primitive or "-"))

    def format(self) -> str:
        where = f" at {self.path}" if self.path else ""
        return (f"[{self.severity}] {self.rule} ({self.program}"
                f"{', backend=' + self.backend if self.backend else ''})"
                f"{where}: {self.message}")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key()
        return d


@dataclasses.dataclass
class LintProgram:
    """One lintable serving program with everything rules may inspect.

    ``trace`` (one recorded call) feeds the structural rules; ``retrace``
    (the same program on other input values of the same signature) feeds
    ``static-shapes``' schedule check; ``donate_expect`` maps a label to
    ``{result path: leaf}``, the KV leaves the call must update in place
    and where they come back in its result (``walker.named_tensors``
    paths), for ``kv-donation``; ``arrays`` (label -> tree of tensors) +
    ``mesh`` feed ``sharding-integrity``. ``rules`` names the rules this
    program is subject to (:func:`run_rules` leaves out the backend's
    ``lint_exempt``). ``skipped`` says why a program was not built here
    (no rule runs on it).
    """
    name: str
    rules: tuple[str, ...]
    backend: str | None = None
    trace: OpTrace | None = None
    retrace: OpTrace | None = None
    donate_expect: dict[str, dict[str, torch.Tensor]] | None = None
    mesh: Any = None
    arrays: dict[str, Any] | None = None
    quantize_scopes: tuple[str, ...] = ("quantize_kv",)
    skipped: str | None = None


class Rule:
    """Base class for one serving-path invariant.

    ``requires`` names the :class:`LintProgram` field the rule reads
    (``"trace"``, ``"donate_expect"`` or ``"arrays"``); :func:`run_rules`
    skips the rule with no finding when a program does not carry it —
    absence of evidence is a program-construction concern, not a
    violation.
    """
    name: str = ""
    severity: str = "error"
    requires: str = "trace"
    description: str = ""

    def check(self, prog: LintProgram) -> list[Finding]:
        raise NotImplementedError

    def _finding(self, prog: LintProgram, message: str, *,
                 path: str = "", primitive: str | None = None) -> Finding:
        return Finding(rule=self.name, severity=self.severity,
                       program=prog.name, backend=prog.backend,
                       path=path, primitive=primitive, message=message)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"severity={self.severity!r}, requires={self.requires!r})")


# ---------------------------------------------------------------------------
# Registry (core/backend.py's shape: loud duplicates, listed unknowns)
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Rule] = {}


def register_rule(rule: Rule, *, replace: bool = False) -> Rule:
    name = getattr(rule, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError(f"rule must declare a non-empty string name, "
                         f"got {name!r}")
    if name in _REGISTRY and not replace:
        raise ValueError(f"rule '{name}' is already registered "
                         f"({_REGISTRY[name]!r}); pass replace=True to "
                         f"override")
    _REGISTRY[name] = rule
    return rule


def unregister_rule(name: str) -> Rule:
    if name not in _REGISTRY:
        raise KeyError(_unknown_msg(name))
    return _REGISTRY.pop(name)


def list_rules() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def _unknown_msg(name) -> str:
    return (f"unknown rule {name!r}; registered rules: "
            f"{', '.join(sorted(_REGISTRY))}")


def get_rule(name: str) -> Rule:
    try:
        return _REGISTRY[name]
    except (KeyError, TypeError):
        raise KeyError(_unknown_msg(name)) from None


def run_rules(prog: LintProgram, *, exempt: frozenset[str] = frozenset(),
              only: tuple[str, ...] | None = None) -> list[Finding]:
    """Run every rule named in ``prog.rules`` (minus ``exempt``, and
    intersected with ``only`` when given) that has its required evidence;
    nothing for a skipped program."""
    out: list[Finding] = []
    if prog.skipped:
        return out
    for name in prog.rules:
        if name in exempt or (only is not None and name not in only):
            continue
        rule = get_rule(name)
        if getattr(prog, rule.requires, None) is None:
            continue
        out.extend(rule.check(prog))
    return out


# ---------------------------------------------------------------------------
# Built-in rules
# ---------------------------------------------------------------------------

class NoHostCallback(Rule):
    """Serving programs make no host round trip."""
    name = "no-host-callback"
    description = ("no host round trip in a serving program: no .item() / "
                   "int() / bool() of a tensor, no copy between host and "
                   "device, no host data entering (aten.lift_fresh)")

    def check(self, prog):
        out = []
        for site in prog.trace:
            why = host_sync(site)
            if why is not None:
                out.append(self._finding(
                    prog, f"host round trip '{site.op}' ({why}) in a "
                    f"serving program — decode/prefill must stay on "
                    f"device", path=site.path, primitive=site.packet))
        return out


class GatherOnlyLevels(Rule):
    """Forest level loops advance by gathers only."""
    name = "gather-only-levels"
    description = ("no scatter-family op inside a loop scope; the "
                   "forest's one legal scatter (direct dispatch) runs "
                   "once per call outside the level loop")

    def check(self, prog):
        out = []
        for site in prog.trace:
            if site.in_loop and site.is_in(SCATTER_OPS):
                out.append(self._finding(
                    prog, f"'{site.packet}' inside a loop body — level "
                    f"loops must be gather-only (psum[src] + x[xsrc]); a "
                    f"scatter per level serializes the forest",
                    path=site.path, primitive=site.packet))
        return out


class StaticShapes(Rule):
    """Shapes (and the execution schedule) are signature-determined."""
    name = "static-shapes"
    description = ("no op whose output shape depends on input values, and "
                   "the same op/shape/dtype/kernel sequence on other input "
                   "values of the same signature")

    def check(self, prog):
        out = []
        for site in prog.trace:
            if is_dynamic_shape(site):
                out.append(self._finding(
                    prog, f"'{site.op}' has a value-dependent output shape "
                    f"{[o.shape for o in site.outputs]} — shapes must be "
                    f"signature-determined", path=site.path,
                    primitive=site.packet))
        if prog.retrace is not None:
            a, b = prog.trace.sites, prog.retrace.sites
            i = next((i for i, (x, y) in enumerate(zip(a, b))
                      if x.signature() != y.signature()), min(len(a), len(b)))
            if i < max(len(a), len(b)):
                here = a[i] if i < len(a) else b[i]
                other = b[i].op if i < len(b) else "the end"
                out.append(self._finding(
                    prog, f"the op sequence depends on input values: op "
                    f"{i} is '{here.op}' in one call and '{other}' in "
                    f"another of the same signature ({len(a)} vs {len(b)} "
                    f"ops) — the counterpart of a data-dependent while",
                    path=here.path, primitive=here.packet))
        return out


class KvDonation(Rule):
    """Decode updates its KV buffers in place."""
    name = "kv-donation"
    requires = "donate_expect"
    description = ("every KV leaf comes back in its own storage (updated "
                   "in place) and no op copies a whole leaf (a copy per "
                   "token, the counterpart of dropped donation)")

    def check(self, prog):
        after = named_tensors(prog.trace.result)
        out = []
        for label, leaves in prog.donate_expect.items():
            ptr = {path: t.untyped_storage().data_ptr()
                   for path, t in leaves.items()}
            moved = sorted(p for p, t in leaves.items()
                           if p not in after or after[p].untyped_storage()
                           .data_ptr() != ptr[p])
            if moved:
                out.append(self._finding(
                    prog, f"{len(moved)}/{len(leaves)} {label} buffers are "
                    f"NOT updated in place (they come back in other "
                    f"storage: {moved[:4]}) — every decode step pays a "
                    f"full copy of those buffers", path=label))
            # a copy: an op reads a whole leaf and writes a fresh tensor of
            # the leaf's dtype and size
            whole = {ptr[p]: (t.numel(), t.dtype) for p, t in leaves.items()}
            for site in prog.trace:
                read = [whole[i.storage] for i in site.inputs
                        if i.storage in whole
                        and i.numel == whole[i.storage][0]]
                for o in site.outputs:
                    if o.storage in whole:
                        continue
                    if (o.numel, o.dtype) in read:
                        out.append(self._finding(
                            prog, f"'{site.op}' reads a {label} leaf and "
                            f"writes a fresh {o.dtype} tensor "
                            f"{tuple(o.shape)} as large as the whole leaf "
                            f"— a copy of the buffer per call",
                            path=site.path, primitive=site.packet))
        return out


class DtypePurity(Rule):
    """Quantize subgraphs stay in f32/int; float64 only in exact
    integer products."""
    name = "dtype-purity"
    description = ("no bf16/f16 output inside quantize scopes "
                   "(scope('quantize_kv') — the KV8 divergence class), no "
                   "float64 output outside the exact integer products "
                   "(scope('int_einsum'), scope('int_matmul'): int8 x int8 "
                   "as float64 matmuls, exact below 2^53)")

    def check(self, prog):
        out = []
        quant = frozenset(prog.quantize_scopes)
        for site in prog.trace:
            for o in site.outputs:
                if o.dtype == torch.float64 \
                        and not site.scopes & EXACT_SCOPES:
                    out.append(self._finding(
                        prog, f"float64 output {tuple(o.shape)} of "
                        f"'{site.op}' outside an exact integer product — "
                        f"silent float64 promotion in a serving program",
                        path=site.path, primitive=site.packet))
                elif o.dtype in (torch.bfloat16, torch.float16) \
                        and site.scopes & quant:
                    where = ", ".join(sorted(site.scopes & quant))
                    out.append(self._finding(
                        prog, f"{o.dtype} output of '{site.op}' inside "
                        f"quantize scope '{where}' — quantization "
                        f"arithmetic must run in f32 or the stored (int8, "
                        f"scale) pair depends on the rounding path (the "
                        f"KV8 divergence)", path=site.path,
                        primitive=site.packet))
        return out


class ShardingIntegrity(Rule):
    """No silent full replication of large arrays under a mesh."""
    name = "sharding-integrity"
    requires = "arrays"
    description = ("under a multi-device mesh, large arrays a program "
                   "materialised (KV caches) must not be fully replicated "
                   "(DTensor placements all Replicate)")
    min_bytes: int = 1024

    def check(self, prog):
        mesh = prog.mesh
        size = mesh.size() if mesh is not None else 1
        if size <= 1:
            return []        # nothing to shard over
        out = []
        for label, tree in (prog.arrays or {}).items():
            for path, leaf in named_tensors(tree).items():
                placements = getattr(leaf, "placements", None)
                nbytes = leaf.numel() * leaf.element_size()
                if placements is None or nbytes < self.min_bytes:
                    continue
                if all(p.is_replicate() for p in placements):
                    where = f"{label}.{path}"
                    out.append(self._finding(
                        prog, f"array '{where}' {tuple(leaf.shape)} "
                        f"({nbytes} bytes) is fully replicated on a "
                        f"{size}-device mesh — a dropped sharding "
                        f"multiplies memory and wastes every device but "
                        f"one", path=where))
        return out


for _r in (NoHostCallback(), GatherOnlyLevels(), StaticShapes(),
           KvDonation(), DtypePurity(), ShardingIntegrity()):
    register_rule(_r)
del _r
