"""Static cost certifier: budget every serving program without a timer
(port of ``repro.analysis.costcheck``).

If the execution schedule is a pure function of the input signature, so
is its *cost*. This module derives per-program cost metrics from the op
trace (gather counts and bytes, scatters inside loops, the host reads
and value-dependent shapes, peak live bytes, KV-pool read traffic) and
from the plan IR itself (level / edge / gather counts), cross-checks the
plan-derived op counts against the analytical cost model
(``core/costmodel.py`` / ``core/patterns.py``: the two must be the same
arithmetic), and enforces declarative budgets from
``analysis/budgets.json``. A budget violation is an ordinary
:class:`~repro_torch.analysis.rules.Finding` (rule ``cost-budget``), so
it baselines, reports and fails the lint exactly like a tracelint
finding.

:class:`CostMetrics` keeps the reference's field names, read off the op
trace: an op in a loop is recorded each time it runs, so every
``*_dynamic`` field equals its count; eager torch has no ``cond``, so
every ``*_unguarded`` field equals its guarded one; ``while_loops``
counts the data-dependent control points of eager code (host reads and
value-dependent shapes); the pool fields count gathers whose source
shares a storage with a KV pool leaf (storage identity takes the place
of the reference's view-tracking walk); ``peak_live_bytes`` comes from
the storages' lifetimes in the call.

The two headline budgets:

* ``live-page-decode`` — the paged-attention decode's pool read traffic
  is O(live pages), not O(max_len): the program is built at ``max_len``
  and ``2 * max_len`` and the bytes gathered from the pool must not
  grow. The oracle paged decode, which gathers the whole page table each
  step, fails this budget by construction. B2's own reads are a kernel
  site the trace cannot look into: where the program has one, the budget
  is reported ``held_by`` and not evaluated, and ``chip_smoke.py`` phase
  21c holds it by behaviour (every page no slot names poisoned, the
  output unchanged).
* ``swap-trace-count`` — a pad-aligned hot swap keeps the packed
  decode's signature (``ServeEngine.stats()["decode_signatures"] == 1``
  across the swap); a widened swap demonstrably fails it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from repro_torch.analysis.rules import Finding
from repro_torch.analysis.walker import (GATHER_OPS, SCATTER_OPS, OpTrace,
                                         host_sync, is_dynamic_shape,
                                         named_tensors)

__all__ = ["CostMetrics", "trace_cost", "plan_cost", "crosscheck_costmodel",
           "load_budgets", "program_metrics", "pool_kernel_reads",
           "growth_ratio", "swap_trace_count", "check_budgets", "NotBuilt",
           "DEFAULT_BUDGETS"]

DEFAULT_BUDGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "budgets.json")
_BUDGET_FORMAT = 1


@dataclasses.dataclass
class CostMetrics:
    """Signature-determined costs of one recorded call."""
    eqns: int = 0
    eqns_dynamic: float = 0.0
    gathers: int = 0
    gathers_dynamic: float = 0.0
    gather_bytes: float = 0.0
    gather_bytes_unguarded: float = 0.0
    pool_gathers: int = 0
    pool_gather_bytes: float = 0.0
    pool_gather_bytes_unguarded: float = 0.0
    scatters: int = 0
    scatter_in_loop: int = 0
    scatter_in_loop_dynamic: float = 0.0
    while_loops: int = 0
    peak_live_bytes: int = 0

    def to_json(self) -> dict[str, float]:
        return {k: (round(v, 1) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


def _peak_live_bytes(trace: OpTrace) -> int:
    """Peak sum of live storage bytes over the call.

    A storage is live from the op that allocates it (or from the start,
    for an argument) to its last use (the end, for the result's). An op
    output whose storage is none of the op's inputs' is a fresh
    allocation, even at an address a freed storage had; a kernel site
    writes its outputs in place."""
    version: dict[int, int] = {}
    size: dict[tuple, int] = {}

    def key(ptr):
        return (ptr, version.get(ptr, 0))
    live = set()
    for a in trace.args:
        if a.storage:
            live.add(key(a.storage))
            size[key(a.storage)] = a.storage_nbytes
    events, last = [], {}
    for i, site in enumerate(trace.sites):
        ins = {x.storage for x in site.inputs if x.storage}
        used, new = {key(p) for p in ins}, []
        for o in site.outputs:
            if not o.storage:
                continue
            if o.storage not in ins and not site.is_kernel:
                version[o.storage] = version.get(o.storage, 0) + 1
                size[key(o.storage)] = o.storage_nbytes
                new.append(key(o.storage))
            used.add(key(o.storage))
        for k in used:
            last[k] = i
        events.append((new, used))
    end = len(trace.sites)
    for t in named_tensors(trace.result).values():
        try:
            last[key(t.untyped_storage().data_ptr())] = end
        except (RuntimeError, NotImplementedError):
            pass
    cur = peak = sum(size[k] for k in live)
    for i, (new, used) in enumerate(events):
        for k in new:
            if k not in live:
                live.add(k)
                cur += size[k]
        peak = max(peak, cur)
        for k in used:
            if k in live and last.get(k, end) <= i:
                live.discard(k)
                cur -= size.get(k, 0)
    return int(peak)


def trace_cost(trace: OpTrace, *,
               pool: frozenset[int] = frozenset()) -> CostMetrics:
    """Derive :class:`CostMetrics` from an op trace. ``pool`` names the KV
    pool's storages: gathers from them fill the ``pool_*`` fields."""
    acc = CostMetrics()
    for site in trace:
        acc.eqns += 1
        if site.is_in(GATHER_OPS):
            nbytes = sum(o.nbytes for o in site.outputs)
            acc.gathers += 1
            acc.gather_bytes += nbytes
            if site.inputs and site.inputs[0].storage in pool:
                acc.pool_gathers += 1
                acc.pool_gather_bytes += nbytes
        if site.is_in(SCATTER_OPS):
            acc.scatters += 1
            if site.in_loop:
                acc.scatter_in_loop += 1
        if host_sync(site) is not None or is_dynamic_shape(site):
            acc.while_loops += 1
    acc.eqns_dynamic = float(acc.eqns)
    acc.gathers_dynamic = float(acc.gathers)
    acc.gather_bytes_unguarded = acc.gather_bytes
    acc.pool_gather_bytes_unguarded = acc.pool_gather_bytes
    acc.scatter_in_loop_dynamic = float(acc.scatter_in_loop)
    acc.peak_live_bytes = _peak_live_bytes(trace)
    return acc


def _pool_storages(prog: Any) -> frozenset[int]:
    """The storages of a program's ``donate_expect`` leaves: its pool."""
    return frozenset(t.untyped_storage().data_ptr()
                     for leaves in (prog.donate_expect or {}).values()
                     for t in leaves.values())


def program_metrics(prog: Any) -> CostMetrics:
    """Metrics for one :class:`~repro_torch.analysis.rules.LintProgram`;
    the pool is the storages of its ``donate_expect`` leaves."""
    return trace_cost(prog.trace, pool=_pool_storages(prog))


def pool_kernel_reads(prog: Any) -> list[str]:
    """The kernel sites (``kernel:B2``) that take a pool leaf as input:
    pool reads the ``pool_*`` fields cannot count."""
    pool = _pool_storages(prog)
    return sorted({s.packet for s in prog.trace if s.is_kernel
                   and any(i.storage in pool for i in s.inputs)})


# ---------------------------------------------------------------------------
# Plan-IR costs + cost-model cross-check
# ---------------------------------------------------------------------------

def plan_cost(plan: Any) -> dict[str, int]:
    """Per-call costs read straight off the plan IR (host side)."""
    t, size = int(plan.t), 1 << int(plan.t)
    j = plan.k // plan.t
    r = j * size
    s, n = int(plan.bits), int(plan.n)
    step_edges = sum(int(np.asarray(st.tile).size) for st in plan.steps)
    direct_adds = int(np.asarray(plan.direct_bits).sum())
    return {
        "levels": len(plan.steps),
        "psum_rows": r,
        "step_edges": step_edges,
        "direct_lanes": int(np.asarray(plan.direct_tile).size),
        "direct_adds": direct_adds,
        "ppe_adds": step_edges + direct_adds,
        # each level is two whole-table gathers (psum + activation)
        "level_gather_rows": 2 * t * r,
        "ape_gather_rows": s * n * j,
    }


def crosscheck_costmodel(plan: Any, *, backend: str | None = None,
                         name: str = "plan") -> list[Finding]:
    """The plan IR and the analytical cost model must count the same ops.

    ``core/patterns.py``'s :func:`tile_stats` (which feeds
    ``core/costmodel.py``'s TransitiveArrayModel via the scoreboard) and
    the executable schedule are two derivations of the same quantities:

    * ``ppe_ops`` (prefix-chain adds) == schedule step edges + direct
      subset-sum adds;
    * ``ape_ops`` (output accumulations) == nonzero TransRows
      == S*N*J - zero rows.

    Disagreement means the cost model budgets a machine the kernels don't
    run — an error finding, not a warning.
    """
    from repro_torch.core.patterns import tile_stats
    ts = tile_stats(plan.si)
    pc = plan_cost(plan)
    out: list[Finding] = []
    ppe_model = int(np.asarray(ts.ppe_ops).sum())
    if ppe_model != pc["ppe_adds"]:
        out.append(Finding(
            rule="cost-model-agreement", severity="error", program=name,
            backend=backend, path="ppe_ops", primitive="ppe_ops",
            message=f"cost model counts {ppe_model} PPE adds but the "
            f"schedule executes {pc['ppe_adds']} ({pc['step_edges']} "
            f"step edges + {pc['direct_adds']} direct adds) — the "
            f"analytical model and the plan IR have diverged"))
        return out
    ape_model = int(np.asarray(ts.ape_ops).sum())
    s, n = int(plan.bits), int(plan.n)
    j = plan.k // plan.t
    zr = int(np.asarray(ts.zr).sum())
    if ape_model != s * n * j - zr or ape_model > s * n * j:
        out.append(Finding(
            rule="cost-model-agreement", severity="error", program=name,
            backend=backend, path="ape_ops", primitive="ape_ops",
            message=f"cost model counts {ape_model} APE accumulations "
            f"but the plan implies {s * n * j - zr} nonzero TransRows "
            f"(S*N*J={s * n * j}, zero rows={zr})"))
    return out


# ---------------------------------------------------------------------------
# Declarative budgets
# ---------------------------------------------------------------------------

def load_budgets(path: str | os.PathLike | None = None) -> dict[str, Any]:
    """Load and validate the budgets file (default: the in-tree one)."""
    path = DEFAULT_BUDGETS if path is None else path
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("format") != _BUDGET_FORMAT:
        raise ValueError(f"{path}: not a format-{_BUDGET_FORMAT} budgets "
                         f"file (got format={data.get('format')!r})")
    for i, b in enumerate(data.get("budgets", [])):
        missing = [k for k in ("name", "program", "metric", "max")
                   if k not in b]
        if missing:
            raise ValueError(f"{path}: budgets[{i}] is missing {missing}")
    return data


class NotBuilt(LookupError):
    """The backend builds no such program here (the message says why)."""


def _program(backend: str, program: str, **kw):
    """The one program ``program`` of ``backend``, or :class:`NotBuilt`."""
    from repro_torch.analysis.programs import build_programs
    progs = {p.name: p for p in build_programs(backend, programs=(program,),
                                               **kw)}
    if program not in progs:
        raise NotBuilt("backend builds no such program")
    if progs[program].skipped:
        raise NotBuilt(progs[program].skipped)
    return progs[program]


def _growth(backend: str, program: str, metric: str, *, device=None,
            mesh: Any = None, arch: str = "smollm-135m",
            scales: tuple[int, int] = (16, 32)
            ) -> tuple[float, dict[str, float], list[str]]:
    """:func:`growth_ratio`, plus the kernel sites that read the pool in
    either build (:func:`pool_kernel_reads`)."""
    values, kernels = {}, set()
    for ml in scales:
        prog = _program(backend, program, device=device, mesh=mesh,
                        arch=arch, max_len=ml)
        values[f"max_len={ml}"] = float(getattr(program_metrics(prog),
                                                metric))
        kernels.update(pool_kernel_reads(prog))
    lo, hi = (values[f"max_len={s}"] for s in scales)
    return (hi + 1.0) / (lo + 1.0), values, sorted(kernels)


def growth_ratio(backend: str, program: str, metric: str, *, device=None,
                 mesh: Any = None, arch: str = "smollm-135m",
                 scales: tuple[int, int] = (16, 32)
                 ) -> tuple[float, dict[str, float]]:
    """Build ``program`` at two ``max_len`` scales; ratio of ``metric``.

    The +1 regularisation keeps a 0 -> 0 metric at ratio 1.0 instead of
    0/0. Raises :class:`NotBuilt` where the backend builds no such
    program here.
    """
    ratio, values, _ = _growth(backend, program, metric, device=device,
                               mesh=mesh, arch=arch, scales=scales)
    return ratio, values


def swap_trace_count(*, backend: str = "engine_torch", device=None,
                     arch: str = "smollm-135m", aligned: bool = True,
                     mesh: Any = None) -> int:
    """Packed-decode signatures across one hot swap (the scenario behind
    the ``swap-trace-count`` budget).

    Builds two weight generations, serves a request on generation 0,
    stages a swap, drains a generation-1 request, and reads the engine's
    ``decode_signatures``. ``aligned=False`` deliberately widens the new
    generation's DevicePlans (the drift ``align_device_plans`` exists to
    prevent) — the hand-broken twin that must push the count to 2.
    """
    if mesh is not None:
        raise NotImplementedError(
            "swap_trace_count(mesh=): multi-device serving is not ported; "
            "it waits for ROADMAP item A10")
    from repro_torch.configs import get_reduced
    from repro_torch.core.engine import pad_device_plan
    from repro_torch.core.plancache import PlanCache
    from repro_torch.device import resolve_device
    from repro_torch.fleet import build_generation
    from repro_torch.fleet.replan import _walk_dplans
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    dev = resolve_device(device)
    cfg = serve_config(get_reduced(arch).replace(n_layers=2),
                       backend=backend)
    model = Model(cfg, device=dev)
    cache = PlanCache()
    gen0 = build_generation(model, model.init(0), gen=0, cache=cache)
    gen1 = build_generation(model, model.init(1234), ref=gen0.params,
                            gen=1, cache=cache)
    p1 = gen1.params
    if not aligned:
        p1 = _walk_dplans(p1, None, lambda d, _: pad_device_plan(
            d, int(d.direct_idx.shape[-1]) + 4))
    eng = ServeEngine(model, gen0.params, n_slots=2, max_len=16,
                      page_size=4, device=dev)
    prompt = tuple(range(1, 9))
    eng.submit(prompt, 4)
    eng.step()
    eng.step()
    eng.swap_params(p1, tag="costcheck")
    eng.submit(prompt, 4)
    while eng.queue or eng.active:
        eng.step()
    return int(eng.stats()["decode_signatures"])


def check_budgets(backend_names: list[str], *, device=None, mesh: Any = None,
                  budgets_path: str | os.PathLike | None = None,
                  arch: str = "smollm-135m"
                  ) -> tuple[list[dict], list[Finding]]:
    """Evaluate every budget against every applicable backend.

    A budget applies to a backend when the budget's ``backend`` key
    matches (or is absent) and the backend builds the budget's program;
    inapplicable combinations are reported as skips, never findings.
    A pool-traffic budget over a program whose pool reads are a kernel
    site (B2's) is reported ``held_by`` that kernel's behavioural check,
    not evaluated. Returns (report rows with the measured values,
    findings) — a finding per exceeded budget, rule ``cost-budget``.
    """
    budgets = load_budgets(budgets_path)["budgets"]
    report: list[dict] = []
    findings: list[Finding] = []
    kw = dict(device=device, mesh=mesh, arch=arch)

    for b in budgets:
        for bname in backend_names:
            row = {"budget": b["name"], "backend": bname,
                   "program": b["program"], "metric": b["metric"],
                   "max": b["max"]}
            if b.get("backend") is not None and b["backend"] != bname:
                row["skipped"] = f"budget pinned to {b['backend']}"
                report.append(row)
                continue
            metric = b["metric"]
            try:
                if metric == "decode_jit_traces":
                    _program(bname, b["program"], **kw)
                    value = float(swap_trace_count(
                        backend=bname, arch=arch, device=device, mesh=mesh,
                        aligned=bool(b.get("aligned", True))))
                elif metric.endswith("_growth"):
                    value, row["values"], kernels = _growth(
                        bname, b["program"], metric[:-len("_growth")], **kw)
                    if kernels and metric.startswith("pool_"):
                        # the pool reads are inside a kernel the trace
                        # cannot look into: no evaluation, no finding
                        row["held_by"] = (
                            f"kernel site {', '.join(kernels)} reads the "
                            f"pool: held by behaviour (chip_smoke.py phase "
                            f"21c), not by the trace")
                        report.append(row)
                        continue
                else:
                    m = program_metrics(_program(bname, b["program"], **kw))
                    if not hasattr(m, metric):
                        raise ValueError(
                            f"budget {b['name']!r}: unknown metric "
                            f"{metric!r} (not a CostMetrics field)")
                    value = float(getattr(m, metric))
            except NotBuilt as e:
                row["skipped"] = str(e)
                report.append(row)
                continue
            row["value"] = value
            row["ok"] = value <= float(b["max"])
            report.append(row)
            if not row["ok"]:
                findings.append(Finding(
                    rule="cost-budget", severity="error",
                    program=b["program"], backend=bname,
                    path=metric, primitive=b["name"],
                    message=f"budget '{b['name']}' exceeded: {metric} = "
                    f"{value:g} > max {b['max']:g}"
                    + (f" — {b['note']}" if b.get("note") else "")))
    return report, findings
