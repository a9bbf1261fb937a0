"""Static analysis of the port's serving programs and plan artifacts
(port of ``repro.analysis``).

Two halves, as in the reference:

* the program half (tracelint): :mod:`~repro_torch.analysis.walker`
  records one call of a serving program as an op trace (the aten ops the
  dispatcher runs and the CUDA kernel launches, with their scopes, loop
  membership, shapes, dtypes and storages: the port's counterpart of a
  jaxpr), :mod:`~repro_torch.analysis.rules` holds the invariants as
  registered rules (the rule catalog is in its docstring),
  :mod:`~repro_torch.analysis.programs` builds every backend's serving
  programs, :mod:`~repro_torch.analysis.costcheck` derives cost metrics
  from the traces and plans and enforces ``budgets.json``, and
  :mod:`~repro_torch.analysis.baseline` keeps the allowlist;
* the plan half: :mod:`~repro_torch.analysis.planlint` verifies
  ExecutionPlans, their DevicePlan lowerings, the compact ForestPlan /
  SparseForestPlan the CUDA forest kernels run and the fleet's plan
  bundles, and gates them where a plan crosses a trust boundary (cache
  publish and lowering, bundle load, swap staging).

Entry points:

* :func:`assert_clean` — record, lint, raise with the offending op and
  its path in the trace;
* :func:`find_violations` — the same, returning the findings;
* ``python -m repro_torch.analysis.lint`` — every backend's programs,
  all rules, the plan verifier (``--plans``), the budgets
  (``--budgets``), the baseline, a JSON report.

The model, engine and kernel code reach the recorder only through
:mod:`repro_torch.tracepoints` (``scope``, ``note_launch``), which sits
below them; this package sits above them and imports them.
"""
from __future__ import annotations

from repro_torch.analysis.baseline import (load_baseline, save_baseline,
                                           split_baselined, stale_keys)
from repro_torch.analysis.costcheck import (CostMetrics, check_budgets,
                                            crosscheck_costmodel,
                                            growth_ratio, load_budgets,
                                            plan_cost, program_metrics,
                                            swap_trace_count, trace_cost)
from repro_torch.analysis.planlint import (PlanArtifact, PlanRule,
                                           PlanVerificationError, enabled,
                                           gate_bundle_file, gate_device,
                                           gate_manifest, gate_params,
                                           gate_plan, get_plan_rule,
                                           iter_device_plans, lint_plans,
                                           list_plan_rules,
                                           register_plan_rule,
                                           unregister_plan_rule,
                                           verify_bundle_file,
                                           verify_device_plan,
                                           verify_manifest, verify_plan)
from repro_torch.analysis.programs import (PROGRAM_RULES, build_programs,
                                           lint_backend)
from repro_torch.analysis.rules import (Finding, LintProgram, Rule,
                                        get_rule, list_rules, register_rule,
                                        run_rules, unregister_rule)
from repro_torch.analysis.walker import (DYNAMIC_SHAPE_OPS, GATHER_OPS,
                                         SCATTER_OPS, SYNC_OPS, OpSite,
                                         OpTrace, note_launch, record, scope)

__all__ = ["Finding", "LintProgram", "Rule", "OpSite", "OpTrace", "record",
           "scope", "note_launch", "register_rule", "unregister_rule",
           "get_rule", "list_rules", "run_rules", "load_baseline",
           "save_baseline", "split_baselined", "stale_keys",
           "find_violations", "assert_clean", "DEFAULT_RULES", "SYNC_OPS",
           "SCATTER_OPS", "DYNAMIC_SHAPE_OPS", "GATHER_OPS",
           # plan verifier (planlint.py)
           "PlanArtifact", "PlanRule", "PlanVerificationError", "enabled",
           "gate_bundle_file", "gate_device", "gate_manifest", "gate_params",
           "gate_plan", "get_plan_rule", "iter_device_plans", "lint_plans",
           "list_plan_rules", "register_plan_rule", "unregister_plan_rule",
           "verify_bundle_file", "verify_device_plan", "verify_manifest",
           "verify_plan",
           # programs (programs.py)
           "PROGRAM_RULES", "build_programs", "lint_backend",
           # static cost certifier (costcheck.py)
           "CostMetrics", "trace_cost", "plan_cost", "program_metrics",
           "crosscheck_costmodel", "load_budgets", "check_budgets",
           "growth_ratio", "swap_trace_count"]

# the structural rules assert_clean runs when the caller names none (true
# of every serving program; gather-only-levels is not here — model
# programs legally scatter KV writes, so it guards forest programs and
# must be requested: rules=(*DEFAULT_RULES, "gather-only-levels"))
DEFAULT_RULES = ("no-host-callback", "static-shapes")


def find_violations(fn, *args, rules: tuple[str, ...] = DEFAULT_RULES,
                    name: str = "program", backend: str | None = None,
                    quantize_scopes: tuple[str, ...] = ("quantize_kv",),
                    **program_kw) -> list[Finding]:
    """Record ``fn(*args)`` (or take a ready :class:`OpTrace`) and run the
    named rules; returns the findings.

    ``program_kw`` forwards extra :class:`LintProgram` evidence
    (``retrace=``, ``donate_expect=``, ``mesh=``, ``arrays=``) for rules
    that need more than one trace.
    """
    if isinstance(fn, OpTrace):
        if args:
            raise TypeError("passing args with an already-recorded OpTrace "
                            "makes no sense")
        trace = fn
    else:
        trace = record(fn, *args)
    prog = LintProgram(name=name, backend=backend, rules=tuple(rules),
                       trace=trace, quantize_scopes=quantize_scopes,
                       **program_kw)
    return run_rules(prog)


def assert_clean(fn, *args, rules: tuple[str, ...] = DEFAULT_RULES,
                 baseline: frozenset[str] | tuple[str, ...] = (),
                 **kw) -> None:
    """Assert ``fn(*args)``'s program violates none of ``rules``: on
    violation the AssertionError names every offending op and its path
    in the trace."""
    findings = find_violations(fn, *args, rules=rules, **kw)
    new, _ = split_baselined(findings, frozenset(baseline))
    if new:
        lines = "\n  ".join(f.format() for f in new)
        raise AssertionError(
            f"tracelint: {len(new)} violation(s) of "
            f"{', '.join(rules)}:\n  {lines}")
