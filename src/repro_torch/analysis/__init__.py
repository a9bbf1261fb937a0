"""Static analysis of the port's plan artifacts (port of
``repro.analysis``, its plan half).

:mod:`repro_torch.analysis.planlint` verifies ExecutionPlans, their
DevicePlan lowerings, the compact ForestPlan / SparseForestPlan the CUDA
forest kernels run, and the fleet's plan bundles, and gates them where a
plan crosses a trust boundary (cache publish and lowering, bundle load,
swap staging). The program half (tracelint), the cost checks and the
lint CLI wait for ROADMAP item A6.2.
"""
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
from repro_torch.analysis.rules import Finding

__all__ = ["Finding", "PlanArtifact", "PlanRule", "PlanVerificationError",
           "enabled", "gate_bundle_file", "gate_device", "gate_manifest",
           "gate_params", "gate_plan", "get_plan_rule", "iter_device_plans",
           "lint_plans", "list_plan_rules", "register_plan_rule",
           "unregister_plan_rule", "verify_bundle_file",
           "verify_device_plan", "verify_manifest", "verify_plan"]
