"""Tracelint CLI — the serving-invariant gate (port of
``repro.analysis.lint``).

  PYTHONPATH=src python -m repro_torch.analysis.lint \\
      [--backend engine_cuda ...] [--device cuda|cpu] [--full-width] \\
      [--rules r1,r2] [--plans] [--budgets [FILE]] [--prune-baseline] \\
      [--baseline FILE | --write-baseline FILE] [--json OUT] [--list-rules]

Builds every registered backend's serving programs (prefill, dense
decode, paged decode and its hot-swapped twin, the B2 kernel's decode,
bucketed prefill, the forest — ``analysis/programs.py``) on ``--device``
(``cuda`` unless asked otherwise) and runs every registered rule against
their op traces, honoring each backend's ``lint_exempt`` tags. Default
backend set: every ``cpu_ok`` backend. ``--full-width`` builds them at
the arch's published widths (2 layers) instead of its reduced ones.

``--plans`` additionally verifies the plan IR (``planlint.py``) and
``--budgets`` enforces the static cost budgets (``costcheck.py`` +
``budgets.json``); both streams merge into the same findings, baseline
and exit code. ``--prune-baseline`` reports baseline entries no current
finding matches (add ``--write-baseline`` to rewrite the file without
them). ``--mesh`` (multi-device lint) waits for ROADMAP item A10 and
exits 2.

Exit status 1 iff any non-baselined error-severity finding remains;
``--json`` writes the full findings list.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

from repro_torch.analysis.baseline import (load_baseline, save_baseline,
                                           split_baselined, stale_keys)
from repro_torch.analysis.programs import lint_backend
from repro_torch.analysis.rules import get_rule, list_rules
from repro_torch.core.backend import get_backend, list_backends


def _cpu_ok_backends() -> list[str]:
    return [n for n in list_backends() if get_backend(n).cpu_ok]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static-analysis gate over every backend's serving "
                    "programs (rule catalog: repro_torch.analysis.rules)")
    ap.add_argument("--backend", action="append", default=None,
                    choices=list_backends(), metavar="NAME",
                    help="lint this backend (repeatable; default: every "
                    "cpu_ok backend in the registry)")
    ap.add_argument("--device", default="cuda",
                    help="where the programs run (default cuda; cpu runs "
                    "the kernels' plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="build the programs at the arch's published "
                    "widths (2 layers) instead of its reduced ones")
    ap.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N]",
                    help="lint under a device mesh (waits for ROADMAP A10)")
    ap.add_argument("--rules", default=None, metavar="R1,R2",
                    help="restrict to a comma-separated rule subset")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--plans", action="store_true",
                    help="also verify the plan IR (ExecutionPlan / "
                    "DevicePlan / ForestPlan / bundle round-trip) per "
                    "backend")
    ap.add_argument("--budgets", nargs="?", const=True, default=None,
                    metavar="FILE",
                    help="also enforce static cost budgets (default "
                    "budget file: analysis/budgets.json)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="report baseline entries matching no current "
                    "finding; with --write-baseline, drop them")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="allowlist of known findings (Finding.key lines); "
                    "baselined findings report but do not fail")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="snapshot current findings as a baseline and exit "
                    "0")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write the findings report as JSON")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in list_rules():
            r = get_rule(name)
            print(f"{name:22s} [{r.severity}] ({r.requires}) "
                  f"{r.description}")
        return 0
    if args.mesh:
        ap.error("--mesh: multi-device lint is not ported; it waits for "
                 "ROADMAP item A10")

    only = tuple(args.rules.split(",")) if args.rules else None
    if only:
        for r in only:
            get_rule(r)                     # loud unknown-rule error
    baseline = load_baseline(args.baseline)
    backends = args.backend or _cpu_ok_backends()

    all_findings, report, why_skipped = [], [], {}
    t0 = time.time()
    for name in backends:
        t1 = time.time()
        progs, findings = lint_backend(
            name, device=args.device, only=only, batch=args.batch,
            arch=args.arch, reduced=not args.full_width)
        dt = time.time() - t1
        all_findings.extend(findings)
        exempt = sorted(get_backend(name).lint_exempt)
        skipped = {p.name: p.skipped for p in progs if p.skipped}
        report.append({
            "backend": name,
            "programs": [p.name for p in progs],
            "skipped": skipped,
            "kernel_sites": {p.name: dict(Counter(s.op for s in p.trace
                                                  if s.is_kernel))
                             for p in progs if p.trace is not None},
            "lint_exempt": exempt,
            "findings": [f.to_json() for f in findings],
            "seconds": round(dt, 2),
        })
        why_skipped |= skipped
        status = (f"{len(findings)} finding(s)" if findings else "clean")
        ex = f" (exempt: {', '.join(exempt)})" if exempt else ""
        sk = f", skipped {', '.join(skipped)}" if skipped else ""
        print(f"[tracelint] {name:14s} {len(progs) - len(skipped)} programs "
              f"on {args.device}{sk} -> {status}{ex} ({dt:.1f}s)")
        for f in findings:
            print(f"  {f.format()}")
    for prog, why in why_skipped.items():
        print(f"[tracelint] {prog} skipped: {why}")

    plans_report = budget_report = None
    if args.plans:
        from repro_torch.analysis.planlint import lint_plans
        plans_report, pfindings = lint_plans(backends, device=args.device)
        all_findings.extend(pfindings)
        status = (f"{len(pfindings)} finding(s)" if pfindings
                  else "clean")
        print(f"[planlint]  {len(plans_report)} artifact batch(es) -> "
              f"{status}")
        for f in pfindings:
            print(f"  {f.format()}")
    if args.budgets is not None:
        from repro_torch.analysis.costcheck import check_budgets
        bpath = None if args.budgets is True else args.budgets
        budget_report, bfindings = check_budgets(
            backends, device=args.device, budgets_path=bpath, arch=args.arch)
        all_findings.extend(bfindings)
        n_eval = sum(1 for r in budget_report if "value" in r)
        print(f"[costcheck] {n_eval} budget evaluation(s) -> "
              f"{len(bfindings) if bfindings else 'clean'}"
              f"{' finding(s)' if bfindings else ''}")
        for r in budget_report:
            if "value" in r:
                print(f"  {r['budget']} {r['backend']}: {r['metric']} = "
                      f"{r['value']:g} (max {r['max']:g})")
            elif "held_by" in r:
                print(f"  {r['budget']} {r['backend']}: not evaluated, "
                      f"{r['held_by']}")
        for f in bfindings:
            print(f"  {f.format()}")

    if args.prune_baseline:
        stale = stale_keys(baseline, all_findings)
        for k in stale:
            print(f"[baseline] stale: {k}")
        print(f"[baseline] {len(stale)} stale entr"
              f"{'y' if len(stale) == 1 else 'ies'} of {len(baseline)}")
        if args.write_baseline:
            kept = sorted(frozenset(baseline) - set(stale))
            with open(args.write_baseline, "w") as f:
                f.write("# tracelint baseline — one Finding.key per "
                        "line\n")
                for k in kept:
                    f.write(k + "\n")
            print(f"[baseline] wrote {len(kept)} key(s) to "
                  f"{args.write_baseline}")
            return 0
    elif args.write_baseline:
        n = save_baseline(args.write_baseline, all_findings)
        print(f"[tracelint] wrote {n} baseline key(s) to "
              f"{args.write_baseline}")
        return 0

    new, suppressed = split_baselined(all_findings, baseline)
    failing = [f for f in new if f.severity == "error"]
    dt = time.time() - t0
    summary = {
        "backends": backends,
        "device": args.device,
        "full_width": args.full_width,
        "rules": list(only) if only else list(list_rules()),
        "findings": len(all_findings),
        "baselined": len(suppressed),
        "failing": len(failing),
        "seconds": round(dt, 2),
    }
    if args.json:
        doc = {"summary": summary, "backends": report}
        if plans_report is not None:
            doc["plans"] = plans_report
        if budget_report is not None:
            doc["budgets"] = budget_report
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
    print(f"[tracelint] {len(backends)} backend(s) on {args.device}: "
          f"{len(all_findings)} finding(s), {len(suppressed)} baselined, "
          f"{len(failing)} failing ({dt:.1f}s)")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
