"""Finding allowlist: known violations are explicit, new ones fail (port
of ``repro.analysis.baseline``, the same file format).

A baseline file is plain text, one :meth:`Finding.key` per line
(``rule::backend::program::primitive``), ``#`` comments and blank lines
ignored. The repo's serving programs currently lint clean, so no baseline
ships; the machinery exists so a future *deliberate* violation (say, a
transitional scatter while a kernel lands) is recorded in-tree and
reviewed, instead of the rule being switched off.

``python -m repro_torch.analysis.lint --write-baseline FILE`` snapshots the
current findings; ``--baseline FILE`` applies one.
"""
from __future__ import annotations

import os
from typing import Iterable

from repro_torch.analysis.rules import Finding

__all__ = ["load_baseline", "save_baseline", "split_baselined",
           "stale_keys"]


def load_baseline(path: str | os.PathLike | None) -> frozenset[str]:
    """Keys from a baseline file; empty set for ``None`` / missing file."""
    if path is None:
        return frozenset()
    if not os.path.exists(path):
        raise FileNotFoundError(f"baseline file {path!r} does not exist "
                                f"(write one with --write-baseline)")
    keys = set()
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                keys.add(line)
    return frozenset(keys)


def save_baseline(path: str | os.PathLike,
                  findings: Iterable[Finding]) -> int:
    """Write the de-duplicated keys of ``findings``; returns the count."""
    keys = sorted({f.key() for f in findings})
    with open(path, "w") as f:
        f.write("# tracelint baseline — one Finding.key per line\n"
                "# (rule::backend::program::primitive); delete a line to "
                "re-arm the rule\n")
        for k in keys:
            f.write(k + "\n")
    return len(keys)


def stale_keys(baseline: Iterable[str],
               findings: Iterable[Finding]) -> list[str]:
    """Baseline entries that no current finding matches.

    A stale entry is dead weight with teeth: the violation it allowed
    was fixed, but the line would silently re-allow a *recurrence*.
    ``lint --prune-baseline`` reports these (and with ``--write-baseline``
    removes them) so the allowlist can't rot."""
    live = {f.key() for f in findings}
    return sorted(k for k in frozenset(baseline) if k not in live)


def split_baselined(findings: Iterable[Finding],
                    baseline: frozenset[str] | Iterable[str]
                    ) -> tuple[list[Finding], list[Finding]]:
    """(new, suppressed) partition of ``findings`` against ``baseline``."""
    baseline = frozenset(baseline)
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.key() in baseline else new).append(f)
    return new, suppressed
