"""The finding record the plan verifier reports (port of
``repro.analysis.rules.Finding``).

Only :class:`Finding` is here: the reference's tracelint ``Rule`` and
``LintProgram`` walk jaxprs, and the port's program half of the lint
waits for ROADMAP A6.2.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Finding"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, locatable and baselinable."""
    rule: str
    severity: str                 # "error" | "warning"
    program: str                  # "decode", "prefill", "forest", ...
    backend: str | None
    path: str                     # equation path ("" = program-level)
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
