"""Finding/verdict types shared by the static-analysis passes.

A finding is one rule violation: a stable machine-readable rule id, a
human-actionable message, and an optional subject (which plan / device /
permutation the violation is about).  Passes return ``List[Finding]`` —
empty means proven clean under that pass's rules — and
:class:`PlanValidationError` is how ``plan_matmul(validate=...)`` turns a
non-empty list into a refusal to hand back the plan.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis violation."""

    rule: str       # stable id, e.g. "schedule.ppermute-bijection"
    message: str    # actionable description of what is wrong + how to fix
    subject: str = ""   # what the finding is about (plan/device/step/...)

    def __str__(self) -> str:
        where = f" [{self.subject}]" if self.subject else ""
        return f"{self.rule}{where}: {self.message}"


class PlanValidationError(ValueError):
    """A communication plan failed static verification.

    Raised by ``MatmulPlan.validate`` / ``plan_matmul(validate=...)``.
    ``.findings`` holds the full list; the message leads with the rule
    ids so the failure is greppable.
    """

    def __init__(self, findings: Sequence[Finding]):
        self.findings: List[Finding] = list(findings)
        rules = sorted({f.rule for f in self.findings})
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"plan failed static verification ({len(self.findings)} "
            f"finding(s), rules {rules}):\n{lines}")
