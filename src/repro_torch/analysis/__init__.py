"""Static analysis: prove communication plans correct before they run.

Port of ``repro/analysis``.  Three passes:

* :mod:`repro_torch.analysis.schedule_check` — host-side verification
  over plan metadata (ring permutations and the tile maps composed from
  them, steal3d exactly-once + conservation, packed-wire consume-map
  contracts, sparse pair lists, balance perms, survivor coverage).
* :mod:`repro_torch.analysis.op_lint` — structural rules over the aten
  ops, kernel calls and executor shifts of one multiply (the port's
  counterpart of the JAX package's jaxpr lint), and the dispatch-mode spy
  they are recorded with.
* :mod:`repro_torch.analysis.source_rules` — the AST-level source
  hygiene registry (``python -m repro_torch.analysis.source_rules``).

Entry points: ``check_plan`` / ``lint_plan`` return ``List[Finding]``
(empty == proven clean); ``plan_matmul(validate="fast"|"full")`` runs
them at plan-build time and raises :class:`PlanValidationError` on any
finding.
"""
from .findings import Finding, PlanValidationError
from .op_lint import copy_ops, lint_plan, lint_rank_plan, record_multiply
from .schedule_check import (check_plan, check_rank_plan,
                             check_survivor_coverage)

from . import op_lint, schedule_check


def __getattr__(name):
    # source_rules is imported on first use, so that running it with
    # ``python -m`` does not find it already imported by this package
    if name == "source_rules":
        import importlib
        return importlib.import_module(f"{__name__}.source_rules")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def all_rules():
    """(rule id, description) for every registered rule, all passes."""
    from . import source_rules
    return (tuple(schedule_check.RULES) + tuple(schedule_check.RANK_RULES)
            + tuple(op_lint.RULES)
            + tuple((r.id, r.description) for r in source_rules.RULES))


__all__ = [
    "Finding", "PlanValidationError", "check_plan", "check_rank_plan",
    "lint_rank_plan",
    "check_survivor_coverage", "lint_plan", "record_multiply", "copy_ops",
    "all_rules", "op_lint", "schedule_check", "source_rules",
]
