"""Deprecated per-call wrappers (port of ``repro/core/spmm.py``).

The engine lives in :mod:`repro_torch.core.api` behind the plan-based
interface::

    a_h  = api.DistBSR.from_tiled(a_tiled)
    b_h  = api.DistDense.for_rhs(b, a_h)
    plan = api.plan_matmul(a_h, b_h, algorithm="ring_c")
    c    = plan(a_h, b_h)          # no re-planning, no re-skew on later calls

or simply ``api.matmul(a, b)``.  The free functions below stay for
compatibility: they delegate to the shared plan cache and emit a
:class:`DeprecationWarning`.
"""
from __future__ import annotations

import warnings
from typing import Optional

from . import api
from .api import validate_mesh  # noqa: F401 (compat re-export)
from .bsr import TiledBSR

__all__ = ["spmm", "spgemm", "dense_matmul", "ALGORITHMS"]

# Snapshot of the built-in registry, in registration order (legacy name).
ALGORITHMS = api.algorithms()


def _warn(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.spmm.{name} is deprecated; use "
        "repro_torch.core.api.matmul or plan_matmul",
        DeprecationWarning, stacklevel=3)


def spmm(a: TiledBSR, b, *, algorithm: str = "ring_c",
         impl: Optional[str] = None, allow_pad: bool = False, device=None):
    """Deprecated: distributed C = A @ B for block-sparse A and dense B."""
    _warn("spmm")
    return api.matmul(a, b, algorithm=algorithm, impl=impl,
                      allow_pad=allow_pad, device=device)


def spgemm(a: TiledBSR, b: TiledBSR, *, algorithm: str = "ring_c",
           impl: Optional[str] = None):
    """Deprecated: distributed C = A @ B for block-sparse A and B."""
    _warn("spgemm")
    return api.matmul(a, b, algorithm=algorithm, impl=impl)


def dense_matmul(a, b, *, g: int, algorithm: str = "ring_c", device=None):
    """Deprecated: dense-dense distributed matmul through the same engine."""
    _warn("dense_matmul")
    return api.matmul(a, b, g=g, algorithm=algorithm, device=device)
