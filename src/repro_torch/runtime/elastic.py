"""Elastic mesh sizing: pick the best grid for however many devices survive.

Port of ``repro/runtime/elastic.py`` (pure Python, copied).  When a job
loses devices it restarts on the remaining count; :func:`choose_mesh_shape`
picks the closest-to-square (data, model) factorization subject to
divisibility constraints (the model axis must divide heads/experts), and
:func:`choose_grid_shape` the largest square matmul grid that fits.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

__all__ = ["choose_mesh_shape", "choose_grid_shape"]


def choose_mesh_shape(n_chips: int, *, model_divisors: Tuple[int, ...] = (),
                      max_model: int = 64,
                      prefer_model: Optional[int] = None) -> Tuple[int, int]:
    """Return (data, model) with data*model == usable_chips (largest usable).

    ``model_divisors``: the model axis must divide all of these (heads,
    kv-heads, experts...).  Prefers the largest model axis <= max_model that
    satisfies constraints, then the squarest data split.
    """
    def ok_model(m: int) -> bool:
        if m > max_model:
            return False
        return all(d % m == 0 for d in model_divisors if d)

    best = None  # (model, use)
    # allow shaving chips (failed nodes) down to 87.5% utilization; scan
    # the whole shave range — a slightly smaller chip count often admits
    # a much larger model axis (e.g. 250 chips force model<=2, 248 allow 8)
    for use in range(n_chips, max(1, int(n_chips * 0.875)) - 1, -1):
        cands = [m for m in range(1, use + 1) if use % m == 0 and ok_model(m)]
        if not cands:
            continue
        if prefer_model and prefer_model in cands:
            return (use // prefer_model, prefer_model)
        m = max(cands)
        if best is None or m > best[0]:
            best = (m, use)
    if best is None:
        raise ValueError(f"no usable mesh for {n_chips} chips "
                         f"with divisors {model_divisors}")
    m, use = best
    return (use // m, m)


def choose_grid_shape(survivors: Union[int, Iterable[int]], *,
                      max_g: Optional[int] = None) -> int:
    """Largest ``g`` such that a g x g matmul grid fits on the survivors.

    The sparse engine's schedules (SUMMA / rings / steal3d) all run on a
    square ``g x g`` mesh, so after device loss the recovery grid is the
    largest square that fits the surviving device count.  ``survivors``
    is either a count or the surviving device-id collection (what
    :class:`repro_torch.runtime.faultinject.DeviceLoss` yields); ``max_g``
    optionally caps the result (e.g. at the pre-loss grid size).
    """
    n = survivors if isinstance(survivors, int) else len(tuple(survivors))
    if n < 1:
        raise ValueError(f"need at least one surviving device, got {n}")
    g = int(n ** 0.5)
    while (g + 1) * (g + 1) <= n:   # int(sqrt) can round down under fp error
        g += 1
    while g * g > n:
        g -= 1
    if max_g is not None:
        g = min(g, max_g)
    return max(g, 1)
