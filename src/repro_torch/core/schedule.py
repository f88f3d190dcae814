"""Static balancing (port of part of ``repro/core/schedule.py``).

What balanced tiling and the cost model need: :func:`balance_row_perm`
spreads nonzero blocks evenly over grid rows so the uniform tile capacity
shrinks, :func:`invert_perm` undoes the permutation on the output, and
:func:`stage_imbalance` measures the ring's per-stage against end-to-end
load imbalance (``MatmulPlan.cost_model(a=...)``).  Plain numpy,
bit-identical to the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["balance_row_perm", "invert_perm", "stage_imbalance"]


def invert_perm(perm: Sequence[int]) -> np.ndarray:
    """Inverse of a permutation: ``invert_perm(p)[p[t]] == t``."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return inv


def balance_row_perm(nnz_per_row_block: Sequence[int],
                     grid_rows: int) -> np.ndarray:
    """Permute row blocks so each grid row gets a near-equal nnz share.

    Returns a permutation ``perm`` such that row block ``perm[t]`` should be
    placed at position ``t``; every grid row keeps ``n/grid_rows`` row
    blocks.
    """
    nnz = np.asarray(nnz_per_row_block, dtype=np.float64)
    n = len(nnz)
    if n % grid_rows:
        raise ValueError("row blocks must divide evenly among grid rows")
    per = n // grid_rows
    assign = _lpt_capacity(nnz, grid_rows, per)
    # positions [g*per:(g+1)*per] receive the row blocks assigned to grid
    # row g (descending nnz for determinism)
    perm = np.zeros(n, dtype=np.int64)
    for gidx in range(grid_rows):
        mine = np.where(assign == gidx)[0]
        mine = mine[np.argsort(-nnz[mine], kind="stable")]
        perm[gidx * per:(gidx + 1) * per] = mine
    return perm


def _lpt_capacity(costs: np.ndarray, n_workers: int, cap: int) -> np.ndarray:
    """LPT with a per-worker item-count capacity (keeps tiles per row even)."""
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_workers)
    counts = np.zeros(n_workers, dtype=np.int64)
    assign = np.zeros(len(costs), dtype=np.int64)
    for item in order:
        open_w = np.where(counts < cap)[0]
        w = open_w[np.argmin(loads[open_w])]
        assign[item] = w
        loads[w] += costs[item]
        counts[w] += 1
    return assign


def stage_imbalance(tile_costs: np.ndarray) -> Tuple[float, float]:
    """(per_stage, end_to_end) max/avg imbalance of the ring-C schedule.

    ``tile_costs[i, k]`` = flops of using tile A[i, k] (e.g. nnzb counts).
    Device (i, j) at stage t works on A[i, (i + j + t) % g]: per-stage cost
    matrix c_t(i, j) = tile_costs[i, (i+j+t) % g].

    A bulk-synchronous implementation pays sum_t max_devices(c_t); the
    asynchronous one pays max_devices(sum_t c_t).  Both are reported as
    ratios over the average total (paper Fig. 1: ~2.3 vs ~1.2).
    """
    g = tile_costs.shape[0]
    if tile_costs.shape != (g, g):
        raise ValueError(f"tile_costs must be square [g, g], got shape "
                         f"{tile_costs.shape}")
    i = np.arange(g)[:, None]
    j = np.arange(g)[None, :]
    totals = np.zeros((g, g))
    per_stage_max = 0.0
    for t in range(g):
        c_t = tile_costs[i, (i + j + t) % g]
        per_stage_max += c_t.max()
        totals += c_t
    avg_total = totals.mean()
    if avg_total == 0:
        return 1.0, 1.0
    return per_stage_max / avg_total, totals.max() / avg_total
