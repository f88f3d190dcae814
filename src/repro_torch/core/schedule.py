"""Static row-block balancing (port of part of ``repro/core/schedule.py``).

Only what balanced tiling needs: :func:`balance_row_perm` spreads nonzero
blocks evenly over grid rows so the uniform tile capacity shrinks, and
:func:`invert_perm` undoes the permutation on the output.  Plain numpy,
bit-identical to the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["balance_row_perm", "invert_perm"]


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
