"""R-MAT graphs, the benchmark's own copy of the port's generator.

``rmat_edges`` is ``repro_torch.core.bsr.rmat_edges`` as it stands, kept
here so that a change to the program cannot move the benchmark's inputs
(``bench/tests/test_bench_inputs.py`` holds the two equal).
"""
from __future__ import annotations

import numpy as np


def rmat_edges(scale: int, edgefactor: int = 8,
               a: float = 0.6, b: float = 0.4 / 3, c: float = 0.4 / 3,
               d: float = 0.4 / 3, seed: int = 0) -> np.ndarray:
    """R-MAT edge list (paper Fig. 1 uses a=0.6, b=c=d=0.4/3, ef=8).

    Returns int64[nedges, 2].
    """
    rng = np.random.default_rng(seed)
    n_edges = edgefactor << scale
    probs = np.array([a, b, c, d], dtype=np.float64)
    probs = probs / probs.sum()
    rows = np.zeros(n_edges, dtype=np.int64)
    cols = np.zeros(n_edges, dtype=np.int64)
    for bit in range(scale):
        quad = rng.choice(4, size=n_edges, p=probs)
        rows |= ((quad >> 1) & 1).astype(np.int64) << bit
        cols |= (quad & 1).astype(np.int64) << bit
    return np.stack([rows, cols], axis=1)


def graph(cfg: dict) -> np.ndarray:
    """The configuration's graph: its R-MAT edges, each distinct edge once,
    sorted by row, then column (the order of a CSR matrix)."""
    e = rmat_edges(cfg["scale"], cfg["edgefactor"], a=cfg["a"], b=cfg["b"],
                   c=cfg["c"], d=cfg["d"], seed=cfg["graph_seed"])
    return np.unique(e, axis=0)
