"""2D process/tile grids and owner maps (port of ``repro/core/grid.py``).

The paper distributes A (m x k), B (k x n) and C (m x n) over a
sqrt(p) x sqrt(p) grid of tiles, one tile per process.  A ``ProcessGrid``
maps tile coordinates to ranks; the stacked-grid executor keeps every
tile of the grid on one card, indexed by those coordinates.  Everything
here is plain Python and must stay bit-identical to the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

__all__ = ["ProcessGrid", "ceil_div", "pad_to_multiple", "bucket_capacity"]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(x: int, mult: int) -> int:
    return ceil_div(x, mult) * mult


def bucket_capacity(c: int, ratio: float = 1.25) -> int:
    """Round a block capacity up to the next 1.25x geometric bucket.

    Near-identical sparsity patterns then share one capacity, and
    therefore one cached plan.  The series is 0, 1, 2, 3, 4, 5, 7, 9, ...
    (each positive bucket is ``max(prev + 1, ceil(prev * ratio))``), and
    ``bucket_capacity(0) == 0``: an empty operand stores only its coverage
    blocks.
    """
    if c < 0:
        raise ValueError(f"capacity must be non-negative, got {c}")
    if c == 0:
        return 0
    b = 1
    while b < c:
        b = max(b + 1, math.ceil(b * ratio))
    return b


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """A ``rows x cols`` grid of processes, each owning one tile per matrix.

    Ranks are assigned row-major: ``rank = i * cols + j``.
    """

    rows: int
    cols: int

    @property
    def nprocs(self) -> int:
        return self.rows * self.cols

    @classmethod
    def square(cls, p: int) -> "ProcessGrid":
        s = int(math.isqrt(p))
        if s * s != p:
            raise ValueError(f"square grid needs a perfect square, got {p}")
        return cls(s, s)

    # ---- owner maps (the "directory") -------------------------------------
    def owner(self, i: int, j: int) -> int:
        if not (0 <= i < self.rows and 0 <= j < self.cols):
            raise IndexError(f"tile ({i},{j}) outside {self.rows}x{self.cols} grid")
        return i * self.cols + j

    def coords(self, rank: int) -> Tuple[int, int]:
        if not 0 <= rank < self.nprocs:
            raise IndexError(f"rank {rank} outside grid of {self.nprocs}")
        return divmod(rank, self.cols)

    # ---- tile geometry -----------------------------------------------------
    def tile_shape(self, m: int, n: int) -> Tuple[int, int]:
        """Uniform (padded) tile shape for an ``m x n`` matrix on this grid."""
        return ceil_div(m, self.rows), ceil_div(n, self.cols)

    def padded_shape(self, m: int, n: int) -> Tuple[int, int]:
        tm, tn = self.tile_shape(m, n)
        return tm * self.rows, tn * self.cols

    def tile_slice(self, m: int, n: int, i: int, j: int):
        """Global index slice of tile (i, j); clipped to the true shape."""
        tm, tn = self.tile_shape(m, n)
        return (
            slice(i * tm, min((i + 1) * tm, m)),
            slice(j * tn, min((j + 1) * tn, n)),
        )

    # ---- the paper's iteration offset --------------------------------------
    def k_offset(self, i: int, j: int) -> int:
        """Iteration offset of the stationary-C inner loop (paper SS3.3).

        Process (i, j) starts its k-loop at ``i + j``, so no two processes
        in a row or column request the same tile at the same step.
        """
        return (i + j) % self.cols
