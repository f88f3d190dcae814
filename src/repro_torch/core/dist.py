"""Tile placement (skew layouts) on stacked tile grids.

Port of ``repro/core/dist.py``.  The paper's iteration offset
``k_offset = i + j`` is realised at placement time: the distributed-matrix
handle places tile ``A[i, (i+j) % g]`` at grid position (i, j), so the ring
bodies only ever exchange tiles with neighbours.  Here a placement is a
gather on the ``[g, g, ...]`` tile grid that the executor keeps on one
card.
"""
from __future__ import annotations

import dataclasses

import torch

from .bsr import TiledBSR

__all__ = [
    "tileize", "untileize", "skew_dense", "skew_bsr",
    "place_b_for_stationary_a", "unskew_c_rows",
]


def tileize(x: torch.Tensor, g: int) -> torch.Tensor:
    """[M, N] -> contiguous [g, g, M/g, N/g] tile grid."""
    m, n = x.shape
    return x.reshape(g, m // g, g, n // g).permute(0, 2, 1, 3).contiguous()


def untileize(t: torch.Tensor) -> torch.Tensor:
    """[g1, g2, tm, tn] -> [g1*tm, g2*tn]."""
    g1, g2, tm, tn = t.shape
    return t.permute(0, 2, 1, 3).reshape(g1 * tm, g2 * tn)


def _grid_index(g: int, device):
    i = torch.arange(g, device=device)[:, None]
    j = torch.arange(g, device=device)[None, :]
    return i, j


def _roll_rows(tiles: torch.Tensor, sign: int) -> torch.Tensor:
    """tiles[i, j] <- tiles[i, (j + sign*i) % g]  (row-dependent column roll)."""
    i, j = _grid_index(tiles.shape[0], tiles.device)
    return tiles[i, (j + sign * i) % tiles.shape[0]]


def _roll_cols(tiles: torch.Tensor, sign: int) -> torch.Tensor:
    """tiles[i, j] <- tiles[(i + sign*j) % g, j]  (col-dependent row roll)."""
    i, j = _grid_index(tiles.shape[0], tiles.device)
    return tiles[(i + sign * j) % tiles.shape[0], j]


def skew_dense(x: torch.Tensor, g: int, kind: str) -> torch.Tensor:
    """Skew a global dense matrix's tile grid.

    kind='rows': position (i,j) holds tile (i, (i+j)%g)   [A operand]
    kind='cols': position (i,j) holds tile ((i+j)%g, j)   [B operand]
    """
    tiles = tileize(x, g)
    if kind == "rows":
        tiles = _roll_rows(tiles, +1)
    elif kind == "cols":
        tiles = _roll_cols(tiles, +1)
    else:
        raise ValueError(kind)
    return untileize(tiles)


def skew_bsr(a: TiledBSR, kind: str) -> TiledBSR:
    """Skew a TiledBSR's tile grid (same placement semantics as skew_dense)."""
    if a.grid_shape[0] != a.grid_shape[1]:
        raise ValueError("skew needs a square grid")
    if kind not in ("rows", "cols"):
        raise ValueError(kind)
    roll = _roll_rows if kind == "rows" else _roll_cols
    return dataclasses.replace(
        a, blocks=roll(a.blocks, +1), rows=roll(a.rows, +1),
        cols=roll(a.cols, +1), counts=roll(a.counts, +1))


def place_b_for_stationary_a(b: torch.Tensor, g: int) -> torch.Tensor:
    """Initial B placement for the stationary-A ring.

    Position (i, k) holds B tile (k, (i+k) % g).
    """
    tiles = tileize(b, g)
    i, k = _grid_index(g, b.device)
    return untileize(tiles[k + 0 * i, (i + k) % g])


def unskew_c_rows(c: torch.Tensor, g: int) -> torch.Tensor:
    """Invert 'rows' skew on the output: position (i,j) held tile (i,(i+j)%g)."""
    return untileize(_roll_rows(tileize(c, g), -1))
