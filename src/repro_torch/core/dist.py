"""Tile placement (skew layouts) on stacked tile grids.

Port of ``repro/core/dist.py``.  The paper's iteration offset
``k_offset = i + j`` is realised at placement time: the distributed-matrix
handle places tile ``A[i, (i+j) % g]`` at grid position (i, j), so the ring
bodies only ever exchange tiles with neighbours.  Here a placement is a
gather on the ``[g, g, ...]`` tile grid that the executor keeps on one
card.

On a process grid (one rank per tile, ``launch/grid.py``) the ranks are
joined in a :func:`make_grid_mesh`, the counterpart of the JAX package's
``make_grid_mesh``: a ``DeviceMesh`` whose ``"row"`` and ``"col"``
dimensions give the subgroups the executor exchanges tiles on.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .bsr import TiledBSR

# transport -> the device type of the tensors it moves
BACKENDS = {"gloo": "cpu", "nccl": "cuda"}

__all__ = [
    "BACKENDS", "check_layout", "make_grid_mesh", "tileize", "untileize",
    "skew_dense", "skew_bsr",
    "place_b_for_stationary_a", "unskew_c_rows",
]


def check_layout(g: int, backend: str, device_type: str) -> None:
    """Refuse, before any process group exists, a grid the transport cannot
    run: a backend other than ``gloo`` (host tensors) or ``nccl`` (CUDA
    tensors), a device type that is not the backend's, or ``nccl`` with
    more ranks than cards, which NCCL refuses ("Duplicate GPU detected")
    only once its communicator starts, if it does not hang first."""
    if g < 1:
        raise ValueError(f"grid size must be >= 1, got {g}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{tuple(BACKENDS)}")
    if device_type != BACKENDS[backend]:
        raise ValueError(
            f"backend {backend!r} moves {BACKENDS[backend]} tensors, not "
            f"{device_type!r} ones")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < g * g:
            raise RuntimeError(
                f"backend 'nccl' needs one card per rank: a {g}x{g} grid "
                f"has {g * g} ranks and this machine {cards} card(s), and "
                "NCCL refuses two ranks on one card ('Duplicate GPU "
                "detected'); run the grid on backend='gloo', which stages "
                "card tiles through host memory")


def make_grid_mesh(g: int, axis_row: str = "row", axis_col: str = "col", *,
                   backend: str, device_type: str):
    """A ``g x g`` ``DeviceMesh`` over the default process group, rank
    ``i * g + j`` at (i, j), with dimensions ``(axis_row, axis_col)``.

    ``mesh.get_group(axis_col)`` is the subgroup of a grid row (the ranks
    that share i), along which A rides the ring; ``mesh.get_group(
    axis_row)`` that of a grid column.  The layout is checked first
    (:func:`check_layout`); the process group must exist with ``g * g``
    ranks on ``backend``, which is never changed here.
    """
    check_layout(g, backend, device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_grid_mesh needs an initialised process group of g * g "
            "ranks (repro_torch.launch.grid.run_grid starts one)")
    if dist.get_world_size() != g * g:
        raise ValueError(f"a {g}x{g} grid needs {g * g} ranks, the process "
                         f"group has {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the requested {backend!r}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(g * g).reshape(g, g),
                      mesh_dim_names=(axis_row, axis_col))


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
