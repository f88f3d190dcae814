"""Tile placement (skew layouts) on stacked tile grids.

Port of ``repro/core/dist.py``.  The paper's iteration offset
``k_offset = i + j`` is realised at placement time: grid position (i, j)
starts with tile ``A[i, (i+j) % g]``, so the ring bodies only ever
exchange tiles with neighbours.  Here a placement is an index map of the
``[g, g]`` tile grid (:func:`placement_tiles`): the stacked executor
composes it into its launch maps and reads every operand's natural tiles
where they lie; :func:`place` gathers a placed copy for the handles'
``placed``.

On a process grid (one rank per tile, ``launch/grid.py``) the ranks are
joined in a :func:`make_grid_mesh`, the counterpart of the JAX package's
``make_grid_mesh``: a ``DeviceMesh`` whose ``"row"`` and ``"col"``
dimensions give the subgroups the executor exchanges tiles on.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# transport -> the device type of the tensors it moves
BACKENDS = {"gloo": "cpu", "nccl": "cuda"}

__all__ = [
    "BACKENDS", "check_layout", "make_grid_mesh", "tileize", "untileize",
    "placement_tiles", "placement_index", "place", "unplace",
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


def placement_tiles(placement: str, g: int) -> np.ndarray:
    """Natural tile coordinates held at grid position (i, j): i64[g, g, 2].

    The one statement of where a tile lies: ``natural`` keeps tile (i, j)
    at (i, j), ``skew_rows`` (``ring_c``'s A) puts tile (i, (i+j)%g)
    there, ``skew_cols`` (its B) tile ((i+j)%g, j) and ``stationary_a``
    (``ring_a``'s B) tile (j, (i+j)%g).  The handles' ``placed``, the
    stacked executor's launch maps, the rank path, the packed wire and
    the verifier all place by it.
    """
    i = np.arange(g)[:, None]
    j = np.arange(g)[None, :]
    if placement == "natural":
        ti, tj = np.broadcast_to(i, (g, g)), np.broadcast_to(j, (g, g))
    elif placement == "skew_rows":
        ti, tj = np.broadcast_to(i, (g, g)), (i + j) % g
    elif placement == "skew_cols":
        ti, tj = (i + j) % g, np.broadcast_to(j, (g, g))
    elif placement == "stationary_a":
        ti, tj = np.broadcast_to(j, (g, g)), (i + j) % g
    else:
        raise ValueError(f"unknown placement {placement!r}")
    return np.stack([ti, tj], axis=-1).astype(np.int64)


def placement_index(placement: str, g: int) -> np.ndarray:
    """:func:`placement_tiles` as a ``[g*g]`` tile map: the natural tile
    ``ti * g + tj`` that grid position ``i * g + j`` holds."""
    tiles = placement_tiles(placement, g).reshape(-1, 2)
    return tiles[:, 0] * g + tiles[:, 1]


def place(tiles: torch.Tensor, placement: str) -> torch.Tensor:
    """A natural ``[g, g, ...]`` tile grid as ``placement`` holds it: one
    gather."""
    g = tiles.shape[0]
    idx = torch.as_tensor(placement_index(placement, g), device=tiles.device)
    return tiles.reshape(g * g, *tiles.shape[2:]).index_select(
        0, idx).reshape(tiles.shape)


def unplace(tiles: torch.Tensor, placement: str) -> torch.Tensor:
    """``[g, g, tm, tn]`` tiles held as ``placement`` puts them -> the
    natural ``[g*tm, g*tn]`` matrix: the inverse placement is gathered
    inside the one copy that untileizes."""
    g, _, tm, tn = tiles.shape
    at = np.argsort(placement_index(placement, g)).reshape(g, 1, g)
    rows = np.arange(tm).reshape(1, tm, 1)
    out = tiles.reshape(g * g, tm, tn)[
        torch.as_tensor(at, device=tiles.device),
        torch.as_tensor(rows, device=tiles.device)]
    return out.reshape(g * tm, g * tn)
