"""Stacked-grid executor: the g x g process grid on one card.

The JAX package runs each schedule body under ``shard_map``, one tile per
device, and moves tiles with ``lax.ppermute``.  Here all g² tiles of an
operand live stacked as ``[g, g, ...]`` tensors on one device:

* a ring ``ppermute`` along a mesh axis with perm ``[((d + sign) % g, d)]``
  — device d *receives* from device d + sign — is a ``torch.roll`` of the
  stack by ``-sign`` along grid dim 0 (``"row"`` axis) or 1 (``"col"``)
  (:meth:`StackedExecutor.shift`, the sparse-output body's); or, where a
  kernel reads its operands in place, the same roll of a ``[g*g]`` tile
  map, a host composition that moves no data
  (:meth:`StackedExecutor.shift_map`, the dense-output bodies');
* a body's per-step local multiply runs on all g² tiles at once, with the
  tile index as a batch dimension (:meth:`StackedExecutor.batch`), so one
  kernel launch serves the whole grid.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["StackedExecutor", "AXES"]

# mesh axis name -> grid dimension of the stacked tensors
AXES = {"row": 0, "col": 1}


class StackedExecutor:
    """Runs schedule bodies over a ``g x g`` tile grid stacked on ``device``."""

    def __init__(self, g: int, device: torch.device):
        self.g = g
        self.device = torch.device(device)

    def shift(self, tree: Dict[str, torch.Tensor], axis: str,
              sign: int = 1) -> Dict[str, torch.Tensor]:
        """Ring shift: position d along ``axis`` receives the tile at
        ``(d + sign) % g`` (the JAX bodies' ``_tree_ppermute``)."""
        dim = AXES[axis]
        return {k: torch.roll(v, shifts=-sign, dims=dim)
                for k, v in tree.items()}

    def identity_map(self) -> np.ndarray:
        """The tile map of the placed stacks: position p reads tile p."""
        return np.arange(self.g * self.g)

    def shift_map(self, tile_map: np.ndarray, axis: str,
                  sign: int = 1) -> np.ndarray:
        """:meth:`shift` as a composition of ``[g*g]`` tile maps (host
        numpy): position d along ``axis`` reads what position ``(d + sign)
        % g`` read.  ``tile_map[p]`` is the stacked tile that grid position
        ``p = i * g + j`` reads; no tile moves."""
        grid = np.asarray(tile_map).reshape(self.g, self.g)
        return np.roll(grid, -sign, axis=AXES[axis]).reshape(-1)

    def batch(self, x: torch.Tensor) -> torch.Tensor:
        """[g, g, *rest] -> [g*g, *rest]: the tile grid as a batch."""
        return x.reshape(self.g * self.g, *x.shape[2:])

    def unbatch(self, x: torch.Tensor) -> torch.Tensor:
        """[g*g, *rest] -> [g, g, *rest]."""
        return x.reshape(self.g, self.g, *x.shape[1:])
