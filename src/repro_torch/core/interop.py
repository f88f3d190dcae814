"""Carry state across from the JAX package as numpy arrays.

A :class:`repro.core.bsr.TiledBSR`'s fields, handed over with
``np.asarray``, become the port's :class:`~repro_torch.core.bsr.TiledBSR`
on a device, so both packages can be fed one matrix.  A dense operand
crosses the same way, through
:func:`repro_torch.runtime.device.as_tensor`.  This module imports no JAX:
the caller converts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..runtime.device import as_tensor, resolve_device
from .bsr import TiledBSR

__all__ = ["tiled_from_arrays"]


def tiled_from_arrays(blocks, rows, cols, counts, *, shape: Tuple[int, int],
                      block_size: int, grid_shape: Tuple[int, int],
                      capacity: int,
                      logical_shape: Optional[Tuple[int, int]] = None,
                      row_block_perm: Optional[Tuple[int, ...]] = None,
                      col_block_perm: Optional[Tuple[int, ...]] = None,
                      device=None) -> TiledBSR:
    """The port's TiledBSR from the JAX package's TiledBSR fields.

    ``blocks`` is ``[gr, gc, store_cap, bs, bs]`` (float32, or the
    ``bfloat16`` extension dtype numpy gets from a JAX bf16 array);
    ``rows``/``cols`` ``[gr, gc, store_cap]`` and ``counts`` ``[gr, gc]``
    integers.  The storage contract (row-sorted, coverage-augmented tiles)
    is the JAX package's, so the arrays are taken as they are.
    """
    device = resolve_device(device)
    gr, gc = grid_shape
    blocks = np.asarray(blocks)
    store = blocks.shape[2] if blocks.ndim == 5 else -1
    want = {"blocks": (gr, gc, store, block_size, block_size),
            "rows": (gr, gc, store), "cols": (gr, gc, store),
            "counts": (gr, gc)}
    got = {"blocks": blocks.shape, "rows": np.shape(rows),
           "cols": np.shape(cols), "counts": np.shape(counts)}
    for name, shp in want.items():
        if tuple(got[name]) != shp:
            raise ValueError(f"{name} has shape {tuple(got[name])}, "
                             f"expected {shp}")
    if store != capacity + shape[0] // gr // block_size:
        raise ValueError(f"store capacity {store} is not capacity "
                         f"{capacity} + tile block-rows")
    as_i32 = lambda x: as_tensor(np.asarray(x, dtype=np.int32), device)
    return TiledBSR(
        blocks=as_tensor(blocks, device), rows=as_i32(rows),
        cols=as_i32(cols), counts=as_i32(counts), shape=tuple(shape),
        block_size=block_size, grid_shape=(gr, gc), capacity=capacity,
        logical_shape=None if logical_shape is None else tuple(logical_shape),
        row_block_perm=None if row_block_perm is None
        else tuple(int(p) for p in row_block_perm),
        col_block_perm=None if col_block_perm is None
        else tuple(int(p) for p in col_block_perm))
