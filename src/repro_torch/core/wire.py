"""Packed wire format: ship only real blocks (port of ``repro/core/wire.py``).

Sparse operand tiles otherwise ride the ring at the uniform padded
``store_capacity`` stride (capacity + coverage blocks), so the bytes moved
scale with the heaviest tile's bucketed capacity.  The packed format keeps
only each tile's real blocks, and all structure in plan-time maps.  Host
numpy, bit-identical to the JAX package.  Per sparse operand:

* **wire capacity** — ``bucket_capacity(max real blocks per tile + 1)``,
  clamped to the stored stride: one static stride for every tile of a
  path, and the ``+ 1`` makes slot ``wc - 1`` of every packed tile a
  guaranteed zero block, the inert target;
* **source-side pack** (:attr:`PackedOperand.pack_idx`) — gather indices
  selecting each tile's real stored slots (in stored, row-sorted order)
  into the packed prefix; trailing slots point at the tile's coverage zero
  block;
* **receiver-side consume maps** — structure is static, so ``rows``/``cols``
  never ride along:

  - :attr:`PackedOperand.gidx`/``rows``/``cols`` — the coverage-augmented
    block list of each tile as a gather into its packed blocks, meeting the
    ``bsr_spmm_raw(augment=False)`` contract;
  - :attr:`PackedOperand.dmap` — densify-by-gather (``ops.densify_packed``):
    the packed slot, or the zero slot, of every dense block position;
  - :attr:`PackedOperand.slot_map` — stored slot -> packed slot, composed
    into the symbolic phase's pair lists (:func:`remap_pairs_packed`) so the
    pair kernels index packed buffers with no unpack copy.

On the stacked executor the packed buffer is what the ring shift rolls; the
public surface is ``plan_matmul(wire="packed")``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .grid import bucket_capacity
from .symbolic import GridStructure

__all__ = [
    "PackedOperand", "wire_capacity", "pack_operand",
    "placement_tiles", "tiles_ring_c", "tiles_ring_c_bwd", "tiles_ring_c_b",
    "tiles_ring_a_b", "tiles_summa_a", "tiles_summa_b", "schedule_consume",
    "schedule_dense_map", "remap_pairs_packed",
    "packed_block_bytes", "padded_tile_bytes",
]


@dataclasses.dataclass(frozen=True)
class PackedOperand:
    """Plan-time packed layout of one sparse operand (host numpy).

    All per-tile arrays are indexed by *natural* tile coordinates
    ``[ti, tj]``; the planner composes the placement / step schedule on
    top via :func:`schedule_consume` / :func:`schedule_dense_map`.
    """
    wire_capacity: int        # packed block slots on the wire (bucketed)
    aug_capacity: int         # coverage-augmented consume-list length
    pack_idx: np.ndarray      # i32[g, g, wc]: packed slot -> stored slot
    gidx: np.ndarray          # i32[g, g, aug_cap]: consume -> packed slot
    rows: np.ndarray          # i32[g, g, aug_cap] (sorted, all rows present)
    cols: np.ndarray          # i32[g, g, aug_cap]
    dmap: np.ndarray          # i32[g, g, nbr*nbc]: dense pos -> packed slot
    slot_map: np.ndarray      # i32[g, g, store]: stored -> packed (inert
                              #   slots -> wc - 1, the guaranteed zero)
    n_real: np.ndarray        # i64[g, g] real blocks per tile
    tile_nbr: int
    tile_nbc: int
    fingerprint: str          # the structure these maps encode

    @property
    def zero_slot(self) -> int:
        """The guaranteed-zero packed slot of every tile (``wc - 1``)."""
        return self.wire_capacity - 1


def wire_capacity(max_real: int, store_capacity: Optional[int] = None
                  ) -> int:
    """Packed wire stride for a path whose heaviest tile has ``max_real``
    real blocks: bucketed (plan-shape stability across near-identical
    structures) with one extra slot so every packed tile ends in a
    guaranteed zero block (the inert gather target).

    ``store_capacity`` (the operand's padded stride, itself
    capacity-bucketed and therefore equally cache-stable) clamps the
    result: a 1.25x bucket jump must never make the packed wire wider
    than the padded one it replaces.  The clamp keeps the zero-slot
    guarantee — a stored tile always holds at least one coverage zero,
    so ``max_real < store_capacity``.
    """
    wc = bucket_capacity(int(max_real) + 1)
    if store_capacity is not None:
        wc = min(wc, int(store_capacity))
    return wc


def pack_operand(struct: GridStructure) -> PackedOperand:
    """Build the packed wire layout for one operand's structure."""
    g = struct.grid_shape[0]
    nbr, nbc = struct.tile_nbr, struct.tile_nbc
    store = struct.rows.shape[2]
    n_real = struct.real.sum(axis=2).astype(np.int64)
    wc = wire_capacity(int(n_real.max()) if n_real.size else 0, store)
    # consume lists are local (never on the wire), but clamp them to the
    # padded stride too: the packed step must not execute more block
    # products than the padded one it replaces
    aug_cap = min(bucket_capacity(int(n_real.max()) + nbr
                                  if n_real.size else nbr), store)
    pack_idx = np.zeros((g, g, wc), dtype=np.int32)
    gidx = np.full((g, g, aug_cap), wc - 1, dtype=np.int32)
    rows = np.zeros((g, g, aug_cap), dtype=np.int32)
    cols = np.zeros((g, g, aug_cap), dtype=np.int32)
    dmap = np.full((g, g, nbr * nbc), wc - 1, dtype=np.int32)
    slot_map = np.full((g, g, store), wc - 1, dtype=np.int32)
    for i in range(g):
        for j in range(g):
            sl = np.nonzero(struct.real[i, j])[0]      # stored (row) order
            nr = len(sl)
            # source side: real slots first, zero slot padding after
            pack_idx[i, j, :nr] = sl
            pack_idx[i, j, nr:] = struct.zero_slot[i, j]
            slot_map[i, j, sl] = np.arange(nr)
            # consume side: merge the real blocks with one coverage zero
            # per block-row (the bsr_spmm_raw(augment=False) contract),
            # exactly like bsr._augment_tile but as packed-slot gathers
            r = struct.rows[i, j][sl].astype(np.int64)
            c = struct.cols[i, j][sl].astype(np.int64)
            cov = np.arange(nbr, dtype=np.int64)
            r_aug = np.concatenate([r, cov])
            order = np.argsort(r_aug, kind="stable")
            n_aug = nr + nbr
            gidx[i, j, :n_aug] = np.concatenate(
                [np.arange(nr), np.full(nbr, wc - 1)])[order]
            rows[i, j, :n_aug] = r_aug[order]
            cols[i, j, :n_aug] = np.concatenate(
                [c, np.zeros(nbr, np.int64)])[order]
            # padding keeps rows nondecreasing and gathers the zero slot
            rows[i, j, n_aug:] = nbr - 1
            # densify-by-gather map (positions with no real block keep the
            # zero slot); real positions are unique by the TiledBSR /
            # symbolic-layout construction
            dmap[i, j, r * nbc + c] = np.arange(nr)
    return PackedOperand(
        wire_capacity=wc, aug_capacity=aug_cap, pack_idx=pack_idx,
        gidx=gidx, rows=rows, cols=cols, dmap=dmap, slot_map=slot_map,
        n_real=n_real, tile_nbr=nbr, tile_nbc=nbc,
        fingerprint=struct.fingerprint)


# ---------------------------------------------------------------------------
# Placement / step-schedule composition
# ---------------------------------------------------------------------------
def placement_tiles(placement: str, g: int) -> np.ndarray:
    """Natural tile coordinates held at grid position (i, j): i64[g, g, 2].

    Mirrors ``api._place_bsr`` / ``core.dist`` exactly.
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


def _steps(g: int):
    i = np.arange(g)[:, None, None]
    j = np.arange(g)[None, :, None]
    t = np.arange(g)[None, None, :]
    return i, j, t


def tiles_ring_c(g: int) -> np.ndarray:
    """Tile consumed at step t on device (i, j) in the stationary-C ring:
    A[i, (i + j + t) % g] (skewed placement + t forward rotations)."""
    i, j, t = _steps(g)
    return np.stack(np.broadcast_arrays(i, (i + j + t) % g), axis=-1)


def tiles_ring_c_bwd(g: int) -> np.ndarray:
    """Backward stream of ``ring_c_bidir``: A[i, (i + j - t) % g]."""
    i, j, t = _steps(g)
    return np.stack(np.broadcast_arrays(i, (i + j - t) % g), axis=-1)


def tiles_ring_c_b(g: int) -> np.ndarray:
    """B tile consumed at step t on device (i, j) in the stationary-C ring:
    B[(i + j + t) % g, j] (skew_cols placement + t rotations along rows)."""
    i, j, t = _steps(g)
    return np.stack(np.broadcast_arrays((i + j + t) % g, j + 0 * t), axis=-1)


def tiles_ring_a_b(g: int) -> np.ndarray:
    """B tile consumed in the stationary-A ring: B[j, (i + j + t) % g]
    (the ``stationary_a`` placement + t rotations along the row axis)."""
    i, j, t = _steps(g)
    return np.stack(np.broadcast_arrays(j + 0 * i, (i + j + t) % g), axis=-1)


def tiles_summa_a(g: int) -> np.ndarray:
    """A tile consumed at SUMMA inner step k on device (i, j): A[i, k]."""
    i, j, t = _steps(g)
    return np.stack(np.broadcast_arrays(i + 0 * j, t + 0 * j), axis=-1)


def tiles_summa_b(g: int) -> np.ndarray:
    """B tile consumed at SUMMA inner step k on device (i, j): B[k, j]."""
    i, j, t = _steps(g)
    return np.stack(np.broadcast_arrays(t + 0 * i, j + 0 * t), axis=-1)


def _gather_tiles(po: PackedOperand, arr: np.ndarray, tiles: np.ndarray
                  ) -> np.ndarray:
    """arr[g, g, L] per tile -> [g, g, T, L] per (device, step)."""
    return arr[tiles[..., 0], tiles[..., 1]]


def schedule_consume(po: PackedOperand, tiles: np.ndarray,
                     bases: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    """Per-(device, step) consume lists for a step schedule.

    ``tiles`` is ``[g, g, T, 2]`` (see the ``tiles_*`` helpers); ``bases``
    (``[g, g, T]``, default 0) offsets the gather indices into a pooled
    packed buffer — ``k * wire_capacity`` for an all-gathered panel, 0 for
    a carried ring buffer.  Because every packed tile's last slot is zero,
    ``base + wc - 1`` stays the inert target under any base.
    """
    gidx = _gather_tiles(po, po.gidx, tiles)
    if bases is not None:
        gidx = gidx + bases[..., None].astype(np.int32)
    return {
        "gidx": np.ascontiguousarray(gidx, dtype=np.int32),
        "rows": np.ascontiguousarray(_gather_tiles(po, po.rows, tiles)),
        "cols": np.ascontiguousarray(_gather_tiles(po, po.cols, tiles)),
    }


def schedule_dense_map(po: PackedOperand, tiles: np.ndarray,
                       bases: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-(device, step) densify-by-gather maps ``[g, g, T, nbr*nbc]``."""
    dmap = _gather_tiles(po, po.dmap, tiles)
    if bases is not None:
        dmap = dmap + bases[..., None].astype(np.int32)
    return np.ascontiguousarray(dmap, dtype=np.int32)


def remap_pairs_packed(pair_arr: np.ndarray, po: PackedOperand,
                       tiles_of_k: str) -> np.ndarray:
    """Compose the stored->packed slot map into symbolic pair lists.

    ``pair_arr`` is a symbolic-phase operand pair list ``[g, g, g, P]``
    indexed ``[i, j, k, p]`` whose values are *stored* slots of tile
    ``A[i, k]`` (``tiles_of_k="a"``) or ``B[k, j]`` (``"b"``); the result
    indexes the same blocks in their *packed* layout.  Inert pairs (the
    symbolic phase's per-tile ``zero_slot``) land on the packed zero tail,
    so the kernel contract (dummy pairs reference zero blocks) holds with
    no unpack copy.
    """
    g = po.slot_map.shape[0]
    i = np.arange(g)[:, None, None, None]
    j = np.arange(g)[None, :, None, None]
    k = np.arange(g)[None, None, :, None]
    if tiles_of_k == "a":
        ti, tj = i, k
    elif tiles_of_k == "b":
        ti, tj = k, j
    else:
        raise ValueError(f"tiles_of_k must be 'a' or 'b', got {tiles_of_k!r}")
    ti = np.broadcast_to(ti, pair_arr.shape)
    tj = np.broadcast_to(tj, pair_arr.shape)
    return np.ascontiguousarray(
        po.slot_map[ti, tj, pair_arr.astype(np.int64)], dtype=np.int32)


# ---------------------------------------------------------------------------
# Byte accounting (the cost-model / benchmark terms)
# ---------------------------------------------------------------------------
def packed_block_bytes(wc: int, block_size: int, itemsize: int) -> int:
    """Wire bytes of one packed tile shipment: blocks only — the consume
    maps stay home, so no rows/cols index traffic."""
    return wc * block_size * block_size * itemsize


def padded_tile_bytes(store_capacity: int, block_size: int,
                      itemsize: int) -> int:
    """Wire bytes of one padded tile shipment: coverage-augmented blocks
    plus the rows/cols int32 arrays that ride with them."""
    return store_capacity * (block_size * block_size * itemsize + 2 * 4)
