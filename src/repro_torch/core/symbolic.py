"""Symbolic phase of distributed block SpGEMM (port of
``repro/core/symbolic.py``).

The structure of C = A @ B is a function of the operands' structures
alone, so it is computed once, on the host, and every numeric multiply
afterwards writes straight into a pre-allocated sparse output.  Given two
:class:`~repro_torch.core.bsr.TiledBSR` operands this module computes, in
host numpy, bit-identical to the JAX package:

* the block mask of every C tile (the union of A[i, k] x B[k, j] over k),
  packed into a capacity-bounded layout that satisfies the ``TiledBSR``
  storage contract (row-sorted, coverage-augmented, uniformly padded), so
  the numeric result wraps directly into a
  :class:`~repro_torch.core.api.DistBSR` and chains into further
  multiplies;
* per-(tile, inner-step) pair lists: the matched (A slot, B slot) -> C slot
  triples that the numeric kernel (``ops.bsr_pair_accumulate``)
  accumulates, sorted by slot, with one coverage pair per slot and uniform
  inert padding;
* the statistics of the product (real pair counts, packed output bytes,
  predicted density).

Structure comes from the stored blocks' data, so padding and coverage
blocks never produce pairs.  The only device work is finding those
blocks: :func:`extract_structure` reduces each block to one bool on the
device and copies the mask, not the blocks, to the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..kernels.ops import match_block_pairs
from .bsr import TiledBSR
from .grid import bucket_capacity

__all__ = [
    "GridStructure", "SymbolicProduct", "extract_structure",
    "structure_fingerprint", "predicted_density", "symbolic_spgemm",
]


@dataclasses.dataclass(frozen=True)
class GridStructure:
    """Host-side structural view of a TiledBSR's stored slots.

    ``real[i, j, s]`` marks slots holding nonzero data (padding and
    coverage blocks are structurally zero); ``zero_slot[i, j]`` is one
    slot per tile that is guaranteed zero — the coverage augmentation
    always stores at least one zero block — used as the inert target of
    dummy pairs.
    """
    rows: np.ndarray          # i32[g, g, store]
    cols: np.ndarray          # i32[g, g, store]
    real: np.ndarray          # bool[g, g, store]
    zero_slot: np.ndarray     # i64[g, g]
    grid_shape: Tuple[int, int]
    block_size: int
    shape: Tuple[int, int]    # padded global shape
    tile_nbr: int             # block-rows per tile
    tile_nbc: int             # block-cols per tile
    fingerprint: str


def extract_structure(t: TiledBSR) -> GridStructure:
    """Pull a TiledBSR's block structure to the host.

    A block is real when any of its elements is nonzero (the JAX
    package's ``|block|.sum() != 0``, NaN included): :meth:`TiledBSR.host`
    holds that mask, the rows and the cols on the host.
    """
    host = t.host()
    rows, cols, real = host["rows"], host["cols"], host["real"]
    if not (~real).any(axis=2).all():
        # cannot happen for TiledBSR-constructed values (coverage adds >= 1
        # zero block per tile); fail loudly rather than corrupt pair lists
        raise ValueError("tile without a zero block slot: operand does not "
                         "satisfy the TiledBSR coverage-augmentation "
                         "contract")
    zero_slot = np.argmin(real, axis=2)       # first False per tile
    h = hashlib.sha1()
    for arr in (rows, cols, real):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr((tuple(int(x) for x in t.shape),
                   tuple(int(x) for x in t.grid_shape),
                   int(t.block_size))).encode())
    tm, tn = t.tile_shape
    return GridStructure(
        rows=rows, cols=cols, real=real, zero_slot=zero_slot,
        grid_shape=t.grid_shape, block_size=t.block_size, shape=t.shape,
        tile_nbr=tm // t.block_size, tile_nbc=tn // t.block_size,
        fingerprint=h.hexdigest())


def structure_fingerprint(t: TiledBSR) -> str:
    """Stable hash of the block structure (which slots hold data, where)."""
    return extract_structure(t).fingerprint


@dataclasses.dataclass(frozen=True)
class SymbolicProduct:
    """Predicted structure of C = A @ B plus the numeric-phase pair lists.

    The C layout (``c_rows``/``c_cols``/``c_counts``) follows the
    ``TiledBSR`` storage contract: per tile, real predicted blocks sorted
    by (row, col), padded to the uniform (bucketed) ``capacity`` and
    coverage-augmented to ``store_capacity = capacity + tile_nbr``, so the
    numeric result wraps directly into a TiledBSR.

    Pair lists are indexed ``[i, j, k, p]`` — device (i, j), inner index k
    in *natural* order (the planner reorders axis 2 per schedule via
    :meth:`scheduled_pairs`).  Each list is sorted by output slot
    (nondecreasing, the kernel's first-visit-zeroing contract), contains
    one coverage pair per output slot, and is padded with inert pairs
    (both operands' zero slots, repeating the last output slot).
    """
    g: int
    block_size: int
    tile_nbr: int                 # C tile block-rows
    tile_nbc: int                 # C tile block-cols
    shape: Tuple[int, int]        # padded C shape
    capacity: int                 # real-block capacity per C tile (bucketed)
    c_rows: np.ndarray            # i32[g, g, store_capacity]
    c_cols: np.ndarray            # i32[g, g, store_capacity]
    c_real: np.ndarray            # bool[g, g, store_capacity] — real slots
    c_counts: np.ndarray          # i32[g, g] — predicted real blocks
    pair_a: np.ndarray            # i32[g, g, g, pair_capacity]
    pair_b: np.ndarray            # i32[g, g, g, pair_capacity]
    pair_slot: np.ndarray         # i32[g, g, g, pair_capacity]
    n_real_pairs: np.ndarray      # i64[g, g, g]
    a_fingerprint: str
    b_fingerprint: str
    a_zero_slot: np.ndarray       # i64[g, g] — A tile (i, k)'s zero slot
    b_zero_slot: np.ndarray       # i64[g, g] — B tile (k, j)'s zero slot

    @property
    def store_capacity(self) -> int:
        return self.c_rows.shape[2]

    @property
    def pair_capacity(self) -> int:
        return self.pair_a.shape[3]

    def density(self) -> float:
        """Predicted fraction of C block positions that are nonzero."""
        total = self.g * self.g * self.tile_nbr * self.tile_nbc
        return float(self.c_counts.sum()) / float(total)

    def total_real_pairs(self) -> int:
        return int(self.n_real_pairs.sum())

    def flops(self) -> int:
        """Real (structure-only) MXU flops of one numeric multiply."""
        return 2 * self.total_real_pairs() * self.block_size ** 3

    def output_bytes(self, itemsize: int = 4) -> int:
        """Packed C bytes per device: blocks + rows/cols index arrays."""
        bs = self.block_size
        return self.store_capacity * (bs * bs * itemsize + 2 * 4)

    def block_mask(self) -> np.ndarray:
        """Predicted global block mask of C (bool[g*tile_nbr, g*tile_nbc])."""
        g, nbr, nbc = self.g, self.tile_nbr, self.tile_nbc
        mask = np.zeros((g * nbr, g * nbc), dtype=bool)
        for i in range(g):
            for j in range(g):
                real = self.c_real[i, j]
                mask[i * nbr + self.c_rows[i, j][real],
                     j * nbc + self.c_cols[i, j][real]] = True
        return mask

    def pair_real(self) -> np.ndarray:
        """bool[g, g, g, P]: the pairs whose product can be nonzero.

        A pair is inert exactly when it multiplies the two operands'
        guaranteed-zero slots (A tile (i, k)'s and B tile (k, j)'s): the
        coverage pairs and the padding.  Real pairs never reference a zero
        slot, so this counts ``n_real_pairs`` per list.
        """
        za = self.a_zero_slot[:, None, :, None]          # [i, 1, k, 1]
        zb = self.b_zero_slot.T[None, :, :, None]        # [1, j, k, 1]
        return (self.pair_a != za) | (self.pair_b != zb)

    def scheduled_pairs(self, k_order: Callable,
                        pair_a: Optional[np.ndarray] = None,
                        pair_b: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
        """Reorder the inner axis per schedule: pairs for step t on device
        (i, j) are the natural-k lists at ``k = k_order(i, j, t, g)``.
        ``k_order`` must be numpy-broadcastable (the ring offset
        ``(i + j + t) % g``, SUMMA's ``t``, ...).

        ``pair_a``/``pair_b`` override the stored-slot operand lists with
        remapped variants of the same ``[g, g, g, P]`` shape — how the
        packed wire format (``repro_torch.core.wire.remap_pairs_packed``)
        composes its receiver-side slot mapping into the schedule.  ``real``
        is :meth:`pair_real` scheduled the same way (from the stored-slot
        lists; the remap keeps inert pairs on zero slots).
        """
        g = self.g
        i = np.arange(g)[:, None, None]
        j = np.arange(g)[None, :, None]
        t = np.arange(g)[None, None, :]
        k = np.broadcast_to(k_order(i, j, t, g), (g, g, g))
        take = lambda arr: arr[i, j, k]
        return {"pa": take(self.pair_a if pair_a is None else pair_a),
                "pb": take(self.pair_b if pair_b is None else pair_b),
                "ps": take(self.pair_slot),
                "real": take(self.pair_real())}


def _validate_pair(a: TiledBSR, b: TiledBSR) -> None:
    if a.grid_shape != b.grid_shape or a.grid_shape[0] != a.grid_shape[1]:
        raise ValueError(f"operands need matching square grids, got "
                         f"{a.grid_shape} and {b.grid_shape}")
    if a.block_size != b.block_size:
        raise ValueError(f"block sizes disagree: {a.block_size} vs "
                         f"{b.block_size}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner (padded) dimensions disagree: A is "
                         f"{a.shape}, B is {b.shape}")


def _global_mask(s: GridStructure) -> np.ndarray:
    """Global block mask (bool[g*tile_nbr, g*tile_nbc]) of a structure."""
    g, nbr, nbc = s.grid_shape[0], s.tile_nbr, s.tile_nbc
    mask = np.zeros((g * nbr, g * nbc), dtype=bool)
    for i in range(g):
        for j in range(g):
            real = s.real[i, j]
            mask[i * nbr + s.rows[i, j][real],
                 j * nbc + s.cols[i, j][real]] = True
    return mask


def predicted_density(a: TiledBSR, b: TiledBSR) -> float:
    """Predicted block density of C = A @ B, from block masks alone.

    The cheap prefix of the symbolic phase — one boolean mask product, no
    pair lists — enough for the ``output="auto"`` decision, so a product
    that resolves to a dense output never pays for pair-list
    construction.  Equals ``symbolic_spgemm(a, b).density()`` exactly.
    """
    _validate_pair(a, b)
    ma = _global_mask(extract_structure(a)).astype(np.float32)
    mb = _global_mask(extract_structure(b)).astype(np.float32)
    return float(((ma @ mb) > 0).mean())


def symbolic_spgemm(a: TiledBSR, b: TiledBSR,
                    capacity: Optional[int] = None) -> SymbolicProduct:
    """Run the symbolic phase for distributed C = A @ B.

    Host numpy after one read of each operand's block mask (see
    :func:`extract_structure`); no grid of devices is needed.  ``capacity`` pins the C tile capacity
    (must cover the prediction); by default the minimal capacity is
    derived and rounded up to a 1.25x bucket
    (:func:`repro_torch.core.grid.bucket_capacity`), like sparse operand
    handles.
    """
    _validate_pair(a, b)
    sa, sb = extract_structure(a), extract_structure(b)
    g = a.grid_shape[0]
    bs = a.block_size
    nbr, nbc = sa.tile_nbr, sb.tile_nbc

    # Pass 1: per-tile block masks of C (union of structural products over
    # k) and the raw per-k matches, kept for pass 2.
    matches: Dict[Tuple[int, int, int], tuple] = {}
    counts = np.zeros((g, g), dtype=np.int64)
    real_rc: Dict[Tuple[int, int], tuple] = {}
    for i in range(g):
        for j in range(g):
            mask = np.zeros((nbr, nbc), dtype=bool)
            for k in range(g):
                ra = np.nonzero(sa.real[i, k])[0]
                rb = np.nonzero(sb.real[k, j])[0]
                ai, bj = match_block_pairs(sa.cols[i, k][ra],
                                           sb.rows[k, j][rb])
                pa, pb = ra[ai], rb[bj]
                orow = sa.rows[i, k][pa].astype(np.int64)
                ocol = sb.cols[k, j][pb].astype(np.int64)
                matches[i, j, k] = (pa, pb, orow, ocol)
                mask[orow, ocol] = True
            rr, cc = np.nonzero(mask)        # row-major => (row, col) sorted
            real_rc[i, j] = (rr, cc)
            counts[i, j] = len(rr)

    max_nnzb = int(counts.max())
    if capacity is None:
        capacity = bucket_capacity(max_nnzb)
    elif capacity < max_nnzb:
        raise ValueError(f"capacity {capacity} < predicted max tile nnzb "
                         f"{max_nnzb}")
    # a structurally empty product keeps capacity 0 (coverage blocks only)
    capacity = int(capacity)
    store = capacity + nbr

    # Pass 2: packed C layout (mirrors BSR.from_dense padding +
    # bsr._augment_tile coverage merge, so the result satisfies the
    # TiledBSR storage contract) and slot-mapped pair lists.
    c_rows = np.zeros((g, g, store), dtype=np.int32)
    c_cols = np.zeros((g, g, store), dtype=np.int32)
    c_real = np.zeros((g, g, store), dtype=bool)
    raw_pairs: Dict[Tuple[int, int, int], tuple] = {}
    max_pairs = 0
    for i in range(g):
        for j in range(g):
            rr, cc = real_rc[i, j]
            nnzb = len(rr)
            rows_full = np.zeros(capacity, dtype=np.int64)
            cols_full = np.zeros(capacity, dtype=np.int64)
            rows_full[:nnzb], cols_full[:nnzb] = rr, cc
            if nnzb:                         # keep padding sorted
                rows_full[nnzb:] = rr[-1]
                cols_full[nnzb:] = cc[-1]
            cov = np.arange(nbr, dtype=np.int64)
            rows_aug = np.concatenate([rows_full, cov])
            order = np.argsort(rows_aug, kind="stable")
            c_rows[i, j] = rows_aug[order]
            c_cols[i, j] = np.concatenate(
                [cols_full, np.zeros(nbr, np.int64)])[order]
            inv = np.empty(store, dtype=np.int64)
            inv[order] = np.arange(store)
            c_real[i, j, inv[:nnzb]] = True
            slot_lookup = np.full(nbr * nbc, -1, dtype=np.int64)
            slot_lookup[rr * nbc + cc] = inv[:nnzb]
            for k in range(g):
                pa, pb, orow, ocol = matches[i, j, k]
                ps = slot_lookup[orow * nbc + ocol]
                by_slot = np.argsort(ps, kind="stable")
                pa, pb, ps = pa[by_slot], pb[by_slot], ps[by_slot]
                # one coverage pair per slot (inert: both zero slots), so
                # the packed kernel's first-visit zeroing initializes every
                # slot; merged in slot order, real pairs first per slot.
                za, zb = sa.zero_slot[i, k], sb.zero_slot[k, j]
                ps_all = np.concatenate([ps, np.arange(store)])
                merge = np.argsort(ps_all, kind="stable")
                raw_pairs[i, j, k] = (
                    np.concatenate([pa, np.full(store, za)])[merge],
                    np.concatenate([pb, np.full(store, zb)])[merge],
                    ps_all[merge], len(pa))
                max_pairs = max(max_pairs, len(pa) + store)

    pair_cap = bucket_capacity(max_pairs)
    pair_a = np.zeros((g, g, g, pair_cap), dtype=np.int32)
    pair_b = np.zeros((g, g, g, pair_cap), dtype=np.int32)
    pair_slot = np.zeros((g, g, g, pair_cap), dtype=np.int32)
    n_real = np.zeros((g, g, g), dtype=np.int64)
    for (i, j, k), (pa, pb, ps, nr) in raw_pairs.items():
        n = len(pa)
        pair_a[i, j, k, :n] = pa
        pair_b[i, j, k, :n] = pb
        pair_slot[i, j, k, :n] = ps
        # inert padding: zero slots of both operands, last output slot
        # (keeps pair_slot nondecreasing)
        pair_a[i, j, k, n:] = sa.zero_slot[i, k]
        pair_b[i, j, k, n:] = sb.zero_slot[k, j]
        pair_slot[i, j, k, n:] = store - 1
        n_real[i, j, k] = nr

    return SymbolicProduct(
        g=g, block_size=bs, tile_nbr=nbr, tile_nbc=nbc,
        shape=(a.shape[0], b.shape[1]), capacity=capacity,
        c_rows=c_rows, c_cols=c_cols, c_real=c_real,
        c_counts=counts.astype(np.int32),
        pair_a=pair_a, pair_b=pair_b, pair_slot=pair_slot,
        n_real_pairs=n_real,
        a_fingerprint=sa.fingerprint, b_fingerprint=sb.fingerprint,
        a_zero_slot=sa.zero_slot.astype(np.int64),
        b_zero_slot=sb.zero_slot.astype(np.int64))
