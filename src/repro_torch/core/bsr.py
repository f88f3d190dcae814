"""Block-sparse (BSR) matrices as tensors, and generators.

Port of ``repro/core/bsr.py``.  Nonzeros are grouped into dense
``bs x bs`` blocks (bs = 128 in production, smaller in tests) and sparsity
lives at block granularity.

* :class:`BSR` — one flat, padded block list sorted by block row.
* :class:`TiledBSR` — a ``grid.rows x grid.cols`` grid of equally padded,
  coverage-augmented BSR tiles, stacked into ``[gr, gc, store_cap, bs, bs]``
  tensors.  The executor keeps this whole stack on one card.

The structure (``rows``, ``cols``, ``counts``, ``capacity``,
``store_capacity``, the balance permutations) is computed on the host in
numpy exactly as the JAX package computes it, so both packages see the
same tiles; only the block values move to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.ref import densify_raw
from ..runtime.device import as_tensor, resolve_device
from .grid import ProcessGrid, bucket_capacity, ceil_div, pad_to_multiple
from .schedule import balance_row_perm

__all__ = ["BSR", "TiledBSR", "layout_real_slots", "rmat_edges",
           "rmat_matrix", "random_sparse"]


def _host_array(dense) -> np.ndarray:
    """numpy view of a dense operand (bf16 tensors widen to float32, which
    holds every bf16 value exactly)."""
    if isinstance(dense, torch.Tensor):
        dense = dense.detach().cpu()
        if dense.dtype == torch.bfloat16:
            dense = dense.float()
        return dense.numpy()
    return np.asarray(dense)


def _block_view(padded: np.ndarray, bs: int) -> np.ndarray:
    """``[nbr, nbc, bs, bs]`` view of a matrix whose dims are multiples of bs."""
    m, n = padded.shape
    return padded.reshape(m // bs, bs, n // bs, bs).transpose(0, 2, 1, 3)


def _nonzero_blocks(view: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Row-major (block-row, block-col) of the blocks holding data."""
    mask = np.abs(view).sum(axis=(2, 3)) != 0
    return np.nonzero(mask)


@dataclasses.dataclass
class BSR:
    """Flat padded block-sparse matrix.

    blocks : [capacity, bs, bs]  dense data per stored block (zeros pad)
    rows   : int32[capacity]     block-row of each stored block, sorted
    cols   : int32[capacity]     block-col of each stored block
    shape  : (m, n) padded shape (multiples of bs)
    nnzb   : number of real blocks (<= capacity)

    Blocks beyond the real ones are zero, so scatter-add consumers need no
    masking.  A tile taken from a :class:`TiledBSR` interleaves zero
    coverage blocks with the real ones, so ``nnzb`` is not a prefix length.
    """

    blocks: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    shape: Tuple[int, int]
    block_size: int
    nnzb: int
    logical_shape: Optional[Tuple[int, int]] = None

    @property
    def capacity(self) -> int:
        return self.blocks.shape[0]

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.block_size

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.block_size

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def block_fill_ratio(self) -> float:
        """Fraction of stored block entries that are nonzero (1.0 = perfect).

        Computed over the blocks holding any nonzero (so it is also right
        for the interleaved tiles of :meth:`TiledBSR.tile`); zero padding
        and coverage blocks never count against the ratio.
        """
        b = self.blocks.detach().cpu()
        nz_blocks = int((b.abs().sum(dim=(1, 2)) != 0).sum())
        denom = max(nz_blocks, 1) * self.block_size**2
        return float(torch.count_nonzero(b)) / float(denom)

    def flops(self, n_cols_dense: int) -> int:
        """Flops of BSR @ dense-with-n_cols (2*nnzb*bs^2*n)."""
        return 2 * self.nnzb * self.block_size**2 * n_cols_dense

    @classmethod
    def from_dense(cls, dense, block_size: int,
                   capacity: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> "BSR":
        device = resolve_device(device)
        dense = _host_array(dense)
        m, n = dense.shape
        bs = block_size
        mp, np_ = pad_to_multiple(m, bs), pad_to_multiple(n, bs)
        padded = np.zeros((mp, np_), dtype=dense.dtype)
        padded[:m, :n] = dense
        view = _block_view(padded, bs)
        rr, cc = _nonzero_blocks(view)
        nnzb = len(rr)
        cap = capacity if capacity is not None else nnzb
        if nnzb > cap:
            raise ValueError(f"capacity {cap} < nnzb {nnzb}")
        blocks = np.zeros((cap, bs, bs), dtype=dense.dtype)
        rows = np.zeros((cap,), dtype=np.int32)
        cols = np.zeros((cap,), dtype=np.int32)
        blocks[:nnzb] = view[rr, cc]
        rows[:nnzb] = rr
        cols[:nnzb] = cc
        if nnzb > 0:  # keep padding sorted: repeat the last (row, col)
            rows[nnzb:] = rr[-1]
            cols[nnzb:] = cc[-1]
        return cls(blocks=as_tensor(blocks, device, dtype),
                   rows=as_tensor(rows, device), cols=as_tensor(cols, device),
                   shape=(mp, np_), block_size=bs, nnzb=nnzb,
                   logical_shape=(m, n))

    @classmethod
    def from_scipy(cls, sp_mat, block_size: int,
                   capacity: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> "BSR":
        """From a scipy sparse matrix (any format), through its dense
        form, as the JAX package's ``BSR.from_scipy``."""
        import scipy.sparse as sps

        return cls.from_dense(sps.csr_matrix(sp_mat).toarray(), block_size,
                              capacity, dtype, device)

    def to_dense(self) -> torch.Tensor:
        return densify_raw(self.blocks, self.rows, self.cols,
                           self.n_block_rows, self.n_block_cols)

    def with_capacity(self, capacity: int) -> "BSR":
        """Re-pad to a new (>= current) capacity; shrinking is refused."""
        pad = capacity - self.capacity
        if pad == 0:
            return self
        if pad < 0:
            raise ValueError(
                f"cannot shrink capacity {self.capacity} -> {capacity}: "
                "stored blocks are not necessarily a prefix; rebuild with "
                "from_dense(capacity=...) instead")
        bs = self.block_size
        last_r = self.rows[-1:] if self.capacity else \
            torch.zeros(1, dtype=torch.int32, device=self.device)
        last_c = self.cols[-1:] if self.capacity else \
            torch.zeros(1, dtype=torch.int32, device=self.device)
        blocks = torch.cat([self.blocks, self.blocks.new_zeros((pad, bs, bs))])
        rows = torch.cat([self.rows, last_r.expand(pad)])
        cols = torch.cat([self.cols, last_c.expand(pad)])
        return BSR(blocks, rows, cols, self.shape, bs, self.nnzb,
                   self.logical_shape)


@dataclasses.dataclass
class TiledBSR:
    """A grid of uniformly padded, coverage-augmented BSR tiles.

    blocks : [gr, gc, store_cap, bs, bs]  (store_cap = capacity + tile nbr)
    rows   : int32[gr, gc, store_cap]  block-row within the tile, sorted;
                                       every block-row present at least once
    cols   : int32[gr, gc, store_cap]  block-col within the tile
    counts : int32[gr, gc]             real blocks per tile

    One zero block per block-row is merged into every tile's list at
    construction (the JAX package's ``_augment_tile``), so the ring bodies
    consume the stored arrays as they are.  ``capacity`` counts real block
    slots only.  ``row_block_perm`` / ``col_block_perm`` record a
    balancing permutation of the global row / column blocks (position
    ``t`` holds original block ``perm[t]``), undone by the plan.
    """

    blocks: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    counts: torch.Tensor
    shape: Tuple[int, int]      # padded global shape
    block_size: int
    grid_shape: Tuple[int, int]
    capacity: int
    logical_shape: Optional[Tuple[int, int]] = None
    row_block_perm: Optional[Tuple[int, ...]] = None
    col_block_perm: Optional[Tuple[int, ...]] = None

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return (self.shape[0] // self.grid_shape[0],
                self.shape[1] // self.grid_shape[1])

    @property
    def store_capacity(self) -> int:
        """Stored block slots per tile: capacity + coverage augmentation."""
        return self.blocks.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @classmethod
    def from_dense(cls, dense, grid: ProcessGrid, block_size: int,
                   capacity=None, dtype: Optional[torch.dtype] = None,
                   balance: str = "none", device=None) -> "TiledBSR":
        """Tile a dense array into uniformly padded BSR tiles on ``device``.

        ``capacity`` is the uniform real-block capacity: an int pins it,
        ``None`` takes the minimum (max tile nnzb), ``"bucket"`` rounds the
        minimum up to the next 1.25x bucket.  ``balance`` permutes global
        row blocks (``"rows"``), column blocks (``"cols"``) or whichever
        shrinks the capacity more (``"auto"``); an axis is kept only when
        it strictly shrinks the capacity.

        The blocks take ``dtype``, else the input's own type (a numpy
        ``bfloat16`` array stays bfloat16).  The input is tiled on
        ``device``: only its block mask goes to the host, where the layout
        is built and kept with the mask (:meth:`host`).
        """
        if balance not in ("none", "rows", "cols", "auto"):
            raise ValueError(f"unknown balance {balance!r}; one of "
                             "('none', 'rows', 'cols', 'auto')")
        device = resolve_device(device)
        dense = dense.detach().to(device) if isinstance(dense, torch.Tensor) \
            else as_tensor(np.asarray(dense), device)
        bs = block_size
        m, n = dense.shape
        tm = pad_to_multiple(ceil_div(m, grid.rows), bs)
        tn = pad_to_multiple(ceil_div(n, grid.cols), bs)
        mp, np_ = tm * grid.rows, tn * grid.cols
        padded = dense
        if (mp, np_) != (m, n):
            padded = dense.new_zeros((mp, np_))
            padded[:m, :n] = dense
        view = padded.reshape(mp // bs, bs, np_ // bs, bs).transpose(1, 2)
        # a block holds data when any element is nonzero (NaN included);
        # the same pass counts the nonzero elements (the fill)
        per_block = _nonzeros_per_block(view)
        mask = per_block > 0
        src_row = np.arange(mp // bs)
        src_col = np.arange(np_ // bs)
        perm = col_perm = None
        if balance != "none":
            mask, perm, col_perm = _balance(mask, grid, balance)
            if perm is not None:
                src_row = np.asarray(perm)
            if col_perm is not None:
                src_col = np.asarray(col_perm)
        nbr, nbc = tm // bs, tn // bs
        tiles = [[np.nonzero(mask[i * nbr:(i + 1) * nbr,
                                  j * nbc:(j + 1) * nbc])
                  for j in range(grid.cols)] for i in range(grid.rows)]
        max_nnzb = max(len(rr) for row in tiles for rr, _ in row)
        if capacity == "bucket":
            cap = bucket_capacity(max_nnzb)
        else:
            if capacity is not None and capacity < max_nnzb:
                raise ValueError(
                    f"capacity {capacity} < max tile nnzb {max_nnzb}")
            cap = capacity if capacity is not None else max_nnzb
        store = cap + nbr
        rows = np.zeros((grid.rows, grid.cols, store), np.int32)
        cols = np.zeros((grid.rows, grid.cols, store), np.int32)
        counts = np.zeros((grid.rows, grid.cols), np.int32)
        gather = []         # (tile i, tile j, slot, source block-row, -col)
        for i in range(grid.rows):
            for j in range(grid.cols):
                rr, cc = tiles[i][j]
                order, rows[i, j], cols[i, j] = _augmented_layout(
                    rr, cc, cap, nbr)
                # real block k of the tile lands where the stable sort put
                # list position k; padding and coverage slots stay zero
                dest = np.nonzero(order < len(rr))[0]
                src = order[dest]
                gather.append(np.stack([
                    np.full(len(dest), i), np.full(len(dest), j), dest,
                    src_row[rr[src] + i * nbr], src_col[cc[src] + j * nbc]]))
                counts[i, j] = len(rr)
        gi, gj, slot, br, bc = np.concatenate(gather, axis=1)
        idx = torch.as_tensor(np.stack([gi, gj, slot, br, bc]), device=device)
        blocks = torch.zeros((grid.rows, grid.cols, store, bs, bs),
                             dtype=dtype or view.dtype, device=device)
        blocks[idx[0], idx[1], idx[2]] = view[idx[3], idx[4]].to(blocks.dtype)
        if blocks.dtype == view.dtype:
            real = np.zeros((grid.rows, grid.cols, store), bool)
            real[gi, gj, slot] = True
            nnz = int(per_block.sum())
        else:
            # a cast may round a block to zero: test the stored blocks
            real, nnz = _real_mask(blocks)
        out = cls(blocks=blocks, rows=as_tensor(rows, device),
                  cols=as_tensor(cols, device),
                  counts=as_tensor(counts, device), shape=(mp, np_),
                  block_size=bs, grid_shape=(grid.rows, grid.cols),
                  capacity=cap, logical_shape=(m, n), row_block_perm=perm,
                  col_block_perm=col_perm)
        out.host_layout = {"rows": rows, "cols": cols, "counts": counts,
                           "real": real, "nnz": nnz}
        return out

    def to_dense(self) -> torch.Tensor:
        gr, gc = self.grid_shape
        tm, tn = self.tile_shape
        bs = self.block_size
        s = self.store_capacity
        d = densify_raw(self.blocks.reshape(gr * gc, s, bs, bs),
                        self.rows.reshape(gr * gc, s),
                        self.cols.reshape(gr * gc, s), tm // bs, tn // bs)
        return d.reshape(gr, gc, tm, tn).permute(0, 2, 1, 3).reshape(
            self.shape)

    def tile(self, i: int, j: int) -> BSR:
        """View tile (i, j) as a flat BSR (coverage blocks interleaved)."""
        return BSR(self.blocks[i, j], self.rows[i, j], self.cols[i, j],
                   self.tile_shape, self.block_size, int(self.counts[i, j]))

    def real_slots(self) -> np.ndarray:
        """bool ``[gr, gc, store_cap]``: the stored slots that hold real
        blocks, read off the storage layout (host numpy; the blocks are not
        read).  See :func:`layout_real_slots`."""
        gr, gc = self.grid_shape
        s = self.store_capacity
        host = self.host()
        real = layout_real_slots(host["rows"].reshape(-1, s),
                                 host["counts"].reshape(-1),
                                 self.tile_shape[0] // self.block_size)
        return real.reshape(gr, gc, s)

    def host(self) -> dict:
        """Host numpy ``rows``, ``cols``, ``counts`` and ``real`` (the
        slots whose block holds data: any element nonzero, NaN included,
        the JAX package's ``|block|.sum() != 0``), kept from
        :meth:`from_dense`, else read from the device once; ``nnz``, the
        nonzero elements, counted in the pass that finds ``real`` (absent
        where a layout was given without one, as a sparse product's)."""
        h = getattr(self, "host_layout", None)
        if h is None:
            real, nnz = _real_mask(self.blocks)
            h = self.host_layout = {
                "rows": self.rows.cpu().numpy(),
                "cols": self.cols.cpu().numpy(),
                "counts": self.counts.cpu().numpy(),
                "real": real, "nnz": nnz}
        return h

    def fill(self) -> Optional[float]:
        """The nonzero elements over the real blocks' slots (real blocks x
        bs^2), from :meth:`host`, counted once and kept there; None where
        the layout came without a count (no device pass is made for it)."""
        h = self.host()
        if "fill" not in h:
            nnz = h.get("nnz")
            slots = int(np.count_nonzero(h["real"])) * self.block_size ** 2
            h["fill"] = None if nnz is None else (nnz / slots if slots
                                                  else 0.0)
        return h["fill"]

    def load_imbalance(self) -> float:
        """max/avg real-block count over tiles — the paper's Table 1 metric."""
        c = self.counts.double().cpu().numpy()
        avg = c.mean()
        return float(c.max() / avg) if avg > 0 else 1.0

    def padded_flop_waste(self) -> float:
        """Fraction of executed block products that multiply padding."""
        c = self.counts.double().cpu().numpy()
        total = self.capacity * c.size
        return float(1.0 - c.sum() / total) if total else 0.0


# elements of a block view tested for nonzeros at once: the pass holds a
# bool mask and an int32 copy of this many, never of the whole matrix
COUNT_SLAB = 1 << 26


def _nonzeros_per_block(view: torch.Tensor) -> np.ndarray:
    """Host int32 ``[R, C]``: the nonzero elements (NaN included) of each
    ``bs x bs`` block of ``view [R, C, bs, bs]`` (any strides), counted on
    its device a slab of ``R`` at a time and copied to the host once."""
    per = int(np.prod(view.shape[1:]))
    step = max(1, COUNT_SLAB // max(per, 1))
    counts = [torch.ne(view[i:i + step], 0).sum(dim=(2, 3),
                                                 dtype=torch.int32)
              for i in range(0, view.shape[0], step)]
    if not counts:
        return np.zeros(view.shape[:2], np.int32)
    return torch.cat(counts).cpu().numpy()


def _real_mask(blocks: torch.Tensor) -> Tuple[np.ndarray, int]:
    """Host bool ``[..., store]`` mask of the stored blocks holding data,
    and their nonzero elements in all."""
    bs = blocks.shape[-1]
    per_block = _nonzeros_per_block(blocks.reshape(-1, 1, bs, bs)) \
        .reshape(blocks.shape[:-2])
    return per_block > 0, int(per_block.sum())


def _balance(mask: np.ndarray, grid: ProcessGrid, balance: str):
    """The capacity-shrinking block permutation of ``balance``.

    ``mask`` is the global block mask.  Returns ``(mask, row_perm,
    col_perm)``: the mask permuted, and at most one permutation set, as
    tuples of ints (the JAX package's meta fields; position ``t`` holds
    original block ``perm[t]``).
    """
    nbr_global, nbc_global = mask.shape

    def tile_cap(msk):
        per_tile = msk.reshape(grid.rows, nbr_global // grid.rows,
                               grid.cols, nbc_global // grid.cols)
        return int(per_tile.sum(axis=(1, 3)).max())

    # balance_row_perm equalizes grid-row (or grid-column) totals, but the
    # capacity is the per-tile max, which a permutation can worsen: keep an
    # axis only when it strictly shrinks it; "auto" prefers rows on ties
    best_cap = tile_cap(mask)
    best_axis = perm = col_perm = None
    if balance in ("rows", "auto"):
        p = balance_row_perm(mask.sum(axis=1), grid.rows)
        c = tile_cap(mask[np.asarray(p)])
        if c < best_cap:
            best_axis, best_cap, perm = "rows", c, p
    if balance in ("cols", "auto"):
        p = balance_row_perm(mask.sum(axis=0), grid.cols)
        c = tile_cap(mask[:, np.asarray(p)])
        if c < best_cap:
            best_axis, best_cap, col_perm = "cols", c, p
    if best_axis == "rows":
        return mask[np.asarray(perm)], tuple(int(p) for p in perm), None
    if best_axis == "cols":
        return (mask[:, np.asarray(col_perm)], None,
                tuple(int(p) for p in col_perm))
    return mask, None, None


def _augmented_layout(rr: np.ndarray, cc: np.ndarray, cap: int, nbr: int):
    """Stored slot order of one tile: real blocks padded to ``cap`` (padding
    repeats the last (row, col)), then one zero coverage block per
    block-row merged in by a stable sort on the row.

    Returns ``(order, rows, cols)``: slot ``p`` holds list entry
    ``order[p]`` (entries ``>= len(rr)`` are zero blocks).
    """
    nnzb = len(rr)
    rows = np.zeros(cap, np.int32)
    cols = np.zeros(cap, np.int32)
    rows[:nnzb] = rr
    cols[:nnzb] = cc
    if nnzb > 0:
        rows[nnzb:] = rr[-1]
        cols[nnzb:] = cc[-1]
    rows_aug = np.concatenate([rows, np.arange(nbr, dtype=np.int32)])
    order = np.argsort(rows_aug, kind="stable")
    cols_aug = np.concatenate([cols, np.zeros(nbr, np.int32)])
    return order, rows_aug[order], cols_aug[order]


def layout_real_slots(rows: np.ndarray, counts: np.ndarray,
                      nbr: int) -> np.ndarray:
    """The slots of row-sorted stored lists that hold real blocks.

    rows : int ``[T, S]`` as :func:`_augmented_layout` lays them out (and
    the symbolic phase's C layout), counts : int ``[T]`` real blocks per
    list.  In such a list block-row r's segment is r's real blocks in
    order, then, in the row of the last real block (row 0 without one),
    the ``S - nbr - count`` padding blocks, then r's coverage zero.  So the
    real blocks are the first ``k_r`` slots of each segment, ``k_r`` its
    length less one and, in the padding's row, less the padding.  Returns
    bool ``[T, S]``; raises where the lists do not have that layout.
    """
    rows = np.asarray(rows, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    t, s = rows.shape
    pad = s - nbr - counts
    if rows.size and (rows.min() < 0 or rows.max() >= nbr
                      or (np.diff(rows, axis=1) < 0).any()):
        raise ValueError("stored rows are not row-sorted block-rows of the "
                         "tile")
    seg = np.bincount((np.arange(t)[:, None] * nbr + rows).ravel(),
                      minlength=t * nbr).reshape(t, nbr)
    longer = seg > 1
    pad_row = np.where(longer.any(axis=1),
                       nbr - 1 - np.argmax(longer[:, ::-1], axis=1), 0)
    k = seg - 1
    k[np.arange(t), pad_row] -= pad
    if (seg < 1).any() or (k < 0).any() or (pad < 0).any():
        raise ValueError("stored lists do not follow the TiledBSR storage "
                         "layout (real blocks, padding in the last real "
                         "row, one coverage block per block-row)")
    start = np.cumsum(seg, axis=1) - seg
    pos = np.arange(s)[None, :] - np.take_along_axis(start, rows, axis=1)
    return pos < np.take_along_axis(k, rows, axis=1)


# --------------------------------------------------------------------------
# Generators (seeded numpy, drawing the JAX package's numbers)
# --------------------------------------------------------------------------
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


def rmat_matrix(scale: int, edgefactor: int = 8, seed: int = 0,
                dtype=np.float32, **kw) -> np.ndarray:
    """Dense numpy adjacency matrix from R-MAT edges."""
    n = 1 << scale
    e = rmat_edges(scale, edgefactor, seed=seed, **kw)
    m = np.zeros((n, n), dtype=dtype)
    m[e[:, 0], e[:, 1]] = 1.0
    return m


def random_sparse(m: int, n: int, density: float, seed: int = 0,
                  dtype=np.float32) -> np.ndarray:
    """Uniform random sparse dense-array (for tests/benchmarks)."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((m, n)).astype(dtype)
    mask = rng.random((m, n)) < density
    return mat * mask
