"""Wrapper of the hand-written CUDA BSR SpMM kernel (``csrc/bsr_spmm.cu``).

Counterpart of ``repro/kernels/bsr_spmm.py::bsr_spmm_pallas``.  One launch
multiplies every output tile of a ring step, over the real blocks alone:
the work is a :class:`SpmmTable`, built on the host by :func:`spmm_table`
from each output tile's block list, its real mask and the step's tile
maps.  The kernel reads A's blocks through pool slots and each output
tile's B through its B tile index, so a ring step on one card copies
neither operand.  Plans build the tables once per ring step
(``MatmulPlan.spmm_table``); a raw call builds one from its lists, every
listed block counting as real.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.bsr_spmm_raw_ref`.

The result is the plain version's on any B, finite or not: a listed block
left out (a zero block: padding, coverage, a dummy pair) gives NaN in its
block-row wherever its B chunk holds an inf or a NaN, as the reference's
``0 * inf`` does.  The table keeps those entries (``skip``), and each
launch ends with a pass that flags the non-finite columns of their chunks
on the card and writes the NaNs (nothing but the flags on finite B).

Two paths multiply a table's real blocks, one algorithm: the block path
multiplies every slot of each real block; the element path
(:class:`ElementTable`) only the nonzero elements, a row gather over
each row's nonzeros with the same sums.  A plan picks the element path
for a handle whose real blocks are nearly empty (:func:`pick_path`, from
the fill counted with the real mask) and builds the handle's element
lists once (:func:`element_lists`).  The element path's NaN pass also
writes the NaNs of the zero slots it skipped inside real blocks.  Raw
calls (``ops.bsr_spmm_raw`` without a plan's table, steal3d's pair lists)
have no handle to cache the lists on and take the block path.

A third path, the sparse-B path (:class:`SparseBTable`), takes a B that is
itself a nearly empty block-sparse handle: a dense-output SpGEMM whose B
would otherwise be densified every multiply.  It multiplies A's nonzeros
by B's (both handles' element lists, B's rows sorted by column) and adds
each product into C, with the result of A's real blocks times the
densified B on any input, finite or not.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import loader

__all__ = ["SpmmTable", "PoolLists", "ElementLists", "ElementTable",
           "SparseBTable", "spmm_table", "element_lists", "sparse_b_windows",
           "pick_path", "bsr_spmm_cuda", "nan_pass", "kernel_path", "CHUNK",
           "ELEMENT_FILL", "SB_WINDOW"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Real blocks per chunk: one unit of the kernel multiplies at most this
# many blocks of one block-row segment (the kernel's MAX_CHUNK).  A tile
# row holds at most nbc real blocks, 128 at both main-path shapes, so
# their segments stay whole: no partials, no reduce pass.
CHUNK = 128

# A handle whose nonzero elements fill less than this share of its real
# blocks' slots runs the element path, the rest the block path.  A
# conservative choice below every crossover measured on the H100, not a
# crossover itself: one launch of the element path was the faster up to
# ~15 % fill at bs 128 in float32, ~3.5 % in bf16, and at every fill
# measured at bs 8 (PERF.md, section 6).  But a handle pays its element
# lists' build once, and serving tiles its bs 8 operators afresh every
# step: there the build (~2 ms a handle) made a whole step 2.3-2.8 times
# slower on the element path.  A real bs 8 block is at least 1/64 full, so
# such handles keep the block path.
ELEMENT_FILL = 0.01

# The element path's units: rows of one block-row segment whose entries (one
# more a row, for its store) add up to about UNIT_WORK, at most UNIT_ROWS
# rows; a row of more than SPLIT_ROW entries is a unit alone, split over
# the thread block.  Tuned on the H100 at the cells' shapes (PERF.md,
# section 6).
UNIT_WORK = 256
UNIT_ROWS = 128
SPLIT_ROW = 64

# Pool elements the element lists' build tests for nonzeros at once.
BUILD_SLICE = 1 << 27

# The sparse-B path's units: a warp sums SB_WINDOW columns of a C row at a
# time (the kernel's SB_WINDOW, which the launch checks), the SB_WARPS warps
# of a thread block the windows of one unit; a row of more than SB_SPLIT
# products is cut into units of SB_WARPS windows, so a hub row spreads
# over several thread blocks.
SB_WINDOW = 1024
SB_WARPS = 8
SB_SPLIT = 4096


def pick_path(fill: Optional[float]) -> str:
    """``"elements"`` for a handle whose fill (nonzero elements over its
    real blocks' slots) is under :data:`ELEMENT_FILL`, else ``"blocks"``;
    an unknown fill (None: a layout given without a count) takes the block
    path."""
    return "elements" if fill is not None and fill < ELEMENT_FILL \
        else "blocks"


@dataclasses.dataclass(frozen=True)
class ElementLists:
    """The nonzero elements of an A pool's real blocks, row by row, on the
    device (built once per handle, placement and wire by
    :func:`element_lists`).

    Row ``x`` of pool tile ``q`` (of ``R = nbr * bs`` rows a tile) holds
    entries ``rowptr[q * R + x] : rowptr[q * R + x + 1]``, in the block
    path's order (the list's real blocks in list order, then the column in
    the block): ``brow`` int32, the B row inside the B tile (block column *
    bs + c), and ``aoff`` int64, the pool element that holds A's value
    (pool slot * bs^2 + r * bs + c).  A launch reads the values there, as
    the block path reads its blocks: only the positions of the nonzeros are
    fixed per handle, as its real mask is.  ``row_nnz`` (host int64 ``[P,
    R]``) is each row's entry count; ``pool_shape`` the pool's.
    ``cols_sorted``: whether every row's ``brow`` rises strictly (a B
    handle's lists, read by the sparse-B path, must).
    """
    key: tuple
    rowptr: torch.Tensor
    brow: torch.Tensor
    aoff: torch.Tensor
    row_nnz: np.ndarray
    pool_shape: tuple
    n_block_rows: int
    max_brow: int
    cols_sorted: bool

    @property
    def n_elements(self) -> int:
        return int(self.brow.shape[0])


@dataclasses.dataclass(frozen=True)
class ElementTable:
    """The element path's work split of one launch, beside the block
    table's lists (:attr:`SpmmTable.elements`).

    ``units`` int32 ``[6, U]``: output tile, pool tile, B tile, first row
    (of the tile's ``nbr * bs``), rows and blocks credited to the block
    counter, of each unit: a run of rows of one visited block-row, about
    :data:`UNIT_WORK` entries, by tile and then most entries first; the
    units cover every row of every block-row a real block visits, once.
    ``segs`` int32 ``[6, NS]``: tile, block-row, pool tile, B tile and the
    first and end index into ``seg_chunks`` of each visited block-row;
    ``seg_chunks`` int32 the B chunk (into ``flag_chunks``) of each of its
    real blocks.  ``flag_chunks`` int32 ``[2, F]``: B tile and block column
    of every chunk a real block reads or a skipped entry names, the
    table's ``skip_chunks`` first.  ``n_elements``: the nonzeros the launch
    multiplies.
    """
    lists: ElementLists
    units: torch.Tensor
    segs: torch.Tensor
    seg_chunks: torch.Tensor
    flag_chunks: torch.Tensor
    n_elements: int


@dataclasses.dataclass(frozen=True)
class SparseBTable:
    """The sparse-B path's work of one launch, beside the block table's
    lists (:attr:`SpmmTable.sparse_b`): output tile ``t`` multiplies the
    nonzeros of A pool tile ``maps[0, t]`` (``a_lists``) by those of B pool
    tile ``maps[1, t]`` (``b_lists``, whose ``brow`` are C's columns, each
    row sorted) into ``[T, R, n]``.

    ``units`` int32 ``[5, U]``: output tile, row, first and end window (of
    :data:`SB_WINDOW` columns) and the real blocks credited to the block
    counter, of each unit; the units cover the windows of every row that
    holds a nonzero of A, once, heaviest first.  ``zero_rows`` int32: ``t *
    R + r`` of every other row, which a fresh output zero-fills.
    ``windows`` int32 ``[Pb * K, nwin + 1]``: where each B row's entries of
    each window start, from the row's start (:func:`sparse_b_windows`).
    ``colptr`` int32 ``[T * span + 1]`` and ``col_ent`` int32 ``[2, X]``:
    the launch's listed A blocks by (tile, block column), as block-row and
    A pool slot (-1 for an entry the block table leaves out: a zero block),
    which the NaN pass of non-finite B values reads.  ``n_products``: the
    products the launch adds; ``extra_credit``: real blocks of block-rows
    with no nonzero, credited at the launch.
    """
    a_lists: ElementLists
    b_lists: ElementLists
    units: torch.Tensor
    zero_rows: torch.Tensor
    maps: torch.Tensor
    windows: torch.Tensor
    colptr: torch.Tensor
    col_ent: torch.Tensor
    span: int
    n: int
    n_products: int
    extra_credit: int


@dataclasses.dataclass(frozen=True)
class SpmmTable:
    """Work split of one B1 launch, over real blocks.

    ``ent`` is int32 ``[2, Q]``: the A pool slot and the block column of
    each real block, chunk by chunk.  ``chunks`` is int32 ``[6, C]``:
    output tile, first and end index into ``ent``, block-row, partial
    index (``-1`` for a segment's only chunk, which stores C itself) and
    the B tile of each chunk, by tile and then longest first.  ``reduce``
    is int32 ``[4, R]``: tile, block-row, first partial and number of
    partials of each segment cut into several chunks.  ``fill`` is int32
    ``[2, F]``: tile and block-row of each block-row that no real block
    visits, which a fresh output zero-fills.  ``skip`` is int32 ``[3,
    X]``: tile, block-row and B chunk index of the entries left out (one
    per tile, block-row and B chunk), and ``skip_chunks`` int32 ``[2,
    U]`` the B tile and block column of each such chunk: where a chunk's
    B rows hold an inf or a NaN, the kernel's NaN pass writes NaN into the
    block-rows that skip it.  ``n_parts`` partials of ``bs * n`` float32
    make the kernel's workspace.  ``max_slot``, ``max_col`` and
    ``max_b_tile`` (-1 when empty) let the wrapper check the operands
    against the table without reading it back.
    """
    ent: torch.Tensor
    chunks: torch.Tensor
    reduce: torch.Tensor
    fill: torch.Tensor
    skip: torch.Tensor
    skip_chunks: torch.Tensor
    n_parts: int
    tiles: int
    n_block_rows: int
    max_slot: int
    max_col: int
    max_b_tile: int
    elements: Optional[ElementTable] = None
    sparse_b: Optional[SparseBTable] = None

    @property
    def real_blocks(self) -> int:
        """Blocks the kernel multiplies (the real ones)."""
        return int(self.ent.shape[1])

    @property
    def path(self) -> str:
        """``"sparse_b"`` where the launch multiplies the real blocks'
        nonzeros by a sparse B's (:attr:`sparse_b`), ``"elements"`` where
        by a dense B's rows (:attr:`elements`), else ``"blocks"``."""
        if self.sparse_b is not None:
            return "sparse_b"
        return "blocks" if self.elements is None else "elements"

    def workspace_bytes(self, block_size: int, n: int) -> int:
        return self.n_parts * block_size * n * 4


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spmm_table(slots, rows, cols, n_block_rows: int, *, real=None,
               b_map=None, chunk: int = CHUNK, device=None,
               elements: Optional[ElementLists] = None,
               a_map=None, b_elements: Optional[ElementLists] = None,
               n: Optional[int] = None,
               windows: Optional[torch.Tensor] = None) -> SpmmTable:
    """Cut block lists into chunks of real blocks (host numpy).

    slots, rows, cols : int ``[T, L]`` (numpy or tensor): entry ``e`` of
    output tile ``t`` multiplies A pool block ``slots[t, e]`` into block-row
    ``rows[t, e]`` with B's block-row ``cols[t, e]``.  The lists need not be
    sorted: a stable sort by row keeps each row's blocks in list order.
    real : bool ``[T, L]`` or None (every entry real): the others (capacity
    padding, coverage zeros, dummy pairs: zero blocks) are left out of the
    multiply and kept for the NaN pass.  b_map : int ``[T]`` or None
    (the identity): the B tile of each output tile.  A block-row segment of
    ``L`` real blocks becomes ``ceil(L / chunk)`` chunks; the block-rows no
    real block visits are listed for the zero fill.  With ``elements``, the
    element lists of the pool that ``slots`` index, and ``a_map`` (``[T]``,
    the pool tile of each output tile), the table also carries the element
    path's split (:class:`ElementTable`); with ``b_elements`` too, the
    element lists of a sparse B pool whose tile ``b_map[t]`` is output tile
    ``t``'s B (``n`` columns), and their ``windows``
    (:func:`sparse_b_windows`), the sparse-B path's work
    (:class:`SparseBTable`) in its place.
    """
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"chunk must be in [1, {CHUNK}] (the kernel's "
                         f"chunk length), got {chunk}")
    slots, rows, cols = (_host(x).astype(np.int64) for x in (slots, rows,
                                                             cols))
    if slots.ndim != 2 or rows.shape != slots.shape \
            or cols.shape != slots.shape:
        raise ValueError(f"slots, rows and cols must be [T, L], got shapes "
                         f"{slots.shape}, {rows.shape}, {cols.shape}")
    t, length = slots.shape
    nbr = int(n_block_rows)
    if nbr < 1:
        raise ValueError(f"n_block_rows must be positive, got {nbr}")
    real = np.ones((t, length), dtype=bool) if real is None \
        else _host(real).astype(bool)
    if real.shape != (t, length):
        raise ValueError(f"real must be [T, L] = {(t, length)}, got shape "
                         f"{real.shape}")
    b_map = np.arange(t) if b_map is None else _host(b_map).astype(np.int64)
    if b_map.shape != (t,) or (t and b_map.min() < 0):
        raise ValueError(f"b_map must hold {t} nonnegative tile indices, got "
                         f"{b_map.shape}")
    q = np.flatnonzero(real.reshape(-1))          # real entries, tile-major
    q_tile = q // max(length, 1)
    q_row = rows.reshape(-1)[q]
    if q.size and (q_row.min() < 0 or q_row.max() >= nbr):
        raise ValueError(f"block-rows outside [0, {nbr})")
    if q.size and (cols.reshape(-1)[q].min() < 0
                   or slots.reshape(-1)[q].min() < 0):
        raise ValueError("negative slot or block column in the lists")
    key = q_tile * nbr + q_row
    order = np.argsort(key, kind="stable")
    q, key = q[order], key[order]
    if key.size:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    else:
        starts = np.zeros(0, np.int64)
    ends = np.r_[starts[1:], key.size].astype(np.int64)
    n_chunks = -(-(ends - starts) // chunk)
    seg = np.repeat(np.arange(len(starts)), n_chunks)
    first_chunk = np.cumsum(n_chunks) - n_chunks
    c_start = starts[seg] + (np.arange(len(seg)) - first_chunk[seg]) * chunk
    c_end = np.minimum(c_start + chunk, ends[seg])
    multi = n_chunks[seg] > 1
    part = np.full(len(seg), -1, np.int64)
    part[multi] = np.arange(int(multi.sum()))
    c_tile = key[c_start] // nbr
    chunks = np.stack([c_tile, c_start, c_end, key[c_start] % nbr,
                       part, b_map[c_tile]])
    # by tile, then longest first: long units start early, one tile's B
    # stays hot
    chunks = chunks[:, np.lexsort((c_start, c_start - c_end, c_tile))]
    segs_multi = np.flatnonzero(n_chunks > 1)
    r_key = key[starts[segs_multi]]
    reduce = np.stack([r_key // nbr, r_key % nbr,
                       part[first_chunk[segs_multi]], n_chunks[segs_multi]])
    visited = np.zeros(t * nbr, dtype=bool)
    visited[key[starts]] = True
    free = np.flatnonzero(~visited)
    fill = np.stack([free // nbr, free % nbr])
    ent = np.stack([slots.reshape(-1)[q], cols.reshape(-1)[q]])
    # the entries left out, one per (tile, block-row, B chunk); one that
    # names no block-row of C (or no B chunk) can put a NaN nowhere
    x = np.flatnonzero(~real.reshape(-1))
    x_row, x_col = rows.reshape(-1)[x], cols.reshape(-1)[x]
    keep = (x_row >= 0) & (x_row < nbr) & (x_col >= 0)
    x, x_row, x_col = x[keep], x_row[keep], x_col[keep]
    x_tile = x // max(length, 1)
    skip_chunks, x_chunk = np.unique(np.stack([b_map[x_tile], x_col]),
                                     axis=1, return_inverse=True)
    skip = np.unique(np.stack([x_tile, x_row, x_chunk.reshape(-1)]), axis=1)
    if max(int(x.max(initial=0)) for x in (ent, chunks, reduce, fill, skip,
                                           skip_chunks)) \
            > np.iinfo(np.int32).max:
        raise ValueError("block lists too long for the kernel's int32 table")
    as_i32 = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.int32)).to(device or "cpu")
    el = sb = None
    if elements is not None and b_elements is not None:
        sb = _sparse_b_table(elements, b_elements, windows, n,
                             _host(a_map).astype(np.int64), b_map, key,
                             ent, skip.reshape(3, -1),
                             skip_chunks.reshape(2, -1), nbr, as_i32)
    elif elements is not None:
        el = _element_table(elements, _host(a_map).astype(np.int64), b_map,
                            key, starts, ends, ent[1],
                            skip_chunks.reshape(2, -1), nbr, as_i32)
    return SpmmTable(ent=as_i32(ent), chunks=as_i32(chunks),
                     reduce=as_i32(reduce), fill=as_i32(fill),
                     skip=as_i32(skip.reshape(3, -1)),
                     skip_chunks=as_i32(skip_chunks.reshape(2, -1)),
                     n_parts=int(multi.sum()), tiles=t, n_block_rows=nbr,
                     max_slot=int(ent[0].max(initial=-1)),
                     max_col=max(int(ent[1].max(initial=-1)),
                                 int(x_col.max(initial=-1))),
                     max_b_tile=int(b_map.max(initial=-1)), elements=el,
                     sparse_b=sb)


def _element_table(lists: ElementLists, a_map: np.ndarray, b_map: np.ndarray,
                   key: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   ent_col: np.ndarray, skip_chunks: np.ndarray, nbr: int,
                   as_i32) -> ElementTable:
    """The element path's split of a launch whose real blocks, sorted by
    (tile, block-row), are ``key`` (tile * nbr + block-row), their
    segments ``[starts, ends)`` and their block columns ``ent_col``; pool
    tile ``a_map[t]`` and B tile ``b_map[t]`` of output tile t."""
    p, _, bs, _ = lists.pool_shape
    if lists.n_block_rows != nbr:
        raise ValueError(f"element lists of {lists.n_block_rows} block-rows "
                         f"a tile, the launch has {nbr}")
    if a_map.shape != b_map.shape or (a_map.size and (
            a_map.min() < 0 or a_map.max() >= p)):
        raise ValueError(f"a_map must name one of the {p} pool tiles for "
                         f"each of the {b_map.size} output tiles")
    seg_key = key[starts]
    seg_tile, seg_row = seg_key // nbr, seg_key % nbr
    seg_q, seg_bt = a_map[seg_tile], b_map[seg_tile]
    # every B chunk a real block reads, after the skipped entries' own
    span = int(max(ent_col.max(initial=0), skip_chunks[1].max(initial=0))) + 1
    code = b_map[key // nbr] * span + ent_col
    skip_code = skip_chunks[0] * span + skip_chunks[1]    # sorted, unique
    at = np.searchsorted(skip_code, code)
    found = at < skip_code.size
    found[found] = skip_code[at[found]] == code[found]
    new = np.unique(code[~found])
    chunk_of = np.where(found, at, skip_code.size + np.searchsorted(new, code))
    flag_chunks = np.concatenate([skip_chunks,
                                  np.stack([new // span, new % span])], axis=1)
    segs = np.stack([seg_tile, seg_row, seg_q, seg_bt, starts, ends])
    # units: runs of rows of a segment, cut by entries
    rows = seg_row[:, None] * bs + np.arange(bs)
    nnz = lists.row_nnz[seg_q[:, None], rows]                 # [NS, bs]
    work = nnz + 1
    level = (np.cumsum(work, axis=1) - work) // UNIT_WORK
    heavy = nnz > SPLIT_ROW
    cut = np.ones_like(heavy)
    cut[:, 1:] = (level[:, 1:] != level[:, :-1]) | heavy[:, 1:] \
        | heavy[:, :-1] | (np.arange(1, bs) % UNIT_ROWS == 0)
    seg_of, first = np.nonzero(cut)
    flat = np.flatnonzero(cut.reshape(-1))
    n_rows = np.diff(np.r_[flat, cut.size])
    entries = np.add.reduceat(nnz.reshape(-1), flat) if flat.size \
        else np.zeros(0, np.int64)
    credit = np.where(first == 0, (ends - starts)[seg_of], 0)
    units = np.stack([seg_tile[seg_of], seg_q[seg_of], seg_bt[seg_of],
                      rows[seg_of, first], n_rows, credit])
    units = units[:, np.lexsort((-entries, units[0]))]
    return ElementTable(lists=lists, units=as_i32(units), segs=as_i32(segs),
                        seg_chunks=as_i32(chunk_of),
                        flag_chunks=as_i32(flag_chunks),
                        n_elements=int(entries.sum()))


def _sparse_b_table(a_lists: ElementLists, b_lists: ElementLists,
                    windows: Optional[torch.Tensor], n: Optional[int],
                    a_map: np.ndarray, b_map: np.ndarray, key: np.ndarray,
                    ent: np.ndarray, skip: np.ndarray,
                    skip_chunks: np.ndarray, nbr: int,
                    as_i32) -> SparseBTable:
    """The sparse-B path's work of a launch whose real blocks, sorted by
    (tile, block-row), are ``key`` (tile * nbr + block-row) with ``ent``
    (A pool slot, block column), and whose left-out entries are ``skip``
    (tile, block-row, chunk of ``skip_chunks``); pool tiles ``a_map[t]``
    of A and ``b_map[t]`` of B for output tile t."""
    p, _, bs, _ = a_lists.pool_shape
    pb, _, bs_b, _ = b_lists.pool_shape
    r_tile, k_tile = nbr * bs, b_lists.n_block_rows * bs_b
    t = int(b_map.size)
    if a_lists.n_block_rows != nbr:
        raise ValueError(f"A's element lists of {a_lists.n_block_rows} "
                         f"block-rows a tile, the launch has {nbr}")
    if a_map.shape != b_map.shape or (t and (
            a_map.min() < 0 or a_map.max() >= p or b_map.max() >= pb)):
        raise ValueError(f"a_map and b_map must name one of the {p} A and "
                         f"{pb} B pool tiles for each of the {t} output "
                         "tiles")
    if n is None or windows is None:
        raise ValueError("the sparse-B path needs B's columns n and its "
                         "window offsets (sparse_b_windows)")
    nwin = -(-int(n) // SB_WINDOW)
    if not b_lists.cols_sorted:
        raise ValueError("the sparse-B path needs B's element lists sorted "
                         "by column in every row")
    if b_lists.max_brow >= n or a_lists.max_brow >= k_tile:
        raise ValueError(
            f"the element lists reach column {b_lists.max_brow} of B (n "
            f"{n}) and row {a_lists.max_brow} of B (K {k_tile})")
    if tuple(windows.shape) != (pb * k_tile, nwin + 1):
        raise ValueError(f"window offsets {tuple(windows.shape)} for B's "
                         f"lists of {pb * k_tile} rows and {nwin} windows")
    if t * r_tile > np.iinfo(np.int32).max:
        raise ValueError("output too tall for the kernel's int32 rows")
    row_nnz = a_lists.row_nnz
    a_rp = np.concatenate([[0], np.cumsum(row_nnz.reshape(-1))])
    a_brow = a_lists.brow.cpu().numpy().astype(np.int64)
    u_tile, u_row, u_prod, zeros = [], [], [], []
    for x in range(t):
        q, bt = int(a_map[x]), int(b_map[x])
        rows = np.flatnonzero(row_nnz[q])
        zeros.append(x * r_tile + np.flatnonzero(row_nnz[q] == 0))
        lo, hi = a_rp[q * r_tile], a_rp[(q + 1) * r_tile]
        # the products of each row: its entries' B row lengths, summed
        per = np.concatenate([[0], np.cumsum(
            b_lists.row_nnz[bt][a_brow[lo:hi]])])
        u_prod.append(per[a_rp[q * r_tile + rows + 1] - lo]
                      - per[a_rp[q * r_tile + rows] - lo])
        u_tile.append(np.full(rows.size, x))
        u_row.append(rows)
    u_tile, u_row, u_prod = (np.concatenate(v).astype(np.int64)
                             for v in (u_tile, u_row, u_prod))
    # each visited block-row's real blocks, credited on its first row that
    # holds a nonzero (the rest at the launch)
    blocks = np.bincount(key, minlength=t * nbr)
    seg = u_tile * nbr + u_row // bs
    first = np.r_[True, seg[1:] != seg[:-1]] if seg.size else seg > 0
    credit = np.where(first, blocks[seg], 0)
    # a heavy row: one unit of SB_WARPS windows a group
    groups = np.where(u_prod > SB_SPLIT, -(-nwin // SB_WARPS), 1)
    idx = np.repeat(np.arange(u_row.size), groups)
    part = np.arange(idx.size) - np.repeat(np.cumsum(groups) - groups, groups)
    split = groups[idx] > 1
    w0 = np.where(split, part * SB_WARPS, 0)
    w1 = np.where(split, np.minimum(w0 + SB_WARPS, nwin), nwin)
    units = np.stack([u_tile[idx], u_row[idx], w0, w1,
                      np.where(part == 0, credit[idx], 0)])
    units = units[:, np.argsort(-(u_prod[idx] / groups[idx]), kind="stable")]
    # the listed A blocks by (tile, block column): the real ones by pool
    # slot, the left-out ones as -1
    x_col = skip_chunks[1][skip[2]]
    cols = np.concatenate([ent[1], x_col])
    span = int(cols.max(initial=0)) + 1
    ikey = np.concatenate([key // nbr, skip[0]]) * span + cols
    order = np.argsort(ikey, kind="stable")
    col_ent = np.stack([np.concatenate([key % nbr, skip[1]]),
                        np.concatenate([ent[0],
                                        np.full(skip.shape[1], -1)])])
    colptr = np.searchsorted(ikey[order], np.arange(t * span + 1))
    return SparseBTable(
        a_lists=a_lists, b_lists=b_lists, units=as_i32(units),
        zero_rows=as_i32(np.concatenate(zeros)),
        maps=as_i32(np.stack([a_map, b_map])), windows=windows,
        colptr=as_i32(colptr), col_ent=as_i32(col_ent[:, order]), span=span,
        n=int(n), n_products=int(u_prod.sum()),
        extra_credit=int(blocks.sum() - credit.sum()))


def sparse_b_windows(lists: ElementLists, n: int) -> torch.Tensor:
    """int32 ``[P * K, ceil(n / SB_WINDOW) + 1]`` on the lists' device: for
    each row of a B pool's element lists (``K`` rows a tile), where its
    entries in each window of :data:`SB_WINDOW` of its ``n`` columns start,
    counted from the row's first entry (the last: the row's length).
    The rows' columns must be sorted (``lists.cols_sorted``)."""
    nwin = -(-int(n) // SB_WINDOW)
    if lists.max_brow >= n:
        raise ValueError(f"the lists reach column {lists.max_brow}, past "
                         f"n = {n}")
    lengths = lists.row_nnz.reshape(-1)
    row = np.repeat(np.arange(lengths.size), lengths)
    col = lists.brow.cpu().numpy().astype(np.int64)
    counts = np.bincount(row * nwin + col // SB_WINDOW,
                         minlength=lengths.size * nwin)
    out = np.zeros((lengths.size, nwin + 1), np.int64)
    np.cumsum(counts.reshape(lengths.size, nwin), axis=1, out=out[:, 1:])
    if out[:, -1].max(initial=0) > np.iinfo(np.int32).max:
        raise ValueError("a B row too long for the kernel's int32 offsets")
    return torch.from_numpy(out.astype(np.int32)).to(lists.brow.device)


def element_lists(pool: torch.Tensor, lists: "PoolLists", n_block_rows: int,
                  *, key: tuple = ()) -> ElementLists:
    """The nonzero elements of the real blocks of ``pool`` (``[P, S, bs,
    bs]``, on its device) that ``lists`` (its :class:`PoolLists`) name,
    row by row (:class:`ElementLists`).  Built on the pool's device over
    :data:`BUILD_SLICE` elements at a time, so it never holds a mask of the
    whole pool; nonzero means ``x != 0``, so a NaN counts."""
    p, s, bs, bs2 = pool.shape
    if bs != bs2 or lists.slots.shape[0] != p or lists.slots_per_tile != s:
        raise ValueError(f"a pool [{p}, {lists.slots_per_tile}, bs, bs] for "
                         f"these lists, got {tuple(pool.shape)}")
    nbr, length = int(n_block_rows), lists.slots.shape[1]
    r_tile = nbr * bs
    # the list position of each pool slot its list names real
    pos = np.full((p, s), -1, np.int64)
    tq, te = np.nonzero(lists.real)
    pos[tq, lists.slots[tq, te]] = te
    dev = pool.device
    pos, rows, cols = (torch.as_tensor(np.asarray(x, np.int64), device=dev)
                       for x in (pos, lists.rows, lists.cols))
    step = max(1, BUILD_SLICE // (bs * bs))
    brow, aoff, row_nnz, unsorted = [], [], [], False
    for q in range(p):
        keys, br, ao = [], [], []
        for s0 in range(0, s, step):
            nz = torch.nonzero(pool[q, s0:s0 + step] != 0)
            slot, r, c = nz[:, 0] + s0, nz[:, 1], nz[:, 2]
            e = pos[q, slot]
            listed = e >= 0
            slot, r, c, e = slot[listed], r[listed], c[listed], e[listed]
            keys.append(((rows[q, e] * bs + r) * length + e) * bs + c)
            br.append(cols[q, e] * bs + c)
            ao.append((q * s + slot) * (bs * bs) + r * bs + c)
        k_q = torch.cat(keys)
        k_q, order = torch.sort(k_q, stable=True)
        row_q = k_q // (length * bs)
        row_nnz.append(torch.bincount(row_q, minlength=r_tile))
        brow.append(torch.cat(br)[order].to(torch.int32))
        aoff.append(torch.cat(ao)[order])
        unsorted |= bool(((row_q[1:] == row_q[:-1])
                          & (brow[-1][1:] <= brow[-1][:-1])).any())
    counts = torch.stack(row_nnz)
    rowptr = torch.zeros(p * r_tile + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts.reshape(-1), 0, out=rowptr[1:])
    brow = torch.cat(brow)
    counts = counts.cpu().numpy()
    max_brow = int(brow.max()) if brow.numel() else -1
    return ElementLists(key=("elements",) + tuple(key), rowptr=rowptr,
                        brow=brow, aoff=torch.cat(aoff), row_nnz=counts,
                        pool_shape=(p, s, bs, bs), n_block_rows=nbr,
                        max_brow=max_brow, cols_sorted=not unsorted)


@dataclasses.dataclass(frozen=True)
class PoolLists:
    """The block list of every tile of an A pool, with its real mask (host
    numpy), from which a plan cuts each ring step's :class:`SpmmTable`.

    ``slots``, ``rows``, ``cols`` and ``real`` are ``[P, L]``: entry ``e``
    of pool tile ``q`` is block ``slots[q, e]`` of that tile (of
    ``slots_per_tile``), in block-row ``rows[q, e]`` and block column
    ``cols[q, e]``, real or not.  ``key`` names the structure they encode.
    """
    key: tuple
    slots: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    real: np.ndarray
    slots_per_tile: int

    def take(self, tiles) -> "PoolLists":
        """The lists of a pool made of the pool tiles ``tiles``, in order
        (a rank's local pool: the one tile it holds, or the row panel a
        ``summa_ag`` rank gathers)."""
        tiles = np.asarray(tiles, dtype=np.int64)
        return PoolLists(key=self.key + (tuple(tiles.tolist()),),
                         slots=self.slots[tiles], rows=self.rows[tiles],
                         cols=self.cols[tiles], real=self.real[tiles],
                         slots_per_tile=self.slots_per_tile)

    def table(self, a_map, b_map, n_block_rows: int, *, device=None,
              elements: Optional[ElementLists] = None,
              b_elements: Optional[ElementLists] = None,
              n: Optional[int] = None,
              windows: Optional[torch.Tensor] = None) -> SpmmTable:
        """The table of one launch in which output tile ``t`` multiplies
        pool tile ``a_map[t]`` by B tile ``b_map[t]``; with ``elements``
        (this pool's), the element path's split too, or with B's
        ``b_elements``, ``n`` and ``windows`` as well, the sparse-B path's
        work (:func:`spmm_table`)."""
        a_map = np.asarray(a_map, dtype=np.int64)
        slots = a_map[:, None] * self.slots_per_tile + self.slots[a_map]
        return spmm_table(slots, self.rows[a_map], self.cols[a_map],
                          n_block_rows, real=self.real[a_map], b_map=b_map,
                          device=device, elements=elements, a_map=a_map,
                          b_elements=b_elements, n=n, windows=windows)


def kernel_path(block_size: int, dtype: torch.dtype) -> str:
    """Which multiply the kernel runs for this block size and type (asks
    the built library, so it is the kernel's own dispatch): ``"mma.sync
    bf16 tensor cores"`` or ``"SIMT float32 FMA"``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"bsr_spmm takes float32 or bfloat16, got {dtype}")
    code = loader.load("bsr_spmm").bsr_spmm_path(int(block_size),
                                                 _DTYPE_CODES[dtype])
    return "mma.sync bf16 tensor cores" if code == 1 else "SIMT float32 FMA"


def bsr_spmm_cuda(blocks: torch.Tensor, dense: torch.Tensor,
                  table: SpmmTable, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[t] (+)= the table's real blocks of output tile t times its B tile,
    on the card.

    blocks : float32|bfloat16 ``[P, S, bs, bs]``, the A pool (table slots
    index its ``P * S`` blocks);  dense : float32|bfloat16 ``[TB, K, n]``,
    the B pool (the table's B tiles index it);  table : :func:`spmm_table`
    on the same device.  Returns a fresh ``[T, nbr*bs, n]`` in
    ``promote(blocks, dense)``, summed in float32 (``torch.empty``: the
    kernel writes every block-row once, the real sums and zeros where no
    real block lands).  With ``out`` (that shape and type) it adds into
    ``out`` in place and returns it: visited block-rows become ``out +
    sum`` with the sum rounded to the output type first, the others stay
    bit-identical.  Then :func:`nan_pass` writes NaN where a skipped zero
    block meets a non-finite B chunk (the plain version's ``0 * inf``).
    A table with :attr:`SpmmTable.elements` runs the element path over the
    real blocks' nonzeros, with the same sums (its ``blocks`` the pool the
    element lists were built from); its NaN pass also covers the zero
    slots inside real blocks.  A table with :attr:`SpmmTable.sparse_b`
    runs the sparse-B path: ``dense`` is then B's block pool ``[PB, SB,
    bs', bs']`` (the pool B's element lists were built from, its tiles
    ``K`` rows by ``n`` columns), and C is ``[T, nbr*bs, n]`` with the
    result of the real blocks times the densified B (its own NaN passes,
    from the two lists' values).  Raises on anything the kernel does not
    take.  ``.launches`` counts the calls that launched the kernel,
    ``.paths`` those of each path (``{"elements": k, "blocks": m,
    "sparse_b": s}``); while
    ``.block_counter`` is an int64 CUDA tensor of one element, each launch
    adds to it the blocks its kernel multiplied (the element path: the real
    blocks whose nonzeros it multiplied), and to the host int
    ``.table_blocks`` its table's real blocks (what it should multiply).
    While ``.element_counter`` is one, each element-path launch adds to it
    the nonzeros it multiplied, and to ``.table_elements`` its table's.
    While ``.by_shape`` is a dict, each launch adds one at the key ``(m,
    k, n)`` of its product: an ``m x k`` A tile times a ``k x n`` B tile.
    """
    loader.refuse_autograd("bsr_spmm_cuda", blocks, dense, out)
    counter = bsr_spmm_cuda.block_counter
    if table.sparse_b is not None:
        out, shape = _launch_sparse_b(blocks, dense, table, out, counter)
        if shape is not None:
            _tally(table, counter, shape)
        return out
    el = table.elements
    el_counter = bsr_spmm_cuda.element_counter if el is not None else None
    tensors = (blocks, dense, table.ent, table.chunks, table.reduce,
               table.fill, table.skip, table.skip_chunks) + tuple(
                   x for x in (out, counter, el_counter) if x is not None)
    if el is not None:
        tensors += (el.units, el.segs, el.seg_chunks, el.flag_chunks,
                    el.lists.rowptr, el.lists.brow, el.lists.aoff)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("bsr_spmm_cuda needs CUDA tensors (the table too); "
                         "CPU tensors go through kernels.ref")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("bsr_spmm_cuda operands lie on different devices")
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be [P, S, bs, bs], got "
                         f"{tuple(blocks.shape)}")
    bs = blocks.shape[-1]
    if dense.dim() != 3 or dense.shape[1] % bs:
        raise ValueError(f"dense must be [TB, K, n] with K a multiple of "
                         f"{bs}, got {tuple(dense.shape)}")
    for x in (blocks, dense):
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"bsr_spmm_cuda takes float32 or bfloat16, got "
                             f"{x.dtype}")
    k, n = dense.shape[1], dense.shape[2]
    if table.max_slot >= blocks.shape[0] * blocks.shape[1] \
            or table.max_col >= k // bs or table.max_b_tile >= dense.shape[0]:
        raise ValueError(
            f"the table reaches past the operands (slot {table.max_slot} of "
            f"{blocks.shape[0] * blocks.shape[1]}, block column "
            f"{table.max_col} of {k // bs}, B tile {table.max_b_tile} of "
            f"{dense.shape[0]})")
    if el is not None and (tuple(blocks.shape) != el.lists.pool_shape
                           or el.lists.n_block_rows != table.n_block_rows
                           or el.lists.max_brow >= k):
        raise ValueError(
            f"the element lists were built for a pool "
            f"{el.lists.pool_shape} of {el.lists.n_block_rows} block-rows "
            f"a tile, reaching B row {el.lists.max_brow}; the launch has "
            f"{tuple(blocks.shape)}, {table.n_block_rows} and K {k}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("bsr_spmm_cuda needs contiguous tensors")
    for name, x in (("block", counter), ("element", el_counter)):
        if x is not None and (x.dtype != torch.int64 or x.numel() != 1):
            raise ValueError(f"bsr_spmm_cuda's {name} counter must be one "
                             f"int64, got {x.dtype} {tuple(x.shape)}")
    out_dtype = torch.promote_types(blocks.dtype, dense.dtype)
    # mixed types: widen the narrower operand so the kernel sees one type
    blocks, dense = blocks.to(out_dtype), dense.to(out_dtype)
    t, nbr = table.tiles, table.n_block_rows
    shape = (t, nbr * bs, n)
    accumulate = out is not None
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=dense.device)
    elif out.dtype != out_dtype or tuple(out.shape) != shape:
        raise ValueError(f"bsr_spmm_cuda adds into {out_dtype} {shape}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.numel() == 0:
        return out
    lib = loader.load("bsr_spmm")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    with torch.cuda.device(dense.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if el is None:
            partial = torch.empty((table.n_parts, bs, n), dtype=torch.float32,
                                  device=dense.device)
            err = lib.bsr_spmm_launch(
                ptr(blocks), ptr(dense), ptr(table.ent), table.ent.shape[1],
                ptr(table.chunks), table.chunks.shape[1], ptr(table.reduce),
                table.reduce.shape[1], ptr(table.fill), table.fill.shape[1],
                ptr(partial), ptr(out), ptr(counter), bs, nbr, k, n,
                int(accumulate), _DTYPE_CODES[out_dtype], stream)
        else:
            err = lib.bsr_spmm_elem_launch(
                ptr(blocks), ptr(dense), ptr(el.lists.rowptr),
                ptr(el.lists.brow), ptr(el.lists.aoff), ptr(el.units),
                el.units.shape[1], ptr(table.fill), table.fill.shape[1],
                ptr(out), ptr(counter), ptr(el_counter), bs, nbr, k, n,
                int(accumulate), _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed with CUDA error "
                           f"{err} ({table.path} path, T={t}, bs={bs}, "
                           f"nbr={nbr}, K={k}, n={n}, chunks="
                           f"{table.chunks.shape[1]})")
    nan_pass(dense, table, out)
    _tally(table, counter, (nbr * bs, k, n))
    if el_counter is not None:
        bsr_spmm_cuda.table_elements += el.n_elements
    return out


def _tally(table: SpmmTable, counter, shape: tuple) -> None:
    """Count a launch of ``table`` (``shape``: its product's ``(m, k, n)``)
    on :func:`bsr_spmm_cuda`'s attributes."""
    bsr_spmm_cuda.launches += 1
    bsr_spmm_cuda.paths[table.path] += 1
    if counter is not None:
        bsr_spmm_cuda.table_blocks += table.real_blocks
    tally = bsr_spmm_cuda.by_shape
    if tally is not None:
        tally[shape] = tally.get(shape, 0) + 1


def _launch_sparse_b(blocks: torch.Tensor, b_blocks: torch.Tensor,
                     table: SpmmTable, out: Optional[torch.Tensor],
                     counter: Optional[torch.Tensor]):
    """One launch of the sparse-B path (:func:`bsr_spmm_cuda` with a
    :attr:`SpmmTable.sparse_b` table): the checks, the workspace and the
    kernel's launch.  Returns C and the product's ``(m, k, n)`` (None
    where C is empty and nothing launched)."""
    sb = table.sparse_b
    al, bl = sb.a_lists, sb.b_lists
    tensors = (blocks, b_blocks, al.rowptr, al.brow, al.aoff, bl.rowptr,
               bl.brow, bl.aoff, sb.units, sb.zero_rows, sb.maps,
               sb.windows, sb.colptr, sb.col_ent) + tuple(
                   x for x in (out, counter) if x is not None)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("bsr_spmm_cuda needs CUDA tensors (the table too); "
                         "CPU tensors go through kernels.ref")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("bsr_spmm_cuda operands lie on different devices")
    for x in (blocks, b_blocks):
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"bsr_spmm_cuda takes float32 or bfloat16, got "
                             f"{x.dtype}")
    if tuple(blocks.shape) != al.pool_shape \
            or tuple(b_blocks.shape) != bl.pool_shape:
        raise ValueError(
            f"the element lists were built for pools {al.pool_shape} and "
            f"{bl.pool_shape}; the launch has {tuple(blocks.shape)} and "
            f"{tuple(b_blocks.shape)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("bsr_spmm_cuda needs contiguous tensors")
    if counter is not None and (counter.dtype != torch.int64
                                or counter.numel() != 1):
        raise ValueError(f"bsr_spmm_cuda's block counter must be one int64, "
                         f"got {counter.dtype} {tuple(counter.shape)}")
    out_dtype = torch.promote_types(blocks.dtype, b_blocks.dtype)
    blocks, b_blocks = blocks.to(out_dtype), b_blocks.to(out_dtype)
    bs = blocks.shape[-1]
    t, r_tile, n = table.tiles, table.n_block_rows * bs, sb.n
    k = bl.n_block_rows * b_blocks.shape[-1]
    shape = (t, r_tile, n)
    accumulate = out is not None
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=b_blocks.device)
    elif out.dtype != out_dtype or tuple(out.shape) != shape:
        raise ValueError(f"bsr_spmm_cuda adds into {out_dtype} {shape}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.numel() == 0:
        return out, None
    ea, eb = al.n_elements, bl.n_elements
    vals = torch.empty(ea + eb, dtype=torch.float32, device=out.device)
    flags = torch.empty(2, dtype=torch.int32, device=out.device)
    lib = loader.load("bsr_spmm")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    with torch.cuda.device(out.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = lib.bsr_spmm_sparse_b_launch(
            ptr(blocks), ptr(b_blocks), ptr(al.rowptr), ptr(al.brow),
            ptr(al.aoff), ea, al.rowptr.numel() - 1, ptr(bl.rowptr),
            ptr(bl.brow), ptr(bl.aoff), eb, bl.rowptr.numel() - 1,
            ptr(sb.windows), ptr(sb.units), sb.units.shape[1],
            ptr(sb.zero_rows), sb.zero_rows.numel(), ptr(sb.maps),
            ptr(sb.colptr), ptr(sb.col_ent), sb.col_ent.shape[1],
            ptr(vals), ptr(flags), ptr(out), ptr(counter), sb.extra_credit,
            t, sb.span, bs, r_tile, k, n, SB_WINDOW, int(accumulate),
            _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed with CUDA error "
                           f"{err} (sparse_b path, T={t}, bs={bs}, R="
                           f"{r_tile}, K={k}, n={n}, units="
                           f"{sb.units.shape[1]})")
    return out, (r_tile, k, n)


def nan_pass(dense: torch.Tensor, table: SpmmTable,
             out: torch.Tensor) -> torch.Tensor:
    """B1's non-finite pass over ``out``, the result of a launch of
    ``table`` on the B pool ``dense`` (what :func:`bsr_spmm_cuda` runs after
    its multiply; callable alone to time it): flag the columns of the
    skipped entries' B chunks that hold an inf or a NaN, then write NaN
    into the block-rows that skip them.  Two small kernels, no host
    synchronisation; nothing when the table skips no entry.

    The element path's pass counts, per column, the non-finite rows of
    every B chunk a real block reads too (one read of those chunks on
    finite B), and where some are raised also writes NaN at ``C[r, j]``
    wherever a zero slot ``(r, c)`` of a real block meets a non-finite
    ``B[c, j]``: where the segment's real blocks meet more non-finite rows
    at column j than row r's nonzeros do.  A row whose nonzeros meet every
    such ``c`` keeps the multiply's own inf or NaN."""
    el = table.elements
    n_skip = table.skip.shape[1]
    n_chunks = (table.skip_chunks if el is None
                else el.flag_chunks).shape[1]
    if not (n_chunks and out.numel()) or (el is None and not n_skip):
        return out
    bs = out.shape[1] // table.n_block_rows
    k, n = dense.shape[1], dense.shape[2]
    flags = torch.empty((n_chunks, n), dtype=torch.uint8 if el is None
                        else torch.int32, device=out.device)
    anyf = torch.empty(1, dtype=torch.int32, device=out.device)
    lib = loader.load("bsr_spmm")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(out.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if el is None:
            err = lib.bsr_spmm_nan_launch(
                ptr(dense), ptr(table.skip_chunks), n_chunks, ptr(table.skip),
                n_skip, ptr(flags), ptr(anyf), ptr(out), bs,
                table.n_block_rows, k, n, _DTYPE_CODES[out.dtype], stream)
        else:
            err = lib.bsr_spmm_elem_nan_launch(
                ptr(dense), ptr(el.flag_chunks), n_chunks, ptr(table.skip),
                n_skip, ptr(el.segs), el.segs.shape[1], ptr(el.seg_chunks),
                ptr(el.lists.rowptr), ptr(el.lists.brow), ptr(flags),
                ptr(anyf), ptr(out), bs, table.n_block_rows, k, n,
                _DTYPE_CODES[out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm non-finite pass failed with CUDA error "
                           f"{err} ({n_skip} skipped entries, {n_chunks} "
                           "chunks)")
    return out


bsr_spmm_cuda.launches = 0
bsr_spmm_cuda.paths = {"elements": 0, "blocks": 0, "sparse_b": 0}
bsr_spmm_cuda.block_counter = None
bsr_spmm_cuda.table_blocks = 0
bsr_spmm_cuda.element_counter = None
bsr_spmm_cuda.table_elements = 0
bsr_spmm_cuda.by_shape = None
