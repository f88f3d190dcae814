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
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import loader

__all__ = ["SpmmTable", "PoolLists", "spmm_table", "bsr_spmm_cuda",
           "nan_pass", "kernel_path", "CHUNK"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Real blocks per chunk: one unit of the kernel multiplies at most this
# many blocks of one block-row segment (the kernel's MAX_CHUNK).  A tile
# row holds at most nbc real blocks, 128 at both main-path shapes, so
# their segments stay whole: no partials, no reduce pass.
CHUNK = 128


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

    @property
    def real_blocks(self) -> int:
        """Blocks the kernel multiplies (the real ones)."""
        return int(self.ent.shape[1])

    def workspace_bytes(self, block_size: int, n: int) -> int:
        return self.n_parts * block_size * n * 4


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spmm_table(slots, rows, cols, n_block_rows: int, *, real=None,
               b_map=None, chunk: int = CHUNK, device=None) -> SpmmTable:
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
    real block visits are listed for the zero fill.
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
    return SpmmTable(ent=as_i32(ent), chunks=as_i32(chunks),
                     reduce=as_i32(reduce), fill=as_i32(fill),
                     skip=as_i32(skip.reshape(3, -1)),
                     skip_chunks=as_i32(skip_chunks.reshape(2, -1)),
                     n_parts=int(multi.sum()), tiles=t, n_block_rows=nbr,
                     max_slot=int(ent[0].max(initial=-1)),
                     max_col=max(int(ent[1].max(initial=-1)),
                                 int(x_col.max(initial=-1))),
                     max_b_tile=int(b_map.max(initial=-1)))


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

    def table(self, a_map, b_map, n_block_rows: int, *,
              device=None) -> SpmmTable:
        """The table of one launch in which output tile ``t`` multiplies
        pool tile ``a_map[t]`` by B tile ``b_map[t]``."""
        a_map = np.asarray(a_map, dtype=np.int64)
        slots = a_map[:, None] * self.slots_per_tile + self.slots[a_map]
        return spmm_table(slots, self.rows[a_map], self.cols[a_map],
                          n_block_rows, real=self.real[a_map], b_map=b_map,
                          device=device)


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
    Raises on anything the kernel does not take.
    ``.launches`` counts the calls that launched the kernel; while
    ``.block_counter`` is an int64 CUDA tensor of one element, each launch
    adds to it the blocks its kernel multiplied, and to the host int
    ``.table_blocks`` its table's real blocks (what it should multiply).
    While ``.by_shape`` is a dict, each launch adds one at the key ``(m,
    k, n)`` of its product: an ``m x k`` A tile times a ``k x n`` B tile.
    """
    loader.refuse_autograd("bsr_spmm_cuda", blocks, dense, out)
    counter = bsr_spmm_cuda.block_counter
    tensors = (blocks, dense, table.ent, table.chunks, table.reduce,
               table.fill, table.skip, table.skip_chunks) + tuple(
                   x for x in (out, counter) if x is not None)
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
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("bsr_spmm_cuda needs contiguous tensors")
    if counter is not None and (counter.dtype != torch.int64
                                or counter.numel() != 1):
        raise ValueError(f"bsr_spmm_cuda's block counter must be one int64, "
                         f"got {counter.dtype} {tuple(counter.shape)}")
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
    partial = torch.empty((table.n_parts, bs, n), dtype=torch.float32,
                          device=dense.device)
    lib = loader.load("bsr_spmm")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bsr_spmm_launch(
            ptr(blocks), ptr(dense), ptr(table.ent), table.ent.shape[1],
            ptr(table.chunks), table.chunks.shape[1], ptr(table.reduce),
            table.reduce.shape[1], ptr(table.fill), table.fill.shape[1],
            ptr(partial), ptr(out), ptr(counter), bs, nbr, k, n,
            int(accumulate), _DTYPE_CODES[out_dtype],
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed with CUDA error "
                           f"{err} (T={t}, bs={bs}, nbr={nbr}, K={k}, n={n}, "
                           f"chunks={table.chunks.shape[1]})")
    nan_pass(dense, table, out)
    bsr_spmm_cuda.launches += 1
    if counter is not None:
        bsr_spmm_cuda.table_blocks += table.real_blocks
    tally = bsr_spmm_cuda.by_shape
    if tally is not None:
        tally[nbr * bs, k, n] = tally.get((nbr * bs, k, n), 0) + 1
    return out


def nan_pass(dense: torch.Tensor, table: SpmmTable,
             out: torch.Tensor) -> torch.Tensor:
    """B1's non-finite pass over ``out``, the result of a launch of
    ``table`` on the B pool ``dense`` (what :func:`bsr_spmm_cuda` runs after
    its multiply; callable alone to time it): flag the columns of the
    skipped entries' B chunks that hold an inf or a NaN, then write NaN
    into the block-rows that skip them.  Two small kernels, no host
    synchronisation; nothing when the table skips no entry."""
    n_skip, n_chunks = table.skip.shape[1], table.skip_chunks.shape[1]
    if not (n_skip and n_chunks and out.numel()):
        return out
    bs = out.shape[1] // table.n_block_rows
    k, n = dense.shape[1], dense.shape[2]
    flags = torch.empty((n_chunks, n), dtype=torch.uint8, device=out.device)
    anyf = torch.empty(1, dtype=torch.int32, device=out.device)
    lib = loader.load("bsr_spmm")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bsr_spmm_nan_launch(
            ptr(dense), ptr(table.skip_chunks), n_chunks, ptr(table.skip),
            n_skip, ptr(flags), ptr(anyf), ptr(out), bs, table.n_block_rows,
            k, n, _DTYPE_CODES[out.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bsr_spmm non-finite pass failed with CUDA error "
                           f"{err} ({n_skip} skipped entries, {n_chunks} "
                           "chunks)")
    return out


bsr_spmm_cuda.launches = 0
bsr_spmm_cuda.block_counter = None
bsr_spmm_cuda.table_blocks = 0
bsr_spmm_cuda.by_shape = None
