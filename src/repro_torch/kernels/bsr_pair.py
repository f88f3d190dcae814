"""Wrappers of the hand-written CUDA block-pair kernels (``csrc/bsr_pair.cu``).

One source serves two TPU kernels of ``repro/kernels/bsr_spmm.py``:

* :func:`bsr_pair_accumulate_cuda` — ``bsr_pair_accumulate_pallas``, the
  numeric phase of sparse-output SpGEMM: products land in packed output
  slots, optionally added into a float32 carry;
* :func:`bsr_pair_matmul_cuda` — ``bsr_pair_matmul_pallas``, the
  dense-tile SpGEMM: products land in a dense C tile.

Both take a batch of tiles, so one launch serves every tile of a ring
step, and both take the pair lists' work split as a :class:`PairTable`,
built on the host once per pair list (:func:`pair_table`): the engine's
pair lists are plan constants, so its plans build their tables at plan
time, from the symbolic phase's real-pair mask.  The kernel multiplies the
real pairs only; a fresh output zero-fills the slots no real pair visits,
and an accumulate updates the carry in place, on the visited slots only.
The plain PyTorch versions are
:func:`repro_torch.kernels.ref.bsr_pair_accumulate_raw_ref` and
:func:`~repro_torch.kernels.ref.bsr_pair_matmul_raw_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import loader

__all__ = ["PairTable", "pair_table", "bsr_pair_accumulate_cuda",
           "bsr_pair_matmul_cuda", "kernel_path", "CHUNK", "MAX_PARTS",
           "FILL_RUN"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Pairs per chunk: one warp of the kernel multiplies at most this many real
# pairs of one output segment, unless the segment is so long that MAX_PARTS
# chunks would not hold it: then its chunks grow, so that the reduce pass
# never sums more than MAX_PARTS partials of one segment.
CHUNK = 32
MAX_PARTS = 2048
# Slots per row of the zero-fill list: one thread block of the fill kernel
# zeroes at most this many slots.
FILL_RUN = 64


@dataclasses.dataclass(frozen=True)
class PairTable:
    """Work split of a batch of slot-sorted pair lists, over real pairs.

    ``pidx`` is int32 ``[Q]``: the position in its tile's list of each real
    pair, by tile and then in list order (inert pairs are left out).
    ``chunks`` is int32 ``[5, C]``: tile, first and end index into
    ``pidx``, output slot and partial index of each chunk (``-1`` for a
    segment's only chunk, which stores C itself).  ``reduce`` is int32
    ``[4, R]``: tile, slot, first partial and number of partials of each
    segment cut into several chunks.  ``fill`` is int32 ``[3, F]``: tile,
    first slot and number of slots of each run of slots that no real pair
    visits, which a fresh output zero-fills.  ``n_parts`` partials of
    ``bs * bs`` float32 make the kernel's workspace.
    """
    pidx: torch.Tensor
    chunks: torch.Tensor
    reduce: torch.Tensor
    fill: torch.Tensor
    n_parts: int
    tiles: int
    pairs: int
    n_slots: int

    @property
    def real_pairs(self) -> int:
        """Pairs the kernel multiplies (the real ones)."""
        return int(self.pidx.shape[0])

    def workspace_bytes(self, block_size: int) -> int:
        return self.n_parts * block_size * block_size * 4


def pair_table(slots, n_slots: int, *, real=None, device=None,
               chunk: int = CHUNK, max_parts: int = MAX_PARTS) -> PairTable:
    """Cut slot-sorted pair lists into chunks of real pairs (host numpy,
    once per list).

    slots : int ``[T, P]`` (numpy or tensor), nondecreasing within each
    tile, in ``[0, n_slots)``.  real : bool ``[T, P]`` or None (every pair
    real): the pairs whose product can be nonzero; the others are inert
    (both blocks guaranteed zero) and are left out.  A segment (a run of
    one slot) of ``L`` real pairs becomes ``ceil(L / c)`` chunks of ``c =
    max(chunk, ceil(L / max_parts))`` pairs; the slots no real pair visits
    become runs of at most :data:`FILL_RUN` slots.
    """
    slots = _host(slots)
    if slots.ndim != 2:
        raise ValueError(f"slots must be [T, P], got shape {slots.shape}")
    t, p = slots.shape
    s = slots.astype(np.int64)
    if s.size and (s.min() < 0 or s.max() >= n_slots):
        raise ValueError(f"pair slots outside [0, {n_slots})")
    if p > 1 and (np.diff(s, axis=1) < 0).any():
        raise ValueError("pair slots must be nondecreasing within each tile")
    if real is None:
        real = np.ones((t, p), dtype=bool)
    real = _host(real).astype(bool)
    if real.shape != (t, p):
        raise ValueError(f"real must be [T, P] = {(t, p)}, got shape "
                         f"{real.shape}")
    q = np.flatnonzero(real.reshape(-1))         # real pairs, tile-major
    q_tile = q // max(p, 1)
    key = q_tile * n_slots + s.reshape(-1)[q]
    if key.size:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    else:
        starts = np.zeros(0, np.int64)
    ends = np.r_[starts[1:], key.size].astype(np.int64)
    length = ends - starts
    size = np.maximum(chunk, -(-length // max_parts))
    n_chunks = -(-length // size)
    seg = np.repeat(np.arange(len(starts)), n_chunks)
    first_chunk = np.cumsum(n_chunks) - n_chunks
    c_start = starts[seg] + (np.arange(len(seg)) - first_chunk[seg]) * size[seg]
    c_end = np.minimum(c_start + size[seg], ends[seg])
    multi = n_chunks[seg] > 1
    part = np.full(len(seg), -1, np.int64)
    part[multi] = np.arange(int(multi.sum()))
    c_tile = q_tile[c_start]
    chunks = np.stack([c_tile, c_start, c_end,
                       key[starts[seg]] - c_tile * n_slots, part])
    segs_multi = np.flatnonzero(n_chunks > 1)
    r_tile = q_tile[starts[segs_multi]]
    reduce = np.stack([r_tile, key[starts[segs_multi]] - r_tile * n_slots,
                       part[first_chunk[segs_multi]], n_chunks[segs_multi]])
    fill = _fill_runs(key[starts], t, n_slots)
    pidx = q - q_tile * p
    if max(int(x.max(initial=0)) for x in (chunks, reduce, fill)) \
            > np.iinfo(np.int32).max:
        raise ValueError("pair lists too long for the kernel's int32 table")
    as_i32 = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.int32)).to(device or "cpu")
    return PairTable(pidx=as_i32(pidx), chunks=as_i32(chunks),
                     reduce=as_i32(reduce), fill=as_i32(fill),
                     n_parts=int(multi.sum()), tiles=t, pairs=p,
                     n_slots=int(n_slots))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fill_runs(visited_keys: np.ndarray, t: int, n_slots: int) -> np.ndarray:
    """int64 [3, F]: (tile, first slot, slots) of each run of unvisited
    slots (keys ``tile * n_slots + slot``), cut at tile ends and every
    :data:`FILL_RUN` slots."""
    visited = np.zeros(t * n_slots, dtype=bool)
    visited[visited_keys] = True
    free = np.flatnonzero(~visited)
    if not free.size:
        return np.zeros((3, 0), np.int64)
    tile = free // n_slots
    brk = np.r_[True, (np.diff(free) != 1) | (np.diff(tile) != 0)]
    run_first = np.flatnonzero(brk)
    offs = np.arange(free.size) - run_first[np.cumsum(brk) - 1]
    brk |= offs % FILL_RUN == 0
    first = np.flatnonzero(brk)
    count = np.diff(np.r_[first, free.size])
    return np.stack([tile[first], free[first] % n_slots, count])


def _launch(a, b, pa, pb, table: PairTable, out: torch.Tensor, *,
            nbc: int, accumulate: bool, who: str,
            counter: Optional[torch.Tensor]) -> None:
    """Check what the kernel takes and launch it into ``out`` (float32)."""
    tensors = (a, b, pa, pb, out, table.pidx, table.chunks, table.reduce,
               table.fill)
    if counter is not None:
        tensors += (counter,)
    if not all(x.is_cuda for x in tensors):
        raise ValueError(f"{who} needs CUDA tensors (the pair table too); "
                         "CPU tensors go through kernels.ref")
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"{who} operands lie on different devices")
    for name, x in (("a_blocks", a), ("b_blocks", b)):
        if x.dim() != 4 or x.shape[2] != x.shape[3]:
            raise ValueError(f"{name} must be [T, S, bs, bs], got "
                             f"{tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"{who} takes float32 or bfloat16, got "
                             f"{x.dtype}")
        if x.shape[1] == 0:
            raise ValueError(f"{name} holds no block")
    t, sa, bs, _ = a.shape
    if b.shape[0] != t or b.shape[2] != bs or a.dtype != b.dtype:
        raise ValueError(f"a_blocks {tuple(a.shape)} {a.dtype} and b_blocks "
                         f"{tuple(b.shape)} {b.dtype} disagree")
    for name, idx in (("pair_a", pa), ("pair_b", pb)):
        if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != t:
            raise ValueError(f"{name} must be int32 [{t}, P], got "
                             f"{idx.dtype} {tuple(idx.shape)}")
    p = pa.shape[1]
    if tuple(pb.shape) != (t, p) or (table.tiles, table.pairs) != (t, p):
        raise ValueError(f"pair lists {tuple(pa.shape)} / {tuple(pb.shape)} "
                         f"do not match the pair table ({table.tiles}, "
                         f"{table.pairs})")
    if out.dtype != torch.float32 or out.numel() != t * table.n_slots * bs * bs:
        raise ValueError(f"{who} writes float32 [{t}, {table.n_slots} "
                         f"blocks of {bs}x{bs}], got {out.dtype} "
                         f"{tuple(out.shape)}")
    if counter is not None and (counter.dtype != torch.int64
                                or counter.numel() != 1):
        raise ValueError(f"{who}'s pair counter must be one int64, got "
                         f"{counter.dtype} {tuple(counter.shape)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{who} needs contiguous tensors")
    partial = torch.empty((table.n_parts, bs, bs), dtype=torch.float32,
                          device=out.device)
    lib = loader.load("bsr_pair")
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bsr_pair_launch(
            ptr(a), ptr(b), ptr(pa), ptr(pb), ptr(table.pidx),
            ptr(table.chunks), table.chunks.shape[1], ptr(table.reduce),
            table.reduce.shape[1], ptr(table.fill), table.fill.shape[1],
            ptr(partial), ptr(out), ptr(counter), t, sa, b.shape[1], p, bs,
            table.n_slots, nbc, int(accumulate), _DTYPE_CODES[a.dtype],
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed with CUDA error "
                           f"{err} (T={t}, Sa={sa}, Sb={b.shape[1]}, P={p}, "
                           f"bs={bs}, slots={table.n_slots}, "
                           f"chunks={table.chunks.shape[1]})")


def kernel_path(block_size: int, dtype: torch.dtype) -> str:
    """Which multiply the kernel runs for this block size and type (asks
    the built library, so it is the kernel's own dispatch): ``"mma.sync
    bf16 tensor cores"`` or ``"SIMT float32 FMA"``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the pair kernels take float32 or bfloat16, got "
                         f"{dtype}")
    code = loader.load("bsr_pair").bsr_pair_path(int(block_size),
                                                 _DTYPE_CODES[dtype])
    return "mma.sync bf16 tensor cores" if code == 1 else "SIMT float32 FMA"


def _same_type(a: torch.Tensor, b: torch.Tensor):
    """Mixed types: widen the narrower operand so the kernel sees one."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def bsr_pair_accumulate_cuda(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                             pair_a: torch.Tensor, pair_b: torch.Tensor,
                             table: PairTable, *,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """C[t, s] = sum of A[t, pa] @ B[t, pb] over the real pairs of slot s.

    a_blocks : float32|bfloat16 [T, Sa, bs, bs];  b_blocks [T, Sb, bs, bs]
    pair_a, pair_b : int32 [T, P];  table : :func:`pair_table` of the
    slots (and the real mask), on the same device.  Returns a fresh float32
    [T, n_slots, bs, bs] (``torch.empty``: the kernel writes every slot
    once, the real pairs' sums and zeros on the slots that no real pair
    visits).  With ``out`` (float32, that shape) it adds into ``out`` in
    place and returns it: only the slots that the table's real pairs visit
    are read and written, every other slot stays bit-identical.  Raises on
    anything the kernel does not take.  ``.launches`` counts the calls that
    launched the kernel; while ``.pair_counter`` is an int64 CUDA tensor
    of one element, each launch adds to it the pairs its kernel multiplied,
    and to the host int ``.table_pairs`` its table's real pairs.
    """
    loader.refuse_autograd("bsr_pair_accumulate_cuda", a_blocks, b_blocks,
                           out)
    a_blocks, b_blocks = _same_type(a_blocks, b_blocks)
    t, bs = a_blocks.shape[0], a_blocks.shape[-1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((t, table.n_slots, bs, bs), dtype=torch.float32,
                          device=a_blocks.device)
    _launch(a_blocks, b_blocks, pair_a, pair_b, table, out, nbc=0,
            accumulate=accumulate, who="bsr_pair_accumulate_cuda",
            counter=bsr_pair_accumulate_cuda.pair_counter)
    bsr_pair_accumulate_cuda.launches += 1
    if bsr_pair_accumulate_cuda.pair_counter is not None:
        bsr_pair_accumulate_cuda.table_pairs += table.real_pairs
    return out


def bsr_pair_matmul_cuda(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                         pair_a: torch.Tensor, pair_b: torch.Tensor,
                         table: PairTable, *, n_block_rows: int,
                         n_block_cols: int) -> torch.Tensor:
    """Dense C tiles from pairs sorted by (row, col): block (r, c) of tile t
    sums A[t, pa] @ B[t, pb] over the real pairs with slot ``r *
    n_block_cols + c`` (the table's slots); blocks no real pair visits are
    zero.  Returns float32 [T, nbr*bs, nbc*bs]; the caller casts.
    ``.launches``, ``.pair_counter`` and ``.table_pairs`` as for
    :func:`bsr_pair_accumulate_cuda`.
    """
    loader.refuse_autograd("bsr_pair_matmul_cuda", a_blocks, b_blocks)
    a_blocks, b_blocks = _same_type(a_blocks, b_blocks)
    t, bs = a_blocks.shape[0], a_blocks.shape[-1]
    if table.n_slots != n_block_rows * n_block_cols:
        raise ValueError(f"pair table has {table.n_slots} slots, the tile "
                         f"{n_block_rows}x{n_block_cols} blocks")
    out = torch.empty((t, n_block_rows * bs, n_block_cols * bs),
                      dtype=torch.float32, device=a_blocks.device)
    _launch(a_blocks, b_blocks, pair_a, pair_b, table, out,
            nbc=n_block_cols, accumulate=False, who="bsr_pair_matmul_cuda",
            counter=bsr_pair_matmul_cuda.pair_counter)
    bsr_pair_matmul_cuda.launches += 1
    if bsr_pair_matmul_cuda.pair_counter is not None:
        bsr_pair_matmul_cuda.table_pairs += table.real_pairs
    return out


bsr_pair_accumulate_cuda.launches = 0
bsr_pair_matmul_cuda.launches = 0
bsr_pair_accumulate_cuda.pair_counter = None
bsr_pair_matmul_cuda.pair_counter = None
bsr_pair_accumulate_cuda.table_pairs = 0
bsr_pair_matmul_cuda.table_pairs = 0
