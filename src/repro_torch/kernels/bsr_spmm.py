"""Wrapper of the hand-written CUDA BSR SpMM kernel (``csrc/bsr_spmm.cu``).

Counterpart of ``repro/kernels/bsr_spmm.py::bsr_spmm_pallas``.  The kernel
takes a batch of tiles, so one launch multiplies every tile of the stacked
process grid.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.bsr_spmm_raw_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import loader

__all__ = ["bsr_spmm_cuda", "segment_bounds", "CHUNK"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Stored blocks per chunk: one thread block of the kernel multiplies at most
# this many blocks of one block-row segment, so a long segment (a tile's
# capacity padding all lands in one block-row) spreads over many SMs.
CHUNK = 32


def segment_bounds(rows: torch.Tensor, n_block_rows: int,
                   chunk: int = CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-tile segment and chunk bounds of row-sorted block lists.

    rows : int32 [T, S], sorted within each tile.  Returns
    ``(row_ptr, chunk_ptr, max_chunks)``: segment ``r`` of tile ``t`` is
    stored blocks ``row_ptr[t, r] : row_ptr[t, r + 1]``, cut into chunks
    ``chunk_ptr[t, r] : chunk_ptr[t, r + 1]`` of at most ``chunk`` blocks
    (an empty segment has one empty chunk).  ``max_chunks`` bounds every
    tile's chunk count from the shapes alone, so nothing waits on the device.
    """
    t, s = rows.shape
    bounds = torch.arange(n_block_rows + 1, dtype=torch.int32,
                          device=rows.device).expand(t, -1).contiguous()
    row_ptr = torch.searchsorted(rows, bounds, out_int32=True)
    seg = (row_ptr[:, 1:] - row_ptr[:, :-1]).long()
    n_chunks = ((seg + chunk - 1) // chunk).clamp_(min=1)
    chunk_ptr = torch.zeros((t, n_block_rows + 1), dtype=torch.int32,
                            device=rows.device)
    chunk_ptr[:, 1:] = n_chunks.cumsum(dim=1)
    # sum_r max(1, ceil(len_r / chunk)) <= n_block_rows + ceil(S / chunk)
    max_chunks = n_block_rows + -(-s // chunk)
    return row_ptr, chunk_ptr, max_chunks


def bsr_spmm_cuda(blocks: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, dense: torch.Tensor, *,
                  n_block_rows: int) -> torch.Tensor:
    """C[t] = BSR(blocks[t], rows[t], cols[t]) @ dense[t] on the card.

    blocks : float32|bfloat16 [T, S, bs, bs]
    rows   : int32 [T, S], sorted within each tile
    cols   : int32 [T, S]
    dense  : float32|bfloat16 [T, nbc*bs, n]
    returns  [T, n_block_rows*bs, n] in ``promote(blocks, dense)``, summed
    in float32.  One thread block multiplies at most ``CHUNK`` stored
    blocks (see :func:`segment_bounds`).  Raises on anything the kernel
    does not take.  ``bsr_spmm_cuda.launches`` counts the calls that
    launched the kernel.
    """
    tensors = (blocks, rows, cols, dense)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("bsr_spmm_cuda needs CUDA tensors; CPU tensors go "
                         "through kernels.ref.bsr_spmm_raw_ref")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("bsr_spmm_cuda operands lie on different devices")
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be [T, S, bs, bs], got "
                         f"{tuple(blocks.shape)}")
    t, s, bs, _ = blocks.shape
    for name, idx in (("rows", rows), ("cols", cols)):
        if idx.dtype != torch.int32 or tuple(idx.shape) != (t, s):
            raise ValueError(f"{name} must be int32 [{t}, {s}], got "
                             f"{idx.dtype} {tuple(idx.shape)}")
    if dense.dim() != 3 or dense.shape[0] != t or dense.shape[1] % bs:
        raise ValueError(f"dense must be [{t}, K, n] with K a multiple of "
                         f"{bs}, got {tuple(dense.shape)}")
    for x in (blocks, dense):
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"bsr_spmm_cuda takes float32 or bfloat16, got "
                             f"{x.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("bsr_spmm_cuda needs contiguous tensors")
    out_dtype = torch.promote_types(blocks.dtype, dense.dtype)
    # mixed types: widen the narrower operand so the kernel sees one type
    blocks, dense = blocks.to(out_dtype), dense.to(out_dtype)
    k, n = dense.shape[1], dense.shape[2]
    out = torch.empty((t, n_block_rows * bs, n), dtype=out_dtype,
                      device=dense.device)
    if out.numel() == 0:
        return out
    row_ptr, chunk_ptr, max_chunks = segment_bounds(rows, n_block_rows)
    # a float32 partial for every chunk, sized from the shapes alone:
    # T * max_chunks * bs * n * 4 bytes
    partial = torch.empty((t, max_chunks, bs, n), dtype=torch.float32,
                          device=dense.device)
    lib = loader.load("bsr_spmm")
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bsr_spmm_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                blocks, cols, row_ptr, chunk_ptr, dense, partial, out)),
            t, s, bs, n_block_rows, k, n, max_chunks, CHUNK,
            _DTYPE_CODES[out_dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed with CUDA error "
                           f"{err} (T={t}, S={s}, bs={bs}, "
                           f"nbr={n_block_rows}, K={k}, n={n})")
    bsr_spmm_cuda.launches += 1
    return out


bsr_spmm_cuda.launches = 0
