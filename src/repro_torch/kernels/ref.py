"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These are the correctness references: the CPU path of every wrapper, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.  Every
function takes one tile or a batch of tiles (a leading tile dimension), the
way the stacked-grid executor hands them over.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["bsr_spmm_raw_ref", "bsr_spmm_ref", "densify_raw"]

# Elements of the [tiles, chunk, bs, n] partial-product buffer per chunk:
# bounds the reference's memory at the main path's shapes (a full-size
# stored A times a 512-wide B would otherwise need ~14 GB of partials).
_CHUNK_ELEMS = 1 << 27


def bsr_spmm_raw_ref(blocks, rows, cols, dense, n_block_rows: int,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = BSR(blocks, rows, cols) @ dense, summed in float32.

    blocks : [S, bs, bs] or [T, S, bs, bs]  (padding blocks are zero)
    rows   : int[S] / int[T, S]  block-row per stored block
    cols   : int[S] / int[T, S]  block-col per stored block
    dense  : [nbc*bs, n] / [T, nbc*bs, n]
    returns  [nbr*bs, n] / [T, nbr*bs, n] in ``promote(blocks, dense)``
    """
    single = blocks.dim() == 3
    if single:
        blocks, rows, cols, dense = (blocks[None], rows[None], cols[None],
                                     dense[None])
    t, s, bs, _ = blocks.shape
    n = dense.shape[-1]
    out_dtype = out_dtype or torch.promote_types(blocks.dtype, dense.dtype)
    b_blocks = dense.reshape(t, -1, bs, n)
    tile = torch.arange(t, device=dense.device)[:, None]
    out = torch.zeros((t * n_block_rows, bs, n), dtype=torch.float32,
                      device=dense.device)
    step = max(1, _CHUNK_ELEMS // max(1, t * bs * n))
    for s0 in range(0, s, step):
        sl = slice(s0, s0 + step)
        part = torch.matmul(blocks[:, sl].float(),
                            b_blocks[tile, cols[:, sl].long()].float())
        dst = (tile * n_block_rows + rows[:, sl].long()).reshape(-1)
        out.index_add_(0, dst, part.reshape(-1, bs, n))
    out = out.reshape(t, n_block_rows * bs, n).to(out_dtype)
    return out[0] if single else out


def bsr_spmm_ref(a_bsr, dense) -> torch.Tensor:
    """Oracle via explicit densification: to_dense(A) @ B in float32."""
    acc = torch.matmul(a_bsr.to_dense().float(), dense.float())
    return acc.to(torch.promote_types(a_bsr.dtype, dense.dtype))


def densify_raw(blocks, rows, cols, n_block_rows: int,
                n_block_cols: int) -> torch.Tensor:
    """Scatter a block list into a dense tile (the SpGEMM B-side helper).

    Takes one tile (``blocks [S, bs, bs]``) or a batch (``[T, S, bs, bs]``)
    and returns ``[nbr*bs, nbc*bs]`` or ``[T, nbr*bs, nbc*bs]`` in the
    blocks' dtype.
    """
    single = blocks.dim() == 3
    if single:
        blocks, rows, cols = blocks[None], rows[None], cols[None]
    t, s, bs, _ = blocks.shape
    out = blocks.new_zeros((t, n_block_rows, n_block_cols, bs, bs))
    tile = torch.arange(t, device=blocks.device)[:, None].expand(t, s)
    out.index_put_((tile, rows.long(), cols.long()), blocks, accumulate=True)
    out = out.permute(0, 1, 3, 2, 4).reshape(
        t, n_block_rows * bs, n_block_cols * bs)
    return out[0] if single else out
