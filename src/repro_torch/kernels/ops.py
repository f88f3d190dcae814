"""``impl`` dispatch for the kernels (port of ``repro/kernels/ops.py``).

``impl``:
  * ``"cuda"`` — the hand-written CUDA kernel; CUDA tensors only.
  * ``"ref"``  — the plain PyTorch version (``kernels/ref.py``).
  * ``"auto"`` / ``None`` — the kernel for CUDA tensors, ``"ref"`` for CPU
    tensors.  A CUDA tensor never falls back to ``"ref"``: the kernel
    launches or raises.

Every op takes one tile or a batch of tiles with a leading tile dimension;
the stacked-grid executor passes all g² tiles of a ring step in one call.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .bsr_spmm import bsr_spmm_cuda

__all__ = ["IMPLS", "default_impl", "bsr_spmm", "bsr_spmm_raw",
           "augment_coverage", "densify"]

IMPLS = ("auto", "ref", "cuda")


def default_impl(x: torch.Tensor) -> str:
    """The kernel for tensors on the card, the plain version on the CPU."""
    return "cuda" if x.is_cuda else "ref"


def _resolve(impl: Optional[str], x: torch.Tensor) -> str:
    impl = impl or "auto"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return default_impl(x)
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got tensors on "
                         f"{x.device}")
    return impl


def bsr_spmm_raw(blocks, rows, cols, dense, *, n_block_rows: int,
                 impl: Optional[str] = None,
                 augment: bool = True) -> torch.Tensor:
    """C = BSR(blocks, rows, cols) @ dense, for one tile or a batch.

    ``augment=False`` asserts that the arrays are already coverage-augmented
    and row-sorted (the :class:`~repro_torch.core.bsr.TiledBSR` storage
    contract), as the ring bodies pass them; ``augment=True`` merges one
    zero block per block-row into each list with a stable sort by row,
    which also sorts rows as the kernel requires.
    """
    impl = _resolve(impl, dense)
    bs = blocks.shape[-1]
    n = dense.shape[-1]
    if n == 0:  # half-panel schedules can give empty panels at tiny widths
        return dense.new_zeros(
            (*dense.shape[:-2], n_block_rows * bs, 0),
            dtype=torch.promote_types(blocks.dtype, dense.dtype))
    if impl == "ref":
        return _ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, n_block_rows)
    single = blocks.dim() == 3
    if single:
        blocks, rows, cols, dense = (blocks[None], rows[None], cols[None],
                                     dense[None])
    if augment:
        blocks, rows, cols = augment_coverage(blocks, rows, cols,
                                              n_block_rows)
    out = bsr_spmm_cuda(blocks.contiguous(), rows.contiguous(),
                        cols.contiguous(), dense.contiguous(),
                        n_block_rows=n_block_rows)
    return out[0] if single else out


def augment_coverage(blocks, rows, cols, n_block_rows: int):
    """Merge one zero block per block-row into each tile's list.

    Batched counterpart of the JAX package's ``_augment_tile``: a stable
    sort by row keeps the real blocks in order and puts each coverage block
    after the real blocks of its row.  Takes and returns ``[T, S, ...]``
    arrays (``S`` grows by ``n_block_rows``); the result is row-sorted.
    """
    t, _, bs, _ = blocks.shape
    cov = torch.arange(n_block_rows, dtype=rows.dtype,
                       device=rows.device).expand(t, -1)
    rows_aug = torch.cat([rows, cov], dim=1)
    order = torch.argsort(rows_aug, dim=1, stable=True)
    blocks = torch.cat(
        [blocks, blocks.new_zeros((t, n_block_rows, bs, bs))], dim=1)
    blocks = blocks[torch.arange(t, device=order.device)[:, None], order]
    cols = torch.take_along_dim(
        torch.cat([cols, torch.zeros_like(cov)], dim=1), order, dim=1)
    return blocks, torch.take_along_dim(rows_aug, order, dim=1), cols


def bsr_spmm(a_bsr, dense, *, impl: Optional[str] = None) -> torch.Tensor:
    """C = A @ dense for a :class:`repro_torch.core.bsr.BSR` A."""
    return bsr_spmm_raw(a_bsr.blocks, a_bsr.rows, a_bsr.cols, dense,
                        n_block_rows=a_bsr.n_block_rows, impl=impl)


def densify(blocks, rows, cols, *, n_block_rows: int,
            n_block_cols: int) -> torch.Tensor:
    return _ref.densify_raw(blocks, rows, cols, n_block_rows, n_block_cols)
