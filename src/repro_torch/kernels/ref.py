"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These are the correctness references: the CPU path of every wrapper, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.  Every
function takes one tile or a batch of tiles (a leading tile dimension), the
way the stacked-grid executor hands them over.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["bsr_spmm_raw_ref", "bsr_spmm_ref", "steal_pair_accumulate_raw_ref",
           "bsr_pair_accumulate_raw_ref", "bsr_pair_matmul_raw_ref",
           "bsr_spmm_sparse_b_raw_ref", "densify_raw"]

# Elements of the [tiles, chunk, bs, n] (or [tiles, chunk, bs, bs])
# partial-product buffer per chunk: bounds the reference's memory at the
# main path's shapes (a full-size stored A times a 512-wide B would
# otherwise need ~14 GB of partials, a sparse-output step's 11 M pairs of
# 32x32 blocks 45 GB).
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


def bsr_spmm_sparse_b_raw_ref(a_blocks, a_rows, a_cols, b_blocks, b_rows,
                              b_cols, n_block_rows: int, n_block_cols: int,
                              out_dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """C = BSR(a) @ densify(BSR(b)), from the two operands' nonzeros.

    a_blocks [S, bs, bs] / [T, S, bs, bs] with ``a_rows``/``a_cols`` as
    :func:`bsr_spmm_raw_ref`'s; b_blocks [Sb, bs', bs'] / [T, Sb, bs', bs']
    with ``b_rows``/``b_cols``, the B tile of each output tile, whose
    ``n_block_cols * bs'`` columns C takes; returns ``[nbr*bs, n]`` /
    ``[T, nbr*bs, n]`` in ``promote(a, b)``, summed in float32, equal to
    ``bsr_spmm_raw_ref(a, ..., densify_raw(b, ...))``: every product of a
    nonzero of A's row r and column k with a nonzero of B's row k is added
    into C[r, j], and the zeros either side skips give that product's
    non-finite values: NaN at C[r, j] where a zero slot (r, k) of a listed
    A block (or a listed zero block) meets a non-finite B[k, j], and where
    a non-finite A[r, k] meets a zero B[k, j].
    """
    single = a_blocks.dim() == 3
    if single:
        a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols = (
            x[None] for x in (a_blocks, a_rows, a_cols, b_blocks, b_rows,
                              b_cols))
    t, _, bs, _ = a_blocks.shape
    bs_b = b_blocks.shape[-1]
    r_tile, n = n_block_rows * bs, n_block_cols * bs_b
    out_dtype = out_dtype or torch.promote_types(a_blocks.dtype,
                                                 b_blocks.dtype)
    dev = a_blocks.device
    a_rows, a_cols, b_rows, b_cols = (x.long() for x in (a_rows, a_cols,
                                                          b_rows, b_cols))
    # A's and B's nonzeros (a NaN counts) as (tile, row, column, value)
    at, asl, ar, ac = torch.nonzero(a_blocks != 0, as_tuple=True)
    a_r, a_k = a_rows[at, asl] * bs + ar, a_cols[at, asl] * bs + ac
    a_v = a_blocks[at, asl, ar, ac].float()
    bt, bsl, br, bc = torch.nonzero(b_blocks != 0, as_tuple=True)
    b_k, b_j = b_rows[bt, bsl] * bs_b + br, b_cols[bt, bsl] * bs_b + bc
    b_v = b_blocks[bt, bsl, br, bc].float()
    k_span = int(max(a_k.max().item() if a_k.numel() else 0,
                     b_k.max().item() if b_k.numel() else 0)) + 1
    # B's nonzeros by (tile, row) as CSR
    b_key = bt * k_span + b_k
    b_key, order = torch.sort(b_key, stable=True)
    b_j, b_v = b_j[order], b_v[order]
    b_ptr = torch.zeros(t * k_span + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(b_key, minlength=t * k_span), 0,
                 out=b_ptr[1:])
    out = torch.zeros(t * r_tile * n, dtype=torch.float32, device=dev)
    a_key = at * k_span + a_k
    start, length = b_ptr[a_key], b_ptr[a_key + 1] - b_ptr[a_key]
    ends = torch.cumsum(length, 0)
    step = max(1, _CHUNK_ELEMS // 4)
    e0 = 0
    while e0 < a_key.numel():
        # A's nonzeros [e0, e1) with at most ``step`` products between them
        base = int(ends[e0 - 1]) if e0 else 0
        e1 = max(e0 + 1, int(torch.searchsorted(ends, base + step,
                                                right=True)))
        e = torch.repeat_interleave(torch.arange(e0, e1, device=dev),
                                    length[e0:e1])
        f = start[e] + torch.arange(e.numel(), device=dev) \
            - (ends[e] - length[e] - base)
        dst = (at[e] * r_tile + a_r[e]) * n + b_j[f]
        out.index_add_(0, dst, a_v[e] * b_v[f])
        e0 = e1
    out = out.view(t, r_tile, n)
    nan = float("nan")
    # a non-finite B[k, j]: NaN in the rows of the listed A blocks of block
    # column k // bs whose slot (r, k) is zero
    for x in torch.nonzero(~torch.isfinite(b_v)).flatten().tolist():
        tile = int(bt[order[x]])
        k, j = int(b_k[order[x]]), int(b_j[x])
        on = torch.nonzero(a_cols[tile] == k // bs).flatten()
        zero = a_blocks[tile, on, :, k % bs] == 0            # [blocks, bs]
        blk, rr = torch.nonzero(zero, as_tuple=True)
        out[tile, a_rows[tile, on[blk]] * bs + rr, j] = nan
    # a non-finite A[r, k]: NaN at the columns that B row k does not hold
    for x in torch.nonzero(~torch.isfinite(a_v)).flatten().tolist():
        tile, r, k = int(at[x]), int(a_r[x]), int(a_k[x])
        held = torch.zeros(n, dtype=torch.bool, device=dev)
        lo, hi = int(b_ptr[tile * k_span + k]), int(b_ptr[tile * k_span + k
                                                          + 1])
        held[b_j[lo:hi]] = True
        out[tile, r, ~held] = nan
    out = out.to(out_dtype)
    return out[0] if single else out


def steal_pair_accumulate_raw_ref(a_pool, b_rows, pair_a, pair_b, pair_slot,
                                  n_slots: int,
                                  out_dtype: Optional[torch.dtype] = None
                                  ) -> torch.Tensor:
    """Pair products of a shared block pool and a shared dense B, summed in
    float32 into output block-rows: the JAX package's ``bsr_spmm_raw(
    a_pool[pair_a], pair_slot, pair_b, b_rows)`` without the gather of
    every pair's block up front.

    a_pool : [N, bs, bs];  b_rows : [K, n] (bs-row chunks);
    pair_a, pair_b, pair_slot : int[P] / int[T, P]
    returns [n_slots*bs, n] / [T, n_slots*bs, n] in ``promote(a_pool,
    b_rows)``: block-row ``s`` of tile ``t`` sums ``a_pool[pa] @ chunk pb``
    over the pairs of tile ``t`` with ``pair_slot == s``.  Every listed
    pair is multiplied, its zero blocks included (so ``0 * inf`` gives
    NaN, as the reference).
    """
    single = pair_a.dim() == 1
    if single:
        pair_a, pair_b, pair_slot = pair_a[None], pair_b[None], pair_slot[None]
    t, p = pair_a.shape
    bs, n = a_pool.shape[-1], b_rows.shape[-1]
    out_dtype = out_dtype or torch.promote_types(a_pool.dtype, b_rows.dtype)
    chunks = b_rows.reshape(-1, bs, n)
    tile = torch.arange(t, device=b_rows.device)[:, None]
    out = torch.zeros((t * n_slots, bs, n), dtype=torch.float32,
                      device=b_rows.device)
    step = max(1, _CHUNK_ELEMS // max(1, t * bs * n))
    for p0 in range(0, p, step):
        sl = slice(p0, p0 + step)
        part = torch.matmul(a_pool[pair_a[:, sl].long()].float(),
                            chunks[pair_b[:, sl].long()].float())
        dst = (tile * n_slots + pair_slot[:, sl].long()).reshape(-1)
        out.index_add_(0, dst, part.reshape(-1, bs, n))
    out = out.reshape(t, n_slots * bs, n).to(out_dtype)
    return out[0] if single else out


def bsr_spmm_ref(a_bsr, dense) -> torch.Tensor:
    """Oracle via explicit densification: to_dense(A) @ B in float32."""
    acc = torch.matmul(a_bsr.to_dense().float(), dense.float())
    return acc.to(torch.promote_types(a_bsr.dtype, dense.dtype))


def bsr_pair_accumulate_raw_ref(a_blocks, b_blocks, pair_a, pair_b,
                                pair_slot, n_slots: int) -> torch.Tensor:
    """Block-pair products accumulated into packed output slots.

    a_blocks : [Sa, bs, bs] or [T, Sa, bs, bs];  b_blocks likewise
    pair_a, pair_b, pair_slot : int[P] / int[T, P]
    returns float32 [n_slots, bs, bs] / [T, n_slots, bs, bs]: slot ``s``
    sums ``A[pa[p]] @ B[pb[p]]`` over the pairs with ``pair_slot[p] == s``
    (the JAX package's sorted ``segment_sum``; pairs of zero blocks are
    inert), in pair order.  The caller casts to the output dtype.
    """
    single = a_blocks.dim() == 3
    if single:
        a_blocks, b_blocks, pair_a, pair_b, pair_slot = (
            a_blocks[None], b_blocks[None], pair_a[None], pair_b[None],
            pair_slot[None])
    t, p = pair_a.shape
    bs = a_blocks.shape[-1]
    tile = torch.arange(t, device=a_blocks.device)[:, None]
    out = torch.zeros((t * n_slots, bs, bs), dtype=torch.float32,
                      device=a_blocks.device)
    step = max(1, _CHUNK_ELEMS // max(1, t * bs * bs))
    for p0 in range(0, p, step):
        sl = slice(p0, p0 + step)
        part = torch.matmul(a_blocks[tile, pair_a[:, sl].long()].float(),
                            b_blocks[tile, pair_b[:, sl].long()].float())
        dst = (tile * n_slots + pair_slot[:, sl].long()).reshape(-1)
        out.index_add_(0, dst, part.reshape(-1, bs, bs))
    out = out.reshape(t, n_slots, bs, bs)
    return out[0] if single else out


def bsr_pair_matmul_raw_ref(a_blocks, b_blocks, pair_a, pair_b, pair_rows,
                            pair_cols, n_block_rows: int, n_block_cols: int,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Block-pair products accumulated into a dense C tile.

    Pair ``p`` adds ``A[pa[p]] @ B[pb[p]]`` to output block
    ``(pair_rows[p], pair_cols[p])``; padding pairs point at zero blocks.
    Takes one tile or a batch (a leading tile dimension) and returns
    ``[nbr*bs, nbc*bs]`` / ``[T, nbr*bs, nbc*bs]``, summed in float32, in
    ``promote(a, b)`` unless ``out_dtype`` says otherwise.
    """
    single = a_blocks.dim() == 3
    if single:
        a_blocks, b_blocks, pair_a, pair_b, pair_rows, pair_cols = (
            x[None] for x in (a_blocks, b_blocks, pair_a, pair_b, pair_rows,
                              pair_cols))
    slots = pair_rows.long() * n_block_cols + pair_cols.long()
    out = bsr_pair_accumulate_raw_ref(a_blocks, b_blocks, pair_a, pair_b,
                                      slots, n_block_rows * n_block_cols)
    t, _, bs, _ = out.shape
    out = out.reshape(t, n_block_rows, n_block_cols, bs, bs).permute(
        0, 1, 3, 2, 4).reshape(t, n_block_rows * bs, n_block_cols * bs)
    out = out.to(out_dtype or torch.promote_types(a_blocks.dtype,
                                                  b_blocks.dtype))
    return out[0] if single else out


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
