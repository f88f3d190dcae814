"""``impl`` dispatch for the kernels (port of ``repro/kernels/ops.py``).

``impl``:
  * ``"cuda"`` — the hand-written CUDA kernel; CUDA tensors only.
  * ``"ref"``  — the plain PyTorch version (``kernels/ref.py``).
  * ``"auto"`` / ``None`` — the kernel for CUDA tensors, ``"ref"`` for CPU
    tensors.  A CUDA tensor never falls back to ``"ref"``: the kernel
    launches or raises.

Every op takes one tile or a batch of tiles with a leading tile dimension;
the stacked-grid executor passes all g² tiles of a ring step in one call.
The pair-list builders (``match_block_pairs``, ``build_pair_lists``) are
host numpy, bit-identical to the JAX package's.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from . import ref as _ref
from .bsr_pair import (PairTable, _host, bsr_pair_accumulate_cuda,
                       bsr_pair_matmul_cuda, pair_table)
from .bsr_spmm import SpmmTable, bsr_spmm_cuda, spmm_table
from .loader import refuse_autograd

__all__ = ["IMPLS", "default_impl", "bsr_spmm", "bsr_spmm_raw",
           "bsr_spmm_sparse_b_raw",
           "match_block_pairs", "build_pair_lists",
           "bsr_pair_matmul", "bsr_pair_accumulate", "steal_pair_accumulate",
           "densify", "densify_packed", "add_call_hook", "remove_call_hook"]

IMPLS = ("auto", "ref", "cuda")

# Listeners of the calls below (the op-trace lint,
# ``repro_torch.analysis.op_lint``, places the kernel launches among the
# aten ops it records: a CUDA kernel runs behind ctypes, where a dispatch
# mode cannot see it).  Each is called ``hook(name, "begin")`` before and
# ``hook(name, "end")`` after every call; with none installed a call
# costs one list test.
_CALL_HOOKS: list = []


def add_call_hook(hook: Callable[[str, str], None]) -> Callable:
    _CALL_HOOKS.append(hook)
    return hook


def remove_call_hook(hook: Callable[[str, str], None]) -> None:
    if hook in _CALL_HOOKS:
        _CALL_HOOKS.remove(hook)


def _announced(name: str):
    """Tell the :data:`_CALL_HOOKS` where each call of the wrapped op
    begins and ends."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _CALL_HOOKS:
                return fn(*args, **kwargs)
            hooks = list(_CALL_HOOKS)
            for hook in hooks:
                hook(name, "begin")
            try:
                return fn(*args, **kwargs)
            finally:
                for hook in hooks:
                    hook(name, "end")
        return call
    return deco


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


@_announced("bsr_spmm")
def bsr_spmm_raw(blocks, rows, cols, dense, *, n_block_rows: int,
                 impl: Optional[str] = None, augment: bool = True,
                 a_map=None, b_map=None, gidx=None,
                 table: Optional[SpmmTable] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = BSR(blocks, rows, cols) @ dense, for one tile or a batch.

    Batched, ``blocks [P, S, bs, bs]`` and ``dense [TB, K, n]`` are pools
    that output tile ``t`` reads in place through host tile maps: A tile
    ``a_map[t]`` and B tile ``b_map[t]`` (both the identity by default).
    Without ``gidx``, ``rows`` and ``cols`` are ``[P, S]``, each pool
    tile's list; with ``gidx [T, L]`` (the packed wire's consume lists)
    they are ``[T, L]`` too, and entry ``e`` of output tile ``t`` is block
    ``gidx[t, e]`` of pool tile ``a_map[t]``.  Lists need not be sorted or
    cover every block-row.  ``augment`` stays for the JAX package's
    signature: neither path needs coverage blocks (the plain version sums
    into zeros, the kernel zero-fills block-rows no block visits).

    ``out`` (the result's shape and type) is a carry: the product is added
    into it in place and ``out`` is returned (the JAX bodies' ``c + step``,
    the step rounded to C's type first).  ``table`` (kernel only) is the
    :func:`~repro_torch.kernels.bsr_spmm.spmm_table` of these lists at
    these maps; plans pass theirs, over real blocks only, with the element
    path's split where A's real blocks are nearly empty.  Built here when
    not given, every listed block counts as real, and the launch takes the
    block path: a raw call has no handle to keep element lists on.

    Non-finite B: both paths give the JAX package's result.  Every listed
    block takes part, the zero ones (capacity padding, coverage) too, so
    where B's chunk ``cols[e]`` holds an inf or a NaN in a column, block-row
    ``rows[e]`` of C holds a NaN in that column (``0 * inf``).  The plain
    version multiplies every listed block; the kernel multiplies the real
    ones and writes those NaNs from the entries its table left out.

    With tracing on, each call is a ``kernel.bsr_spmm`` span
    (:func:`repro_torch.obs.launch`), on the card with the device time of
    the kernel and its NaN pass and the table's path (``args.path``,
    ``"elements"`` or ``"blocks"``).
    """
    refuse_autograd("bsr_spmm", blocks, dense, out)
    impl = _resolve(impl, dense)
    single = blocks.dim() == 3
    if single:
        blocks, rows, cols, dense = (blocks[None], rows[None], cols[None],
                                     dense[None])
        gidx = None if gidx is None else gidx[None]
        out = None if out is None else out[None]
    n_out = len(a_map) if a_map is not None else \
        gidx.shape[0] if gidx is not None else blocks.shape[0]
    bs, n = blocks.shape[-1], dense.shape[-1]
    if n == 0:  # half-panel schedules can give empty panels at tiny widths
        res = dense.new_zeros(
            (n_out, n_block_rows * bs, 0),
            dtype=torch.promote_types(blocks.dtype, dense.dtype))
    elif impl == "ref":
        with _obs.launch("kernel.bsr_spmm"):
            res = _spmm_ref(blocks, rows, cols, dense, n_block_rows, a_map,
                            b_map, gidx, out)
    else:
        if table is None:
            a_idx = np.arange(n_out) if a_map is None \
                else _host(a_map).astype(np.int64)
            s = blocks.shape[1]
            if gidx is None:
                slots = np.broadcast_to(np.arange(s), (n_out, s))
                rows, cols = _host(rows)[a_idx], _host(cols)[a_idx]
            else:
                slots = _host(gidx)
            table = spmm_table(a_idx[:, None] * s + slots, rows, cols,
                               n_block_rows, b_map=b_map,
                               device=blocks.device)
        with _obs.launch("kernel.bsr_spmm", device=dense) as span:
            span.note(path=table.path)
            res = bsr_spmm_cuda(blocks.contiguous(), dense.contiguous(),
                                table, out=out)
    return res[0] if single else res


def _spmm_ref(blocks, rows, cols, dense, n_block_rows: int, a_map, b_map,
              gidx, out) -> torch.Tensor:
    """The plain path: read the pools through the maps (``index_select``),
    then the plain version, added into ``out`` when given."""
    dev = blocks.device
    if a_map is not None:
        a_idx = torch.as_tensor(_host(a_map), device=dev).long()
        blocks = blocks.index_select(0, a_idx)
        if gidx is None:
            rows, cols = rows.index_select(0, a_idx), cols.index_select(0,
                                                                        a_idx)
    if gidx is not None:
        tile = torch.arange(blocks.shape[0], device=dev)[:, None]
        blocks = blocks[tile, gidx.long()]
    if b_map is not None:
        dense = dense.index_select(
            0, torch.as_tensor(_host(b_map), device=dev).long())
    res = _ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, n_block_rows)
    return res if out is None else out.add_(res)


@_announced("bsr_spmm")
def bsr_spmm_sparse_b_raw(a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols,
                          *, n_block_rows: int, n_block_cols: int,
                          impl: Optional[str] = None, a_map=None, b_map=None,
                          table: Optional[SpmmTable] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = BSR(a) @ densify(BSR(b)) into a dense C, for one tile or a batch,
    with B left sparse: B1's sparse-B path.

    Batched, ``a_blocks [P, S, bs, bs]`` and ``b_blocks [PB, SB, bs',
    bs']`` are pools (with their ``[P, S]`` / ``[PB, SB]`` lists) that
    output tile ``t`` reads in place: A tile ``a_map[t]`` and B tile
    ``b_map[t]`` (both the identity by default).  B's tiles have
    ``n_block_cols * bs'`` columns.  ``out`` is a carry, as in
    :func:`bsr_spmm_raw`.  The plain path
    (:func:`~repro_torch.kernels.ref.bsr_spmm_sparse_b_raw_ref`) multiplies
    the nonzeros of every listed block; the kernel needs ``table``, a
    plan's :func:`~repro_torch.kernels.bsr_spmm.spmm_table` with the
    sparse-B work (both handles' element lists), and multiplies the real
    blocks' nonzeros, with the same result on any input: that of A's listed
    blocks times the densified B.  With tracing on, each call is a
    ``kernel.bsr_spmm`` span, ``args.path`` ``"sparse_b"`` on the card.
    """
    refuse_autograd("bsr_spmm", a_blocks, b_blocks, out)
    impl = _resolve(impl, b_blocks)
    single = a_blocks.dim() == 3
    if single:
        a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols = (
            x[None] for x in (a_blocks, a_rows, a_cols, b_blocks, b_rows,
                              b_cols))
        out = None if out is None else out[None]
    if impl == "ref":
        dev = a_blocks.device
        with _obs.launch("kernel.bsr_spmm"):
            if a_map is not None:
                a_idx = torch.as_tensor(_host(a_map), device=dev).long()
                a_blocks, a_rows, a_cols = (x.index_select(0, a_idx) for x
                                            in (a_blocks, a_rows, a_cols))
            if b_map is not None:
                b_idx = torch.as_tensor(_host(b_map), device=dev).long()
                b_blocks, b_rows, b_cols = (x.index_select(0, b_idx) for x
                                            in (b_blocks, b_rows, b_cols))
            res = _ref.bsr_spmm_sparse_b_raw_ref(
                a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols,
                n_block_rows, n_block_cols)
            res = res if out is None else out.add_(res)
    else:
        if table is None or table.sparse_b is None:
            raise ValueError("the sparse-B kernel runs a plan's table, which "
                             "holds both handles' element lists; without "
                             "one, densify B and call bsr_spmm_raw")
        with _obs.launch("kernel.bsr_spmm", device=b_blocks) as span:
            span.note(path=table.path)
            res = bsr_spmm_cuda(a_blocks.contiguous(), b_blocks.contiguous(),
                                table, out=out)
    return res[0] if single else res


def bsr_spmm(a_bsr, dense, *, impl: Optional[str] = None) -> torch.Tensor:
    """C = A @ dense for a :class:`repro_torch.core.bsr.BSR` A."""
    return bsr_spmm_raw(a_bsr.blocks, a_bsr.rows, a_bsr.cols, dense,
                        n_block_rows=a_bsr.n_block_rows, impl=impl)


# ---------------------------------------------------------------------------
# SpGEMM with host-known structure: pair lists (host numpy) and the kernels
# ---------------------------------------------------------------------------
def match_block_pairs(a_cols, b_rows):
    """Vectorized sort-merge join on ``a_cols[i] == b_rows[j]`` (host numpy).

    Every (A block, B block) pair whose product contributes to C, as
    ``(ai, bj)`` index arrays into the given lists; within one A block the
    matched B blocks keep their order (stable argsort).  Shared by
    :func:`build_pair_lists` and ``repro_torch.core.symbolic``.
    """
    a_cols = np.asarray(a_cols, dtype=np.int64)
    b_rows = np.asarray(b_rows, dtype=np.int64)
    b_order = np.argsort(b_rows, kind="stable")
    b_rows_sorted = b_rows[b_order]
    starts = np.searchsorted(b_rows_sorted, a_cols, side="left")
    ends = np.searchsorted(b_rows_sorted, a_cols, side="right")
    deg = ends - starts
    ai = np.repeat(np.arange(len(a_cols), dtype=np.int64), deg)
    offs = np.arange(deg.sum(), dtype=np.int64) - np.repeat(
        np.cumsum(deg) - deg, deg)
    bj = b_order[np.repeat(starts, deg) + offs]
    return ai, bj


def build_pair_lists(a_rows, a_cols, a_nnzb: int, b_rows, b_cols, b_nnzb: int,
                     n_block_rows: int, n_block_cols: int,
                     capacity: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, int]:
    """Host-side symbolic phase of a one-tile block SpGEMM.

    Matches stored blocks of A and B (``a_cols[i] == b_rows[j]``) and emits
    flat pair lists sorted by output block (row, col).  Every output block
    is covered at least once (uncovered blocks get a dummy pair on the zero
    slot that :func:`bsr_pair_matmul` appends).  Returns ``(pair_a,
    pair_b, pair_rows, pair_cols, n_real_pairs)``; index ``a_nnzb`` /
    ``b_nnzb`` is the appended zero slot.
    """
    a_rows = _host(a_rows)[:a_nnzb].astype(np.int64)
    a_cols = _host(a_cols)[:a_nnzb].astype(np.int64)
    b_rows = _host(b_rows)[:b_nnzb].astype(np.int64)
    b_cols = _host(b_cols)[:b_nnzb].astype(np.int64)
    ai, bj = match_block_pairs(a_cols, b_rows)
    rows = a_rows[ai]
    cols = b_cols[bj]
    # coverage: dummy pairs for the output blocks no real product touches
    zslot_a, zslot_b = a_nnzb, b_nnzb
    covered = np.zeros((n_block_rows, n_block_cols), dtype=bool)
    covered[rows, cols] = True
    ur, uc = np.nonzero(~covered)
    pair_rows = np.concatenate([rows, ur])
    pair_cols = np.concatenate([cols, uc])
    pair_a = np.concatenate([ai, np.full(len(ur), zslot_a, np.int64)])
    pair_b = np.concatenate([bj, np.full(len(ur), zslot_b, np.int64)])
    # stable sort by output block (row, col), ties in construction order
    order = np.lexsort((np.arange(len(pair_rows)), pair_cols, pair_rows))
    pair_a, pair_b = pair_a[order], pair_b[order]
    pair_rows, pair_cols = pair_rows[order], pair_cols[order]
    n_real = len(pair_rows)
    cap = capacity if capacity is not None else n_real
    if n_real > cap:
        raise ValueError(f"pair capacity {cap} < required {n_real}")
    pad = cap - n_real
    pair_rows = np.concatenate([pair_rows, np.full(pad, pair_rows[-1])])
    pair_cols = np.concatenate([pair_cols, np.full(pad, pair_cols[-1])])
    pair_a = np.concatenate([pair_a, np.full(pad, zslot_a, np.int64)])
    pair_b = np.concatenate([pair_b, np.full(pad, zslot_b, np.int64)])
    return (pair_a.astype(np.int32), pair_b.astype(np.int32),
            pair_rows.astype(np.int32), pair_cols.astype(np.int32), n_real)


def _pairs(x, like: torch.Tensor) -> torch.Tensor:
    """A pair list as an int32 tensor on the blocks' device."""
    return torch.as_tensor(x, device=like.device).to(torch.int32)


@_announced("bsr_pair_matmul")
def bsr_pair_matmul(a_blocks, b_blocks, pair_a, pair_b, pair_rows, pair_cols,
                    *, n_block_rows: int, n_block_cols: int,
                    impl: Optional[str] = None,
                    table: Optional[PairTable] = None) -> torch.Tensor:
    """Dense C tile(s) from matched block pairs (see :func:`build_pair_lists`).

    One tile (``a_blocks [Sa, bs, bs]``, pair lists ``[P]``) or a batch
    (``[T, Sa, bs, bs]``, ``[T, P]``).  A zero slot is appended to each
    tile's A and B blocks, as the JAX wrapper does.  Returns ``promote(a,
    b)``.  ``table`` (kernel only) is the :func:`pair_table` of the slots
    ``pair_rows * n_block_cols + pair_cols``, built here when not given,
    with the pairs on the appended zero slots of both operands inert.
    """
    refuse_autograd("bsr_pair_matmul", a_blocks, b_blocks)
    impl = _resolve(impl, a_blocks)
    single = a_blocks.dim() == 3
    lists = [_pairs(x, a_blocks) for x in (pair_a, pair_b, pair_rows,
                                           pair_cols)]
    if single:
        a_blocks, b_blocks = a_blocks[None], b_blocks[None]
        lists = [x[None] for x in lists]
    out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    a_ext, b_ext = (torch.cat([x, x.new_zeros((x.shape[0], 1,
                                               *x.shape[2:]))], dim=1)
                    for x in (a_blocks, b_blocks))
    if impl == "ref":
        out = _ref.bsr_pair_matmul_raw_ref(a_ext, b_ext, *lists,
                                           n_block_rows, n_block_cols)
    else:
        pa, pb, pr, pc = lists
        if table is None:
            # the coverage dummies and padding pairs on the appended zero
            # slots are inert
            za, zb = a_blocks.shape[1], b_blocks.shape[1]
            table = pair_table(pr.long() * n_block_cols + pc.long(),
                               n_block_rows * n_block_cols,
                               real=(pa != za) | (pb != zb),
                               device=a_blocks.device)
        out = bsr_pair_matmul_cuda(
            a_ext.contiguous(), b_ext.contiguous(), pa.contiguous(),
            pb.contiguous(), table, n_block_rows=n_block_rows,
            n_block_cols=n_block_cols).to(out_dtype)
    return out[0] if single else out


@_announced("bsr_pair_accumulate")
def bsr_pair_accumulate(a_blocks, b_blocks, pair_a, pair_b, pair_slot, *,
                        n_slots: int, out_dtype: Optional[torch.dtype] = None,
                        impl: Optional[str] = None,
                        table: Optional[PairTable] = None,
                        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed C blocks from matched pairs: the sparse-output SpGEMM inner.

    Products accumulate into a flat ``[n_slots, bs, bs]`` slot array per
    tile (the symbolic phase's output layout).  Contract (established by
    ``repro_torch.core.symbolic``): ``pair_slot`` is nondecreasing and
    dummy pairs reference zero blocks; a slot that no pair visits comes
    out zero.  ``pair_a``/``pair_b`` may index the stored or the packed
    wire layout.  One tile or a ``[T, ...]`` batch.

    ``acc`` (float32, the output's shape) is a carry: the step's sums are
    added into it in place, each slot's sum once, as the JAX bodies' ``c +
    step``, and ``acc`` is returned (``out_dtype`` does not apply).
    ``table`` (kernel only) is the :func:`pair_table` of ``pair_slot``;
    plans pass the one they built at plan time from the symbolic phase's
    real-pair mask (the kernel then skips the inert pairs, and an
    accumulate leaves the slots no real pair visits untouched); built here
    without a mask, every pair counts as real.
    """
    refuse_autograd("bsr_pair_accumulate", a_blocks, b_blocks, acc)
    impl = _resolve(impl, a_blocks)
    pair_a, pair_b, pair_slot = (_pairs(x, a_blocks)
                                 for x in (pair_a, pair_b, pair_slot))
    if impl == "ref":
        out = _ref.bsr_pair_accumulate_raw_ref(a_blocks, b_blocks, pair_a,
                                               pair_b, pair_slot, n_slots)
        if acc is not None:
            return acc.add_(out)
        return out.to(out_dtype or torch.promote_types(a_blocks.dtype,
                                                       b_blocks.dtype))
    single = a_blocks.dim() == 3
    if single:
        a_blocks, b_blocks, pair_a, pair_b, pair_slot = (
            x[None] for x in (a_blocks, b_blocks, pair_a, pair_b, pair_slot))
        acc = None if acc is None else acc[None]
    if table is None:
        table = pair_table(pair_slot, n_slots, device=a_blocks.device)
    out = bsr_pair_accumulate_cuda(
        a_blocks.contiguous(), b_blocks.contiguous(), pair_a.contiguous(),
        pair_b.contiguous(), table, out=acc)
    if acc is None:
        out = out.to(out_dtype or torch.promote_types(a_blocks.dtype,
                                                      b_blocks.dtype))
    return out[0] if single else out


@_announced("bsr_spmm")
def steal_pair_accumulate(a_pool, b_rows, pair_a, pair_b, pair_slot, *,
                          n_slots: int, impl: Optional[str] = None,
                          table: Optional[SpmmTable] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partial C tiles of the steal3d dispatch, one per device, from
    plan-built pair lists (``repro_torch.core.steal3d``).

    ``a_pool`` ``[N, bs, bs]`` is the block pool every device's pairs
    index (the placed A stack or the packed buffers, flattened), ``b_rows``
    ``[K, n]`` the B pool flattened to bs-row chunks (the placed B stack as
    one flat tile).  Pair ``p`` of device ``t`` multiplies ``a_pool[
    pair_a[t, p]]`` by chunk ``pair_b[t, p]`` into block-row ``pair_slot[t,
    p]`` of that device's ``[n_slots * bs, n]`` output: the JAX package's
    ``bsr_spmm_raw`` contract with pair lists in place of a tile's stored
    structure, so the kernel is B1 (output tile = device, one B tile).
    Lists ``[P]`` (one device) or ``[T, P]``.  ``out`` is a carry, as in
    :func:`bsr_spmm_raw`.  ``table`` (kernel only) is the plan's
    :func:`~repro_torch.kernels.bsr_spmm.spmm_table` of these lists with
    the dummy and coverage pairs left out (their non-finite rule is
    :func:`bsr_spmm_raw`'s); built here without a mask, every pair counts
    as real.  Pair lists take B1's block path (no handle keeps element
    lists for them).
    """
    refuse_autograd("bsr_spmm (steal3d pair lists)", a_pool, b_rows, out)
    impl = _resolve(impl, b_rows)
    single = pair_a.dim() == 1
    if single:
        pair_a, pair_b, pair_slot = pair_a[None], pair_b[None], pair_slot[None]
        out = None if out is None else out[None]
    if impl == "ref":
        with _obs.launch("kernel.bsr_spmm"):
            res = _ref.steal_pair_accumulate_raw_ref(
                a_pool, b_rows, pair_a, pair_b, pair_slot, n_slots)
            res = res if out is None else out.add_(res)
    else:
        if table is None:
            table = spmm_table(pair_a, pair_slot, pair_b, n_slots,
                               b_map=np.zeros(pair_a.shape[0], np.int64),
                               device=b_rows.device)
        with _obs.launch("kernel.bsr_spmm", device=b_rows) as span:
            span.note(path=table.path)
            res = bsr_spmm_cuda(
                a_pool.reshape(1, *a_pool.shape).contiguous(),
                b_rows.reshape(1, *b_rows.shape).contiguous(), table,
                out=out)
    return res[0] if single else res


@_announced("densify")
def densify(blocks, rows, cols, *, n_block_rows: int,
            n_block_cols: int) -> torch.Tensor:
    return _ref.densify_raw(blocks, rows, cols, n_block_rows, n_block_cols)


@_announced("densify_packed")
def densify_packed(blocks, dmap, *, n_block_rows: int, n_block_cols: int,
                   tile_map=None) -> torch.Tensor:
    """Dense tile(s) from packed wire blocks by a gather.

    ``dmap`` maps every dense block position, row-major, to the packed slot
    holding its data or to a guaranteed-zero slot (``core/wire.py``), so
    the scatter of :func:`densify` becomes a gather and a transpose.  One
    tile (``blocks [wc, bs, bs]``, ``dmap [nbr*nbc]``) or a batch
    (``blocks [P, wc, bs, bs]``, ``dmap [T, nbr*nbc]``), where output tile
    ``t`` reads packed tile ``tile_map[t]`` (an int tensor on the blocks'
    device; tile ``t`` by default) in place.
    """
    single = blocks.dim() == 3
    if single:
        blocks, dmap = blocks[None], dmap[None]
    t = dmap.shape[0]
    bs = blocks.shape[-1]
    tile = torch.arange(t, device=blocks.device) if tile_map is None \
        else tile_map.to(blocks.device).long()
    d = blocks[tile[:, None], dmap.long()].reshape(t, n_block_rows,
                                                   n_block_cols, bs, bs)
    d = d.permute(0, 1, 3, 2, 4).reshape(t, n_block_rows * bs,
                                         n_block_cols * bs)
    return d[0] if single else d
