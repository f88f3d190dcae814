"""B1's element path on the CPU: the fill counted with the real mask, the
element lists a handle keeps (each real block's nonzeros, row by row)
against a numpy reference, the path a plan picks, and each ring step's
element table replayed in plain PyTorch as the CUDA kernel runs it
(units of rows, the zero fill, the carry, the NaN pass with the zero
slots it skips).  The kernel itself runs only on a card
(``test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import bsr as tbsr
from repro_torch.core.api import NATURAL, DistBSR, DistDense, plan_matmul
from repro_torch.core.grid import ProcessGrid
from repro_torch.kernels import bsr_spmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bsr_spmm import (ELEMENT_FILL, SPLIT_ROW,
                                          element_lists, pick_path,
                                          spmm_table)

CPU = torch.device("cpu")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BS = 16


def _low_fill(g: int, seed: int) -> np.ndarray:
    """A matrix whose real blocks are nearly empty (fill well under
    ELEMENT_FILL at bs 16), with a hub row longer than SPLIT_ROW in each
    tile it crosses, zero block-rows and a NaN element."""
    m = (g + 1) * BS * 10
    a = tbsr.random_sparse(m, m, 0.001, seed=seed)
    rng = np.random.default_rng(seed)
    hub = rng.choice(m, size=(SPLIT_ROW + 8) * g, replace=False)
    a[3, hub] = rng.standard_normal(hub.size)
    a[BS:2 * BS] = 0                                 # an empty block-row
    a[5, 7] = np.nan
    return a


def _handle(g: int, dtype: str, seed: int = 0) -> DistBSR:
    return DistBSR.from_dense(_low_fill(g, seed + g), g=g, block_size=BS,
                              dtype=getattr(torch, dtype), device=CPU)


def _pool(a_h: DistBSR, wire: str) -> torch.Tensor:
    pool = (a_h.packed_wire if wire == "packed" else a_h.placed)(
        NATURAL)["blocks"]
    return pool.reshape(-1, *pool.shape[-3:])


def _replay(blocks, dense, table, out=None):
    """B1's element path step by step in plain PyTorch, as the kernel runs
    it: each unit's rows sum their entries' A values (read in the pool at
    ``aoff``) times the B rows ``brow`` of the unit's B tile in float32
    and store C (fresh, or C + the sum rounded to C's type); a fresh output
    zero-fills the block-rows no real block visits; then the NaN pass: the
    non-finite rows of every flagged B chunk counted by column, NaN into
    each skipped entry's block-row where its chunk has any, and into row r
    of a visited block-row where the segment's real blocks meet more
    non-finite rows than r's nonzeros do.  Returns C."""
    el = table.elements
    lists = el.lists
    pool = blocks.reshape(-1)
    bs = lists.pool_shape[2]
    nbr, t, n = table.n_block_rows, table.tiles, dense.shape[-1]
    r_tile = nbr * bs
    dtype = torch.promote_types(blocks.dtype, dense.dtype)
    fresh = out is None
    c = torch.full((t, r_tile, n), float("nan"), dtype=dtype) if fresh \
        else out.clone()
    written = torch.zeros((t, r_tile), dtype=torch.int64)
    rp = lists.rowptr.tolist()
    brow, aoff = lists.brow.long(), lists.aoff.long()
    for tile, q, b_tile, row0, rows, _ in el.units.T.tolist():
        assert rows >= 1
        for x in range(row0, row0 + rows):
            lo, hi = rp[q * r_tile + x], rp[q * r_tile + x + 1]
            acc = (pool[aoff[lo:hi]].float()[:, None]
                   * dense[b_tile, brow[lo:hi]].float()).sum(dim=0)
            c[tile, x] = acc.to(dtype) if fresh else \
                (c[tile, x].float() + acc.to(dtype).float()).to(dtype)
            written[tile, x] += 1
    if fresh:
        for tile, r in table.fill.T.tolist():
            c[tile, r * bs:(r + 1) * bs] = 0
            written[tile, r * bs:(r + 1) * bs] += 1
        assert bool((written == 1).all()), "a row is left unwritten"
    assert int(written.max()) <= 1, "a row is written twice"
    if not el.flag_chunks.shape[1]:
        return c
    counts = torch.stack([
        (~torch.isfinite(dense[b_tile, col * bs:(col + 1) * bs].float()))
        .sum(dim=0) for b_tile, col in el.flag_chunks.T.tolist()])
    for tile, r, u in table.skip.T.tolist():
        c[tile, r * bs:(r + 1) * bs][:, counts[u] > 0] = float("nan")
    chunks = el.seg_chunks.long()
    for tile, r, q, b_tile, first, end in el.segs.T.tolist():
        bad = counts[chunks[first:end]].sum(dim=0)
        for x in range(r * bs, (r + 1) * bs):
            lo, hi = rp[q * r_tile + x], rp[q * r_tile + x + 1]
            met = (~torch.isfinite(dense[b_tile, brow[lo:hi]].float())) \
                .sum(dim=0)
            c[tile, x][bad > met] = float("nan")
    return c


def _plain(a_h, wire, dense, a_map, b_map):
    """The plain version of one step over the natural pool: every listed
    block, zero slots and zero blocks included."""
    ex_pool = _pool(a_h, wire)
    n = a_h.g * a_h.g
    if wire == "packed":
        po = a_h.packed_operand()
        gidx = torch.as_tensor(po.gidx.reshape(n, -1)[a_map])
        rows = torch.as_tensor(po.rows.reshape(n, -1)[a_map])
        cols = torch.as_tensor(po.cols.reshape(n, -1)[a_map])
        return tops.bsr_spmm_raw(ex_pool, rows, cols, dense,
                                 n_block_rows=a_h.tile_shape[0] // BS,
                                 impl="ref", a_map=a_map, b_map=b_map,
                                 gidx=gidx)
    placed = a_h.placed(NATURAL)
    s = ex_pool.shape[1]
    return tops.bsr_spmm_raw(ex_pool, placed["rows"].reshape(-1, s),
                             placed["cols"].reshape(-1, s), dense,
                             n_block_rows=a_h.tile_shape[0] // BS,
                             impl="ref", a_map=a_map, b_map=b_map)


def _steps(plan, a_h):
    """Each ring step's launch maps over the natural stacks."""
    for step, ((a_map, b_map),) in enumerate(plan.launch_maps()):
        yield step, a_map, b_map


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["padded", "packed"])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_element_lists_match_a_numpy_reference(g, wire, dtype):
    """Each pool tile row's entries are the nonzeros (NaN included) of the
    real blocks its list names in that block-row, in list order and then
    column, with the B row (block column * bs + c) and the pool element of
    A's value; capacity padding, coverage zeros, the packed wire's zero
    tail and the zero slots of real blocks give none."""
    a_h = _handle(g, dtype)
    pool = _pool(a_h, wire)
    lists = a_h.pool_lists(wire == "packed")
    nbr = a_h.tile_shape[0] // BS
    el = element_lists(pool, lists, nbr)
    p, s = pool.shape[:2]
    assert el.pool_shape == tuple(pool.shape)
    host = pool.float().numpy()
    want_ptr, want_brow, want_aoff = [0], [], []
    for q in range(p):
        ents = []
        for e in np.flatnonzero(lists.real[q]):
            slot = int(lists.slots[q, e])
            rr, cc = np.nonzero(host[q, slot] != 0)
            ents += [(int(lists.rows[q, e]) * BS + r, e, c,
                      int(lists.cols[q, e]) * BS + c,
                      (q * s + slot) * BS * BS + r * BS + c)
                     for r, c in zip(rr, cc)]
        ents.sort()
        per_row = np.bincount([x[0] for x in ents], minlength=nbr * BS)
        want_ptr += (want_ptr[-1] + np.cumsum(per_row)).tolist()
        want_brow += [x[3] for x in ents]
        want_aoff += [x[4] for x in ents]
    np.testing.assert_array_equal(el.rowptr.numpy(), want_ptr)
    np.testing.assert_array_equal(el.brow.numpy(), want_brow)
    np.testing.assert_array_equal(el.aoff.numpy(), want_aoff)
    np.testing.assert_array_equal(el.row_nnz.reshape(-1),
                                  np.diff(want_ptr))
    assert el.n_elements == int(torch.count_nonzero(a_h.tiled.blocks))
    assert np.isnan(host.reshape(-1)[el.aoff.numpy()]).sum() == 1
    # the pool slots and elements the lists name hold A's values
    assert a_h.element_lists(wire == "packed") \
        is a_h.element_lists(wire == "packed")


@pytest.mark.parametrize("source", ["float32", "bfloat16", "cast", "host",
                                    "balanced", "slabs"])
def test_counted_fill_equals_count_nonzero(source, monkeypatch):
    """The fill (nonzeros over the real blocks' slots) comes from the pass
    that finds the real blocks, on every way a layout is made and however
    few blocks the pass tests at once, and equals ``torch.count_nonzero``
    of the stored blocks (a NaN counts)."""
    if source == "slabs":
        monkeypatch.setattr(tbsr, "COUNT_SLAB", 3 * BS * BS)
    a = _low_fill(2, 5)
    a[40, 41] = 1e-30          # rounds to zero in bfloat16 (the cast)
    dtype = {"bfloat16": torch.bfloat16, "cast": torch.bfloat16}.get(source)
    src = torch.from_numpy(a).to(torch.bfloat16) if source == "bfloat16" \
        else a
    t = tbsr.TiledBSR.from_dense(src, ProcessGrid(2, 2), BS, dtype=dtype,
                                 balance="rows" if source == "balanced"
                                 else "none", device=CPU)
    if source in ("host", "slabs"):
        del t.host_layout
    nnz = int(torch.count_nonzero(t.blocks))
    real = int(t.host()["real"].sum())
    assert t.host()["nnz"] == nnz
    assert t.fill() == nnz / (real * BS * BS)
    assert 0 < t.fill() < ELEMENT_FILL
    assert real == int((t.blocks != 0).flatten(-2).any(-1).sum())
    # a layout given without a count (a sparse product's) has no fill
    del t.host_layout["nnz"], t.host_layout["fill"]
    assert t.fill() is None


def test_fill_is_counted_once_per_handle():
    """Every ring step's table reads A's fill: the first read counts it
    over the real mask and keeps it beside the layout, so later reads make
    no pass over the mask."""
    a_h = _handle(2, "float32")
    t = a_h.tiled
    fill = t.fill()
    assert t.host()["fill"] == fill
    t.host()["real"] = np.ones_like(t.host()["real"])   # a recount differs
    assert t.fill() == fill


@pytest.mark.parametrize("case", ["rmat_bs128", "dispatch_bs8", "unknown"])
def test_path_follows_the_fill(case):
    """A plan's table takes the element path at the cells' fill (R-MAT at
    bs 128, a few nonzeros a block), the block path at fill 1 (bs 8
    blocks as full as MoE dispatch's and the block-causal P_bd's) and
    where the fill is unknown."""
    if case == "rmat_bs128":
        a = tbsr.rmat_matrix(11, 8, seed=1) * np.random.default_rng(
            1).standard_normal((2048, 2048)).astype(np.float32)
        a_h = DistBSR.from_dense(a, g=2, block_size=128, device=CPU)
        want = "elements"
    else:
        a = np.kron(np.eye(8, dtype=np.float32)[:, np.r_[1:8, 0]],
                    np.ones((8, 8), np.float32))         # full 8 x 8 blocks
        a_h = DistBSR.from_dense(a, g=2, block_size=8, device=CPU)
        want = "blocks"
        if case == "unknown":
            del a_h.tiled.host_layout["nnz"]
    fill = a_h.tiled.fill()
    assert pick_path(fill) == want
    if case == "rmat_bs128":
        assert fill < ELEMENT_FILL / 2
    elif case == "dispatch_bs8":
        assert fill == 1.0
    b = DistDense.for_rhs(np.ones((a.shape[1], 4), np.float32), a_h)
    plan = plan_matmul(a_h, b)
    ex = plan.executor
    table = plan.spmm_table(a_h, ex.identity_map(), ex.identity_map())
    assert table.path == want
    assert (table.elements is None) == (want == "blocks")


@pytest.mark.parametrize("wire", ["padded", "packed"])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_element_tables_replay_the_ring_steps(g, wire):
    """Each ring step's table on the element path: its units cover every
    row of every block-row a real block visits once, in runs of one
    block-row (a row longer than SPLIT_ROW alone), by tile and most
    entries first, crediting the step's real blocks once; replayed, fresh
    and into a carry, it gives the step's product; the table is cached
    and names the handle's lists."""
    a_h = _handle(g, "float32")
    b = np.random.default_rng(g).standard_normal(
        (a_h.shape[1], 12)).astype(np.float32)
    b_h = DistDense.for_rhs(b, a_h)
    plan = plan_matmul(a_h, b_h, wire=wire)
    assert plan.wire == wire
    pool = _pool(a_h, wire)
    b_pool = plan.executor.batch(b_h.placed(NATURAL)["dense"])
    nbr = a_h.tile_shape[0] // BS
    split = 0
    for step, a_map, b_map in _steps(plan, a_h):
        table = plan.spmm_table(a_h, a_map, b_map)
        assert plan.spmm_table(a_h, a_map, b_map) is table
        el = table.elements
        assert table.path == "elements"
        assert el.lists is a_h.element_lists(wire == "packed")
        tile, q, b_tile, row0, rows, credit = el.units.numpy()
        np.testing.assert_array_equal(q, np.asarray(a_map)[tile])
        np.testing.assert_array_equal(b_tile, np.asarray(b_map)[tile])
        assert (row0 // BS == (row0 + rows - 1) // BS).all()
        covered = {(t_, x) for t_, x0, k in zip(tile, row0, rows)
                   for x in range(x0, x0 + k)}
        assert len(covered) == int(rows.sum())
        visited = {(t_, r) for t_, r in el.segs.numpy()[:2].T}
        assert covered == {(t_, r * BS + x) for t_, r in visited
                           for x in range(BS)}
        assert not visited & set(map(tuple, table.fill.numpy().T))
        assert int(credit.sum()) == table.real_blocks
        entries = np.array([el.lists.row_nnz[q_, x0:x0 + k].sum()
                            for q_, x0, k in zip(q, row0, rows)])
        assert el.n_elements == int(entries.sum())
        assert (np.diff(tile) >= 0).all()
        assert all((np.diff(entries[tile == t_]) <= 0).all()
                   for t_ in range(g * g))
        long_rows = {(q_, x) for q_ in range(g * g) for x in np.flatnonzero(
            el.lists.row_nnz[q_] > SPLIT_ROW)}
        split += sum(k == 1 and (q_, x0) in long_rows
                     for q_, x0, k in zip(q, row0, rows))
        assert all(k == 1 for q_, x0, k in zip(q, row0, rows)
                   if (q_, x0) in long_rows)
        want = _plain(a_h, wire, b_pool, a_map, b_map)
        got = _replay(pool, b_pool, table)
        finite = ~torch.isnan(want)                 # A's NaN element
        np.testing.assert_array_equal(torch.isnan(got).numpy(),
                                      (~finite).numpy())
        np.testing.assert_allclose(got[finite].numpy(),
                                   want[finite].numpy(), rtol=1e-5,
                                   atol=1e-5)
        carry = torch.from_numpy(np.random.default_rng(step).standard_normal(
            want.shape).astype(np.float32))
        got = _replay(pool, b_pool, table, out=carry)
        np.testing.assert_allclose(got[finite].numpy(),
                                   (carry + want)[finite].numpy(),
                                   rtol=1e-5, atol=1e-5)
        unvisited = [(t_, r) for t_ in range(g * g) for r in range(nbr)
                     if (t_, r) not in visited]
        for t_, r in unvisited:                       # left as they were
            rows_r = slice(r * BS, (r + 1) * BS)
            assert torch.equal(got[t_, rows_r], carry[t_, rows_r])
    assert split > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_element_nan_pass_gives_the_plain_mask(wire, dtype):
    """On B with an inf, a -inf and a NaN, the element path's replay gives
    the plain version's NaN mask, fresh and into a carry: NaN wherever a
    zero slot of a real block, a zero block or a zero-tail entry meets a
    non-finite B row; a row whose nonzero meets the only non-finite row at
    a column keeps its +-inf."""
    g = 2
    a_h = _handle(g, dtype, seed=3)
    b_h = DistDense.for_rhs(np.ones((a_h.shape[1], 6), np.float32), a_h)
    plan = plan_matmul(a_h, b_h, wire=wire)
    pool = _pool(a_h, wire)
    dt = getattr(torch, dtype)
    b_pool = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (g * g, a_h.tile_shape[1], 6)).astype(np.float32)).to(dt)
    ex = plan.executor
    a_map = b_map = ex.identity_map()
    table = plan.spmm_table(a_h, a_map, b_map)
    el = table.elements
    b_pool[-1, 5, 0] = float("nan")
    b_pool[1, 9, 4] = float("-inf")
    # an inf at the B row of a nonzero's column in a chunk that no zero
    # block of its block-row reads: that row keeps its +-inf
    b0 = int(b_map[0])
    for e in range(el.lists.n_elements):
        row = int(el.lists.brow[e])
        if row >= BS:           # chunk 0 meets every coverage zero block
            b_pool[b0, row, 2] = float("inf")
            want = _plain(a_h, wire, b_pool, a_map, b_map)
            if bool(torch.isinf(want).any()):
                break
            b_pool[b0, row, 2] = 1.0
    got = _replay(pool, b_pool, table)
    nan = torch.isnan(want)
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan.numpy())
    inf = torch.isinf(want)
    assert bool(inf.any()) and bool(nan.any()) and not bool(nan.all())
    assert torch.equal(got[inf], want[inf])
    np.testing.assert_allclose(got[~nan & ~inf].float().numpy(),
                               want[~nan & ~inf].float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    carry = torch.ones(want.shape, dtype=dt)
    got = _replay(pool, b_pool, table, out=carry)
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan.numpy())
    # the flagged chunks: the skipped entries' first, then the real ones
    assert torch.equal(el.flag_chunks[:, :table.skip_chunks.shape[1]],
                       table.skip_chunks)


def test_raw_tables_and_element_caches():
    """A raw table (no handle's lists) takes the block path; a plan keys
    its element tables on the handle, so two handles of one block
    structure with other nonzeros get their own tables."""
    a_h = _handle(2, "float32")
    t = a_h.tiled
    s = t.store_capacity
    rows, cols = t.rows.reshape(4, s), t.cols.reshape(4, s)
    slots = torch.arange(4)[:, None] * s + torch.arange(s)
    assert spmm_table(slots, rows, cols, a_h.tile_shape[0] // BS).path \
        == "blocks"
    a = t.to_dense().numpy()
    other = a.copy()
    nz = np.argwhere(a != 0)
    r, c = nz[len(nz) // 2]
    other[r, (c // BS) * BS:(c // BS + 1) * BS] = 2.0   # same blocks
    b_h = DistBSR.from_dense(other, g=2, block_size=BS, device=CPU)
    assert b_h.structure_key() == a_h.structure_key()
    dense = DistDense.for_rhs(np.ones((a.shape[1], 4), np.float32), a_h)
    plan = plan_matmul(a_h, dense)
    ex = plan.executor
    maps = ex.identity_map(), ex.identity_map()
    ta, tb = plan.spmm_table(a_h, *maps), plan.spmm_table(b_h, *maps)
    assert ta is not tb
    assert ta.elements.lists is not tb.elements.lists
    assert tb.elements.n_elements == ta.elements.n_elements + int(
        (other != 0).sum() - (a != 0).sum())


def test_element_lists_build_in_slices(monkeypatch):
    """The lists come out the same whatever the slice the build tests at
    once (one block a slice here), so a build never needs a mask of the
    whole pool."""
    a_h = _handle(2, "float32", seed=7)
    pool = _pool(a_h, "padded")
    lists = a_h.pool_lists(False)
    nbr = a_h.tile_shape[0] // BS
    whole = element_lists(pool, lists, nbr)
    monkeypatch.setattr(bsr_spmm, "BUILD_SLICE", BS * BS)
    sliced = element_lists(pool, lists, nbr)
    for name in ("rowptr", "brow", "aoff"):
        assert torch.equal(getattr(whole, name), getattr(sliced, name))
