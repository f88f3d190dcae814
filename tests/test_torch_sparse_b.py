"""B1's sparse-B path on the CPU: its plain version against the densified
product (the reference's ``densify_raw`` + ``bsr_spmm_raw_ref``), the
table a plan builds for it replayed in plain PyTorch as the CUDA kernel
runs it (units of row windows, the zero rows, the carry, the two NaN
passes), and the schedules that hand it B as it lies.  The kernel itself
runs only on a card (``test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core import bsr as tbsr
from repro_torch.core.api import (NATURAL, DistBSR, DistDense, matmul,
                                  plan_matmul)
from repro_torch.kernels import bsr_spmm, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bsr_spmm import (ELEMENT_FILL, SB_WINDOW,
                                          sparse_b_windows)

CPU = torch.device("cpu")
TOL = 1e-5
BF16_STEP = 2.0 ** -7
NAN = float("nan")


def _tiles(h: DistBSR):
    """A handle's natural blocks, rows and cols as ``[g*g, ...]`` pools."""
    tree = h.placed(NATURAL)
    return [tree[k].reshape(-1, *tree[k].shape[2:])
            for k in ("blocks", "rows", "cols")]


def _densified(a, b, nbr: int, nbc: int, out_dtype=None):
    """The reference: A's listed blocks times the densified B, and the
    scale |A| @ |B| in float32."""
    dense = ref.densify_raw(*b, nbr_b(b), nbc)
    want = ref.bsr_spmm_raw_ref(*a, dense, nbr, out_dtype=out_dtype)
    scale = ref.bsr_spmm_raw_ref(a[0].abs().nan_to_num(0, 0, 0), a[1], a[2],
                                 dense.abs().nan_to_num(0, 0, 0), nbr,
                                 out_dtype=torch.float32)
    return want, scale


def nbr_b(b) -> int:
    """Block-rows of a B pool's tiles: one past its largest listed row."""
    return int(b[1].max()) + 1


def assert_close(got, want, scale, step: float = 0.0) -> None:
    """|got - want| <= 1e-5 |A|@|B| + step |want| where ``want`` is finite,
    and the NaN and inf positions equal (infs of the same sign)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    keep = torch.isfinite(want)
    err = (got[keep] - want[keep]).abs()
    allowed = TOL * scale[keep] + step * want[keep].abs()
    assert bool((err <= allowed).all()), float(
        (err / allowed.clamp_min(1e-30)).max())


def _pair(bs: int, n_a: int, seed: int, density: float = 0.02,
          hub: bool = False, wide: int = 1):
    """Two tiles of A (``n_a`` x K, K = 10 bs) and their B tiles (K x
    ``wide`` * 5 bs), as raw block lists (a TiledBSR's stored layout, padding and coverage
    included), with empty block-rows in A and B; ``hub``: a row of A
    longer than the kernel's split."""
    rng = np.random.default_rng(seed)
    k = 10 * bs
    a = tbsr.random_sparse(2 * n_a, k, density, seed=seed)
    a[bs:2 * bs] = 0                                  # an empty block-row
    a[3, 1] = 0
    if hub:
        cols = rng.choice(k, size=bsr_spmm.SPLIT_ROW + 8, replace=False)
        a[2, cols] = rng.standard_normal(cols.size)
    b = tbsr.random_sparse(2 * k, wide * 40 * bs // 8, density * 2,
                           seed=seed + 1)
    b[2 * bs:3 * bs] = 0
    if wide > 1:                      # a row whose nonzeros span windows
        b[5, ::7] = rng.standard_normal(b[5, ::7].shape)
        a[:, 5] += rng.standard_normal(a.shape[0]) * (
            rng.random(a.shape[0]) < 0.3)
    ta = tbsr.TiledBSR.from_dense(a, tbsr.ProcessGrid(2, 1), bs, device=CPU)
    tb = tbsr.TiledBSR.from_dense(b, tbsr.ProcessGrid(2, 1), bs, device=CPU)
    pool = lambda t: [x.reshape(2, *x.shape[2:]) for x in (t.blocks, t.rows,
                                                           t.cols)]
    return pool(ta), pool(tb), ta.tile_shape[0] // bs, \
        tb.tile_shape[1] // bs


CASES = {
    "bs8": dict(bs=8), "bs16": dict(bs=16), "bs32": dict(bs=32),
    "hub": dict(bs=8, hub=True), "wide": dict(bs=16, wide=40),
    "out": dict(bs=16, out=True), "bf16": dict(bs=16, dtype="bfloat16"),
    "bf16_out": dict(bs=16, dtype="bfloat16", out=True),
    "inf_a": dict(bs=8, poke="a", value=float("inf")),
    "nan_a": dict(bs=8, poke="a", value=NAN),
    "inf_b": dict(bs=8, poke="b", value=float("-inf")),
    "nan_b": dict(bs=8, poke="b", value=NAN),
    "zero_slot_inf_b": dict(bs=16, poke="zero_slot", value=float("inf")),
}


def _poke(a, b, where: str, value: float) -> None:
    """Put ``value`` into a stored nonzero of A or B, or (``zero_slot``)
    into B's row k where a nonzero A[r, k] of tile 0 lies, so that the
    zero slots beside it in its block's column meet it."""
    if where == "a":
        s, r, c = torch.nonzero(a[0][1])[0].tolist()
        a[0][1, s, r, c] = value
        return
    if where == "b":
        s, r, c = torch.nonzero(b[0][0])[0].tolist()
        b[0][0, s, r, c] = value
        return
    bs, bs_b = a[0].shape[-1], b[0].shape[-1]
    for s, r, c in torch.nonzero(a[0][0]).tolist():
        k = int(a[2][0, s]) * bs + c
        for sb in torch.nonzero(b[1][0] == k // bs_b).flatten().tolist():
            row = b[0][0, sb, k % bs_b]
            if bool(row.ne(0).any()) and bool(a[0][0, s, :, c].eq(0).any()):
                row[int(torch.nonzero(row)[0])] = value
                return
    raise AssertionError("no zero slot to poke")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_the_densified_product(case):
    """The sparse-B plain version (A's nonzeros times B's) equals A's
    listed blocks times the densified B within float32 rounding, with the
    reference's NaN and inf positions exactly: a non-finite A value meets
    B's zeros, a non-finite B value A's zero slots and zero blocks.  Into
    ``out``, rows no block visits stay bit-identical."""
    c = CASES[case]
    bs = c["bs"]
    a, b, nbr, nbc = _pair(bs, 6 * bs + bs // 2, seed=len(case),
                           hub=c.get("hub", False), wide=c.get("wide", 1))
    dtype = getattr(torch, c.get("dtype", "float32"))
    a[0], b[0] = a[0].to(dtype), b[0].to(dtype)
    if "poke" in c:
        _poke(a, b, c["poke"], c["value"])
    if c.get("hub"):
        per_row = ref.densify_raw(*a, nbr, nbr_b(b)).ne(0).sum(-1)
        assert int(per_row.max()) > bsr_spmm.SPLIT_ROW
    if c.get("wide"):
        assert nbc * bs > 2 * SB_WINDOW
    want, scale = _densified(a, b, nbr, nbc)
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    got = ref.bsr_spmm_sparse_b_raw_ref(*a, *b, nbr, nbc)
    assert_close(got, want, scale, step)
    if "poke" in c:
        assert bool(torch.isnan(want).any())
    if c.get("out"):
        carry = torch.randn(want.shape).to(dtype)
        out = carry.clone()
        res = tops.bsr_spmm_sparse_b_raw(*a, *b, n_block_rows=nbr,
                                         n_block_cols=nbc, out=out)
        assert res is out
        assert_close(out, (carry.float() + want.float()).to(dtype),
                     2 * scale, 2 * step)
        empty = ~ref.densify_raw(*a, nbr, nbr_b(b)).ne(0).any(-1)
        assert bool(empty.any())
        assert torch.equal(out[empty], carry[empty])


# ---------------------------------------------------------------------------
# the plan's sparse-B table, replayed as the kernel runs it
# ---------------------------------------------------------------------------
def _replay(a_pool, b_pool, table, out=None):
    """B1's sparse-B path step by step in plain PyTorch, as the kernel runs
    it: each unit's windows sum, per row, A's entries in list order times
    their B row's entries inside the window (found through the window
    offsets) in float32; a fresh C takes each window whole and the zero
    rows, a carry C + the sum rounded to C's type where the sum is
    nonzero; then the NaN passes from the two lists' values.  Returns C."""
    sb = table.sparse_b
    al, bl = sb.a_lists, sb.b_lists
    bs = al.pool_shape[2]
    t, r_tile, n = table.tiles, table.n_block_rows * bs, sb.n
    k_tile = bl.n_block_rows * bl.pool_shape[2]
    nwin = -(-n // SB_WINDOW)
    dtype = torch.promote_types(a_pool.dtype, b_pool.dtype)
    aval = a_pool.reshape(-1)[al.aoff].float()
    bval = b_pool.reshape(-1)[bl.aoff].float()
    fresh = out is None
    c = torch.full((t, r_tile, n), NAN, dtype=dtype) if fresh \
        else out.clone()
    written = torch.zeros((t, r_tile, nwin), dtype=torch.int64)
    a_rp, b_rp = al.rowptr.tolist(), bl.rowptr.tolist()
    a_brow, b_col = al.brow.tolist(), bl.brow.long()
    maps, win = sb.maps.tolist(), sb.windows.tolist()
    for tile, row, w0, w1, _ in sb.units.T.tolist():
        q, bt = maps[0][tile], maps[1][tile]
        lo, hi = a_rp[q * r_tile + row], a_rp[q * r_tile + row + 1]
        assert hi > lo
        for w in range(w0, w1):
            c0 = w * SB_WINDOW
            width = min(SB_WINDOW, n - c0)
            acc = torch.zeros(SB_WINDOW)
            for e in range(lo, hi):
                br = bt * k_tile + a_brow[e]
                s0 = b_rp[br] + win[br][w]
                s1 = b_rp[br] + win[br][w + 1]
                j = b_col[s0:s1] - c0
                assert bool(((j >= 0) & (j < width)).all())
                acc[j] += aval[e] * bval[s0:s1]
            acc = acc[:width]
            dst = c[tile, row, c0:c0 + width]
            if fresh:
                dst.copy_(acc.to(dtype))
            else:
                reach = acc.view(torch.int32) != 0
                dst[reach] = (dst[reach].float()
                              + acc[reach].to(dtype).float()).to(dtype)
            written[tile, row, w] += 1
    if fresh:
        flat = c.view(t * r_tile, n)
        flat[sb.zero_rows.long()] = 0
        written.view(t * r_tile, nwin)[sb.zero_rows.long()] += 1
        assert bool((written == 1).all()), "a window is left unwritten"
    assert int(written.max()) <= 1, "a window is written twice"
    pool = a_pool.reshape(-1, bs, bs)
    colptr, col_ent = sb.colptr.tolist(), sb.col_ent.tolist()
    for f in torch.nonzero(~torch.isfinite(bval)).flatten().tolist():
        row = int(np.searchsorted(b_rp, f, side="right")) - 1
        bt, k, j = row // k_tile, row % k_tile, int(b_col[f])
        for tile in range(t):
            if maps[1][tile] != bt or k // bs >= sb.span:
                continue
            key = tile * sb.span + k // bs
            for x in range(colptr[key], colptr[key + 1]):
                br, slot = col_ent[0][x], col_ent[1][x]
                for rr in range(bs):
                    if slot < 0 or pool[slot, rr, k % bs] == 0:
                        c[tile, br * bs + rr, j] = NAN
    for e in torch.nonzero(~torch.isfinite(aval)).flatten().tolist():
        row = int(np.searchsorted(a_rp, e, side="right")) - 1
        q, r, k = row // r_tile, row % r_tile, a_brow[e]
        for tile in range(t):
            if maps[0][tile] != q:
                continue
            br = maps[1][tile] * k_tile + k
            held = torch.zeros(n, dtype=torch.bool)
            held[b_col[b_rp[br]:b_rp[br + 1]]] = True
            c[tile, r, ~held] = NAN
    return c


def _low_fill(m: int, seed: int, bs: int, hub: bool = True) -> np.ndarray:
    """A square matrix whose real blocks are nearly empty (fill under
    ELEMENT_FILL at bs 16 and 32), with a hub row and column of more than
    SB_SPLIT products, an empty block-row and block-column."""
    a = tbsr.random_sparse(m, m, 0.0012, seed=seed)
    rng = np.random.default_rng(seed)
    if hub:
        idx = rng.choice(m, size=m // 6, replace=False)
        a[7, idx] = rng.standard_normal(idx.size)
        a[idx, 7] = rng.standard_normal(idx.size)
    a[bs:2 * bs] = 0
    a[:, 3 * bs:4 * bs] = 0
    return a


def _steps(plan, g):
    """Each of the g ring steps' launch maps over the natural stacks."""
    for step, ((a_map, b_map),) in enumerate(plan.launch_maps()):
        yield step, a_map, b_map


@pytest.mark.parametrize("g,bs,poke", [(1, 16, None), (2, 16, None),
                                       (3, 32, None), (2, 16, "a_inf"),
                                       (2, 16, "b_nan"), (2, 32, "b_inf"),
                                       (2, 16, "bf16")])
def test_table_replays_the_ring_steps(monkeypatch, g, bs, poke):
    """``ring_c``'s sparse-B tables of A @ B, replayed step by step as the
    kernel runs them (a fresh C at step 0, the carry at the next), give
    the plain version's C (NaN and inf positions exactly: an inf in A, a
    NaN or an inf in B); the units cover every window of every row that
    holds a nonzero of A once, the zero rows every other row, and credit
    each real block once; heavy rows spread over several units."""
    monkeypatch.setattr(bsr_spmm, "SB_WARPS", 1)
    monkeypatch.setattr(bsr_spmm, "SB_SPLIT", 200)
    m = 2 * SB_WINDOW + 3 * bs
    dtype = torch.bfloat16 if poke == "bf16" else torch.float32
    a_h, b_h = (DistBSR.from_dense(_low_fill(m, seed=g + bs + x, bs=bs),
                                   g=g, block_size=bs, dtype=dtype,
                                   device=CPU) for x in (0, 100))
    assert max(a_h.tiled.fill(), b_h.tiled.fill()) < ELEMENT_FILL
    if poke in ("a_inf", "b_nan", "b_inf"):
        blocks = (a_h if poke == "a_inf" else b_h).tiled.blocks
        where = torch.nonzero(blocks)[7].tolist()
        blocks[tuple(where)] = NAN if poke == "b_nan" else float("inf")
    plan = plan_matmul(a_h, b_h, algorithm="ring_c")
    nbr = a_h.tile_shape[0] // bs
    a_pool, b_pool = _tiles(a_h), _tiles(b_h)
    c = want = None
    heavy = 0
    for step, a_map, b_map in _steps(plan, g):
        table = plan.sparse_b_table(a_h, b_h, a_map, b_map)
        assert table.path == "sparse_b"
        sb = table.sparse_b
        units = sb.units.numpy()
        assert int(units[4].sum()) + sb.extra_credit == table.real_blocks
        heavy += int((units[3] - units[2] < -(-sb.n // SB_WINDOW)).sum())
        assert set(units[3] - units[2]) <= {1, -(-sb.n // SB_WINDOW)}
        c = _replay(a_pool[0], b_pool[0], table, out=c)
        ai, bi = torch.as_tensor(a_map), torch.as_tensor(b_map)
        part = ref.bsr_spmm_sparse_b_raw_ref(
            *(x[ai] for x in a_pool), *(x[bi] for x in b_pool), nbr, nbr)
        want = part if want is None else \
            (want.float() + part.float()).to(want.dtype)
    assert heavy > 0 or sb.n <= SB_WINDOW
    # the plain version at the same steps, and the densified product
    dense_pool = ref.densify_raw(*b_pool, nbr, nbr)
    scale = 0
    for _, a_map, b_map in _steps(plan, g):
        ai, bi = torch.as_tensor(a_map), torch.as_tensor(b_map)
        scale = scale + ref.bsr_spmm_raw_ref(
            a_pool[0][ai].abs().nan_to_num(0, 0, 0), a_pool[1][ai],
            a_pool[2][ai], dense_pool[bi].abs().nan_to_num(0, 0, 0), nbr,
            out_dtype=torch.float32)
    step_tol = 2 * g * BF16_STEP if dtype == torch.bfloat16 else 0.0
    assert_close(c, want, g * scale, step_tol)
    if poke is not None and poke != "bf16":
        assert bool(torch.isnan(want).any())


def test_windows_are_each_rows_offsets():
    """The window offsets of B's lists: each row's entries of window w
    start ``windows[row, w]`` after the row's first, the last column its
    length; the rows' columns are sorted."""
    a_h = DistBSR.from_dense(_low_fill(3 * SB_WINDOW, 3, 16), g=2,
                             block_size=16, device=CPU)
    lists = a_h.element_lists(False)
    assert lists.cols_sorted
    n = a_h.tile_shape[1]
    win = sparse_b_windows(lists, n).numpy()
    rp, col = lists.rowptr.numpy(), lists.brow.numpy()
    assert win.shape == (rp.size - 1, -(-n // SB_WINDOW) + 1)
    for row in range(rp.size - 1):
        cols = col[rp[row]:rp[row + 1]]
        assert (np.diff(cols) > 0).all()
        want = np.searchsorted(cols, np.arange(win.shape[1]) * SB_WINDOW)
        want[-1] = cols.size
        np.testing.assert_array_equal(win[row], want)
    with pytest.raises(ValueError, match="past"):
        sparse_b_windows(lists, int(col.max()))


def _kernel_fakes(monkeypatch):
    """Make plans believe the kernel runs on the CPU and count the calls:
    the sparse-B route replays its table, the dense-B route runs the plain
    version."""
    calls = {"sparse_b": 0, "dense": 0, "densify": 0}
    monkeypatch.setattr(api, "_runs_kernel", lambda impl, dev: True)
    real_raw, real_densify = tops.bsr_spmm_raw, tops.densify

    def sparse_b(a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols, *,
                 table, out=None, **kw):
        calls["sparse_b"] += 1
        return _replay(a_blocks, b_blocks, table, out=out)

    def dense(*args, table=None, **kw):
        calls["dense"] += 1
        return real_raw(*args, **kw)

    def densify(*args, **kw):
        calls["densify"] += 1
        return real_densify(*args, **kw)

    monkeypatch.setattr(tops, "bsr_spmm_sparse_b_raw", sparse_b)
    monkeypatch.setattr(tops, "bsr_spmm_raw", dense)
    monkeypatch.setattr(tops, "densify", densify)
    return calls


@pytest.mark.parametrize("algorithm,g", [
    ("ring_c", 1), ("ring_c", 2), ("ring_c", 3), ("summa_bcast", 2),
    ("summa_ag", 3), ("ring_a", 2), ("ring_c_bidir", 2)])
def test_stationary_c_schedules_hand_b1_the_sparse_b(monkeypatch, algorithm,
                                                      g):
    """Where the kernel runs, ``ring_c``, ``summa_bcast`` and ``summa_ag``
    multiply a low-fill B as it lies, one sparse-B launch a step and no
    densify; ``ring_a`` and ``ring_c_bidir`` densify it as before.  Every
    result equals the CPU's."""
    bs = 16
    a = _low_fill(SB_WINDOW + 5 * bs, seed=g, bs=bs)
    want = matmul(DistBSR.from_dense(a, g=g, block_size=bs, device=CPU),
                  DistBSR.from_dense(a, g=g, block_size=bs, device=CPU),
                  algorithm=algorithm, output="dense")
    api.clear_plan_cache()
    calls = _kernel_fakes(monkeypatch)
    a_h = DistBSR.from_dense(a, g=g, block_size=bs, device=CPU)
    got = matmul(a_h, a_h, algorithm=algorithm, output="dense")
    api.clear_plan_cache()
    stationary = algorithm in ("ring_c", "summa_bcast", "summa_ag")
    if stationary:
        assert calls == {"sparse_b": g, "dense": 0, "densify": 0}
    else:
        assert calls["sparse_b"] == 0 and calls["densify"] == 1
    scale = torch.from_numpy(np.abs(a) @ np.abs(a)).float()
    assert_close(got, want, scale)


@pytest.mark.parametrize("case", ["dense_b", "full_b", "packed", "unsorted"])
def test_other_operands_keep_todays_paths(monkeypatch, case):
    """A dense B, a B at fill >= ELEMENT_FILL, the packed wire and a B
    whose lists are not sorted by column keep the densify (or the dense
    B) and B1's other paths."""
    bs = 16
    a = _low_fill(SB_WINDOW + 5 * bs, seed=5, bs=bs)
    calls = _kernel_fakes(monkeypatch)
    a_h = DistBSR.from_dense(a, g=2, block_size=bs, device=CPU)
    kw = dict(algorithm="ring_c")
    if case == "dense_b":
        b = DistDense.for_rhs(np.random.default_rng(0).standard_normal(
            (a.shape[1], 24)).astype(np.float32), a_h)
    elif case == "full_b":
        b = DistBSR.from_dense(np.kron(np.eye(a.shape[0] // bs),
                                       np.ones((bs, bs))), g=2,
                               block_size=bs, device=CPU)
        assert b.tiled.fill() >= ELEMENT_FILL
    else:
        b = DistBSR.from_dense(a, g=2, block_size=bs, device=CPU)
        kw["wire"] = "packed" if case == "packed" else "padded"
    if case == "unsorted":
        lists = b.element_lists(False)
        b._element_lists[False] = dataclasses.replace(lists,
                                                      cols_sorted=False)
    plan = plan_matmul(a_h, b, **kw)
    if case != "dense_b":
        assert plan.takes_sparse_b(a_h, b) is False
    matmul(a_h, b, **kw)
    api.clear_plan_cache()
    assert calls["sparse_b"] == 0 and calls["dense"] == 2
