"""The port's kernel ops against the JAX package's.

On the CPU the port's ``ops`` run the plain PyTorch versions
(``kernels/ref.py``); they are held against the JAX package's Pallas
kernels in interpret mode and against its jnp references, on the grid of
shapes of ``tests/test_kernels.py``, at the reference's tolerances (float32
1e-5, bf16 2e-2).  The kernels themselves run only on a card: their tests
are in ``test_torch_cuda.py``, which imports no JAX.  Here the kernels'
work splits (B1's table of real blocks, the pair table) are replayed step
by step in plain PyTorch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bsr as jbsr
from repro.core import symbolic as jsym  # analysis: allow(source.import.repro.core.symbolic)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bsr as tbsr
from repro_torch.core import symbolic as tsym
from repro_torch.core.grid import ProcessGrid
from repro_torch.kernels import bsr_pair
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bsr_pair import (bsr_pair_accumulate_cuda,
                                          bsr_pair_matmul_cuda, pair_table)
from repro_torch.kernels.bsr_spmm import CHUNK, bsr_spmm_cuda, spmm_table

CPU = torch.device("cpu")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# the shape grid of tests/test_kernels.py
SHAPES = [
    (16, 16, 8, 8, 0.3),
    (32, 16, 16, 8, 0.15),
    (16, 32, 32, 16, 0.4),
    (24, 24, 8, 8, 0.0),       # empty matrix
    (16, 16, 8, 8, 1.0),       # dense
]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("m,k,n,bs,density", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_spmm_matches_jax_interpret_and_ref(m, k, n, bs, density, dtype):
    a_d = tbsr.random_sparse(m, k, density, seed=m + k + n)
    b = np.random.default_rng(0).standard_normal((k, n)).astype(np.float32)
    a_t = tbsr.BSR.from_dense(a_d, bs, dtype=getattr(torch, dtype),
                              device=CPU)
    a_j = jbsr.BSR.from_dense(a_d, bs, dtype=getattr(jnp, dtype))
    b_t = torch.from_numpy(b).to(getattr(torch, dtype))
    b_j = jnp.asarray(b, dtype=getattr(jnp, dtype))
    got = tops.bsr_spmm(a_t, b_t)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (a_t.shape[0], n)
    tol = TOL[dtype]
    for impl in ("interpret", "ref"):
        want = jops.bsr_spmm(a_j, b_j, impl=impl, block_n=8)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                                   err_msg=impl)
    # and the oracle through explicit densification
    np.testing.assert_allclose(_f32(tref.bsr_spmm_ref(a_t, b_t)), _f32(got),
                               rtol=tol, atol=tol)


def test_bsr_spmm_extra_capacity_padding():
    a_d = tbsr.random_sparse(16, 16, 0.25, seed=2)
    b = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    a = tbsr.BSR.from_dense(a_d, 8, device=CPU).with_capacity(9)
    got = tops.bsr_spmm(a, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), a_d @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("augment", [True, False])
def test_bsr_spmm_raw_augment_on_stored_tiles(augment):
    """TiledBSR tiles are stored coverage-augmented, so both settings give
    the JAX package's result on them."""
    a_d = tbsr.random_sparse(24, 16, 0.3, seed=11)
    b = np.random.default_rng(2).standard_normal((16, 6)).astype(np.float32)
    t = tbsr.TiledBSR.from_dense(a_d, ProcessGrid(1, 1), 4, capacity="bucket",
                                 device=CPU)
    jt = jbsr.TiledBSR.from_dense(a_d, jbsr.ProcessGrid(1, 1), 4,
                                  capacity="bucket")
    nbr = t.tile_shape[0] // 4
    got = tops.bsr_spmm_raw(t.blocks[0, 0], t.rows[0, 0], t.cols[0, 0],
                            torch.from_numpy(b), n_block_rows=nbr,
                            augment=augment)
    want = jops.bsr_spmm_raw(jt.blocks[0, 0], jt.rows[0, 0], jt.cols[0, 0],
                             jnp.asarray(b), n_block_rows=nbr,
                             impl="interpret", block_n=2, augment=augment)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), a_d @ b, rtol=1e-5, atol=1e-5)


def test_n_zero_fast_path():
    a = tbsr.BSR.from_dense(tbsr.random_sparse(8, 8, 0.5, seed=1), 4,
                            dtype=torch.bfloat16, device=CPU)
    for impl in (None, "auto", "ref"):
        got = tops.bsr_spmm(a, torch.zeros((8, 0)), impl=impl)
        assert tuple(got.shape) == (8, 0) and got.dtype == torch.float32
    want = jops.bsr_spmm(jbsr.BSR.from_dense(
        tbsr.random_sparse(8, 8, 0.5, seed=1), 4), jnp.zeros((8, 0)),
        impl="interpret")
    assert tuple(want.shape) == (8, 0)


def test_batched_ref_equals_per_tile_and_chunking(monkeypatch):
    rng = np.random.default_rng(4)
    t, s, bs, nbr, nbc, n = 3, 7, 4, 3, 2, 5
    blocks = torch.from_numpy(rng.standard_normal((t, s, bs, bs)).astype(
        np.float32))
    rows = torch.from_numpy(np.sort(rng.integers(0, nbr, (t, s)), axis=1)
                            .astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, nbc, (t, s)).astype(np.int32))
    dense = torch.from_numpy(rng.standard_normal((t, nbc * bs, n)).astype(
        np.float32))
    whole = tref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr)
    for i in range(t):
        want = jref.bsr_spmm_raw_ref(
            jnp.asarray(blocks[i].numpy()), jnp.asarray(rows[i].numpy()),
            jnp.asarray(cols[i].numpy()), jnp.asarray(dense[i].numpy()), nbr)
        np.testing.assert_allclose(whole[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            tref.bsr_spmm_raw_ref(blocks[i], rows[i], cols[i], dense[i],
                                  nbr).numpy(), whole[i].numpy())
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 1)   # one stored block a chunk
    np.testing.assert_allclose(
        tref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr).numpy(),
        whole.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_matches(dtype):
    a_d = tbsr.random_sparse(12, 16, 0.3, seed=6)
    jt = jbsr.BSR.from_dense(a_d, 4, dtype=getattr(jnp, dtype))
    tt = tbsr.BSR.from_dense(a_d, 4, dtype=getattr(torch, dtype), device=CPU)
    got = tops.densify(tt.blocks, tt.rows, tt.cols, n_block_rows=3,
                       n_block_cols=4)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        _f32(got), _f32(jref.densify_raw(jt.blocks, jt.rows, jt.cols, 3, 4)))


def _replay_spmm_kernel(blocks, dense, table, out=None):
    """B1's work split, step by step in plain PyTorch, as the kernel runs
    it: each chunk sums its entries' products (A pool slot, block column,
    the chunk's B tile) in float32 and stores C (fresh, or C + the sum
    rounded to C's type) or its partial; a segment cut into several chunks
    sums its partials in chunk order; a fresh output zero-fills the
    block-rows no real block visits; then the NaN pass writes NaN into
    each left-out entry's block-row at the columns where its B chunk holds
    an inf or a NaN.  Returns (C, how often each pool block was
    multiplied)."""
    p, s, bs, _ = blocks.shape
    pool = blocks.reshape(p * s, bs, bs)
    n = dense.shape[-1]
    t, nbr = table.tiles, table.n_block_rows
    dtype = torch.promote_types(blocks.dtype, dense.dtype)
    fresh = out is None
    c = torch.full((t, nbr, bs, n), float("nan"), dtype=dtype) if fresh \
        else out.clone().reshape(t, nbr, bs, n)
    written = torch.zeros((t, nbr), dtype=torch.int64)
    multiplied = torch.zeros(p * s, dtype=torch.int64)
    partial = {}

    def store(tile, row, acc):
        c[tile, row] = acc.to(dtype) if fresh else \
            (c[tile, row].float() + acc.to(dtype).float()).to(dtype)
        written[tile, row] += 1

    slots, cols = table.ent.long()
    for tile, first, end, row, part, b_tile in table.chunks.T.tolist():
        assert 0 < end - first <= CHUNK
        acc = torch.zeros((bs, n))
        for e in range(first, end):
            col = int(cols[e])
            acc += pool[slots[e]].float() @ \
                dense[b_tile, col * bs:(col + 1) * bs].float()
            multiplied[slots[e]] += 1
        if part < 0:
            store(tile, row, acc)
        else:
            partial[part] = acc
    for tile, row, first, parts in table.reduce.T.tolist():
        acc = torch.zeros((bs, n))
        for part in range(first, first + parts):
            acc += partial.pop(part)
        store(tile, row, acc)
    assert not partial, "a partial is never summed"
    if fresh:
        for tile, row in table.fill.T.tolist():
            c[tile, row] = 0
            written[tile, row] += 1
        assert bool((written == 1).all()), "a block-row is left unwritten"
    assert int(written.max()) <= 1, "a block-row is written twice"
    flags = torch.stack([~torch.isfinite(
        dense[b_tile, col * bs:(col + 1) * bs].float()).all(dim=0)
        for b_tile, col in table.skip_chunks.T.tolist()]) \
        if table.skip_chunks.shape[1] else None
    for tile, row, u in table.skip.T.tolist():
        c[tile, row][:, flags[u]] = float("nan")
    return c.reshape(t, nbr * bs, n), multiplied


@pytest.mark.parametrize("chunk", [1, 2, 3, CHUNK])
def test_kernel_work_split_covers_every_block_once(chunk):
    """B1's table replayed step by step, on lists with empty block-rows and
    a long padding run: every listed block (all of them, without a mask)
    multiplied once and each block-row written once, with the plain
    version's sums; with the storage layout's real mask only the blocks
    that hold data, with the same sums; and into a carry, C + the sums."""
    a_d = tbsr.random_sparse(36, 24, 0.35, seed=8)
    a_d[8:16] = 0                                   # empty block-rows
    t = tbsr.TiledBSR.from_dense(a_d, ProcessGrid(1, 2), 4, capacity=40,
                                 device=CPU)       # long padding segment
    s, nbr = t.store_capacity, t.tile_shape[0] // 4
    dense = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 12, 5)).astype(np.float32))
    blocks, rows, cols = (t.blocks.reshape(2, s, 4, 4), t.rows.reshape(2, s),
                          t.cols.reshape(2, s))
    want = tref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr)
    slots = torch.arange(2)[:, None] * s + torch.arange(s)
    table = spmm_table(slots, rows, cols, nbr, chunk=chunk)
    assert table.real_blocks == 2 * s and table.fill.shape[1] == 0
    seg = np.stack([np.bincount(r, minlength=nbr) for r in rows.numpy()])
    assert seg.max() > 20                    # the padding run's segment
    n_chunks = -(-seg // chunk)
    assert table.chunks.shape[1] == int(n_chunks.sum())
    assert table.n_parts == int(n_chunks[n_chunks > 1].sum())
    assert table.reduce.shape[1] == int((n_chunks > 1).sum())
    got, multiplied = _replay_spmm_kernel(blocks, dense, table)
    assert bool((multiplied == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    real = t.real_slots().reshape(2, s)
    table = spmm_table(slots, rows, cols, nbr, real=real, chunk=chunk)
    assert table.real_blocks == int(t.counts.sum())
    got, multiplied = _replay_spmm_kernel(blocks, dense, table)
    np.testing.assert_array_equal(multiplied.reshape(2, s).numpy(),
                                  real.astype(int))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    empty = {(ti, r) for ti in range(2) for r in range(nbr)
             if not real[ti][rows[ti].numpy() == r].any()}
    assert {(0, 2), (0, 3), (1, 2), (1, 3)} <= empty
    assert set(map(tuple, table.fill.T.tolist())) == empty
    carry = torch.from_numpy(np.random.default_rng(3).standard_normal(
        want.shape).astype(np.float32))
    got, _ = _replay_spmm_kernel(blocks, dense, table, out=carry)
    np.testing.assert_allclose(got.numpy(), (carry + want).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_plan_spmm_tables_list_the_blocks_that_hold_data(g, wire):
    """The table a dense-output plan cuts for each ring step lists exactly
    the blocks that hold data of the pool tile each position reads (the
    placed stack, or the packed buffers), zero-fills exactly the block-rows
    none of them visits, is built once, and replays to the step's product
    A[i, k] @ B[k, j], k = (i + j + step) % g."""
    from repro_torch.core.api import (SKEW_COLS, SKEW_ROWS, DistBSR,
                                      DistDense, plan_matmul)
    a_d = tbsr.random_sparse(12 * 4, 12 * 4, 0.04, seed=g)
    a_d[:4] += tbsr.random_sparse(4, 12 * 4, 0.5, seed=g + 1)
    a_d[20:28] = 0
    b = np.random.default_rng(g).standard_normal((48, 6)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    b_h = DistDense.for_rhs(b, a_h)
    plan = plan_matmul(a_h, b_h, wire=wire)
    assert plan.wire == wire
    ex = plan.executor
    pool = ex.batch((a_h.packed_wire if wire == "packed" else a_h.placed)(
        SKEW_ROWS)["blocks"])
    b_pool = ex.batch(b_h.placed(SKEW_COLS)["dense"])
    s = pool.shape[1]
    nz = (pool != 0).flatten(2).any(dim=2).reshape(-1).numpy()
    nat_a, nat_b = a_h.tiled.to_dense().numpy(), b_h.data.numpy()
    tm, tn = a_h.tile_shape[0], b_h.tile_shape[1]
    nbr = tm // 4
    a_map = b_map = ex.identity_map()
    for step in range(g):
        if step:
            a_map = ex.shift_map(a_map, "col")
            b_map = ex.shift_map(b_map, "row")
        table = plan.spmm_table(a_h, a_map, b_map)
        assert plan.spmm_table(a_h, a_map, b_map) is table
        want = [q * s + x for q in a_map for x in range(s) if nz[q * s + x]]
        assert sorted(table.ent[0].tolist()) == sorted(want)
        got, multiplied = _replay_spmm_kernel(pool, b_pool, table)
        assert int(multiplied.max()) == 1
        empty = set()
        for p in range(g * g):
            i, j = divmod(p, g)
            k = (i + j + step) % g
            a_tile = nat_a[i * tm:(i + 1) * tm, k * tm:(k + 1) * tm]
            np.testing.assert_allclose(
                got[p].numpy(), a_tile @ nat_b[k * tm:(k + 1) * tm,
                                               j * tn:(j + 1) * tn],
                rtol=1e-5, atol=1e-5)
            empty |= {(p, r) for r in range(nbr)
                      if not a_tile[r * 4:(r + 1) * 4].any()}
        assert empty
        assert set(map(tuple, table.fill.T.tolist())) == empty
    assert plan.workspace_bytes() == 0


def _nonfinite(dense: torch.Tensor) -> torch.Tensor:
    """``dense`` ``[T, K, n]`` with an inf, a NaN and a -inf planted."""
    dense = dense.clone()
    dense[0, 1, 3] = float("inf")
    dense[0, 6, 0] = float("nan")
    dense[-1, 9, 2] = float("-inf")
    return dense


def _same_nan_mask(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.any() and not nan.all()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonfinite_b_gives_the_jax_nan_mask(dtype):
    """Where B holds an inf or a NaN, the plain B1 gives the JAX package's
    ``bsr_spmm_raw``: NaN in every block-row whose listed blocks (real,
    capacity padding or coverage zeros) meet a non-finite B chunk, at
    those columns, and equal finite values elsewhere.  The kernel's work
    split over the real blocks alone, replayed with its NaN pass from the
    left-out entries, gives the same mask, fresh and into a carry."""
    a_d = tbsr.random_sparse(36, 24, 0.35, seed=8)
    a_d[8:16] = 0                                   # empty block-rows
    t = tbsr.TiledBSR.from_dense(a_d, ProcessGrid(1, 2), 4, capacity=40,
                                 dtype=getattr(torch, dtype), device=CPU)
    s, nbr = t.store_capacity, t.tile_shape[0] // 4
    dense = _nonfinite(torch.from_numpy(np.random.default_rng(9)
                                        .standard_normal((2, 12, 5))
                                        .astype(np.float32))).to(
        getattr(torch, dtype))
    blocks, rows, cols = (t.blocks.reshape(2, s, 4, 4), t.rows.reshape(2, s),
                          t.cols.reshape(2, s))
    got = _f32(tops.bsr_spmm_raw(blocks, rows, cols, dense,
                                 n_block_rows=nbr))
    want = np.stack([_f32(jops.bsr_spmm_raw(
        jnp.asarray(_f32(blocks[i])).astype(getattr(jnp, dtype)),
        jnp.asarray(rows[i].numpy()), jnp.asarray(cols[i].numpy()),
        jnp.asarray(_f32(dense[i])).astype(getattr(jnp, dtype)),
        n_block_rows=nbr, impl="ref", augment=False)) for i in range(2)])
    _same_nan_mask(got, want, TOL[dtype])
    real = t.real_slots().reshape(2, s)
    assert not real.all()                   # padding and coverage skipped
    slots = torch.arange(2)[:, None] * s + torch.arange(s)
    table = spmm_table(slots, rows, cols, nbr, real=real)
    assert table.skip.shape[1] > 0
    replayed, _ = _replay_spmm_kernel(blocks, dense, table)
    _same_nan_mask(_f32(replayed), want, TOL[dtype])
    carry = torch.ones(got.shape, dtype=getattr(torch, dtype))
    replayed, _ = _replay_spmm_kernel(blocks, dense, table, out=carry)
    _same_nan_mask(_f32(replayed), want + 1, TOL[dtype])
    # a raw table (every listed block real) skips nothing
    assert spmm_table(slots, rows, cols, nbr).skip.shape[1] == 0


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire,overlap", [("padded", "off"),
                                          ("packed", "on")])
def test_steal3d_pair_lists_on_b1_and_nonfinite_b(g, wire, overlap):
    """steal3d's pair lists as B1 runs them: each launch's table over the
    real pairs (the dummy and coverage pairs on the zero block left out)
    replays to the plain ``ops.steal_pair_accumulate`` of the same lists,
    on finite B and on B with an inf and a NaN (the same NaN mask); the
    real pairs are g x A's real blocks.  At g = 1 the whole multiply's NaN
    mask is the JAX package's."""
    from repro.core import api as japi
    from repro_torch.core import api as tapi
    a_d = tbsr.random_sparse(48, 48, 0.01, seed=g)
    a_d[:8, :8] += tbsr.random_sparse(8, 8, 0.9, seed=g + 1)
    b = np.random.default_rng(g).standard_normal((48, 5)).astype(np.float32)
    a_h = tapi.DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    for bad in (False, True):
        b_t = torch.from_numpy(b)
        if bad:
            b_t = _nonfinite(b_t[None])[0]
        b_h = tapi.DistDense.for_rhs(b_t, a_h)
        plan = tapi.plan_matmul(a_h, b_h, algorithm="steal3d", wire=wire,
                                overlap=overlap)
        st = tapi._steal_device(plan.steal, a_h, plan.geom, CPU, True)
        assert st.real_pairs == g * int(a_h.counts.sum())
        pool = (a_h.packed_wire if wire == "packed" else a_h.placed)(
            tapi.NATURAL)["blocks"]
        blocks = pool.reshape(1, -1, 4, 4)
        dense = b_h.placed(tapi.NATURAL)["dense"]
        dense = dense.reshape(1, -1, dense.shape[-1])
        got = want = None
        for seg in st.segments:
            assert seg["table"].real_blocks == int(seg["real"].sum())
            got, _ = _replay_spmm_kernel(blocks, dense, seg["table"],
                                         out=got)
            want = tops.steal_pair_accumulate(
                blocks[0], dense[0], seg["pa"], seg["pb"], seg["ps"],
                n_slots=st.n_slots, out=want)
        if bad:
            _same_nan_mask(got.numpy(), want.numpy(), 1e-5)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
        if bad and g == 1:
            a_j = japi.DistBSR.from_dense(a_d, g=1, block_size=4)
            want = np.asarray(japi.matmul(
                a_j, japi.DistDense.for_rhs(jnp.asarray(b_t.numpy()), a_j),
                algorithm="steal3d", wire=wire, overlap=overlap,
                impl="ref"))
            _same_nan_mask(tapi.matmul(a_h, b_h, algorithm="steal3d",
                                       wire=wire, overlap=overlap).numpy(),
                           want, 1e-5)


def test_spmm_table_refuses_what_the_kernel_does_not_take():
    one = np.zeros((1, 2), np.int64)
    with pytest.raises(ValueError, match="chunk must be"):
        spmm_table(one, one, one, 1, chunk=CHUNK + 1)
    with pytest.raises(ValueError, match="chunk must be"):
        spmm_table(one, one, one, 1, chunk=0)
    with pytest.raises(ValueError, match=r"\[T, L\]"):
        spmm_table(one, one[:, :1], one, 1)
    with pytest.raises(ValueError, match="outside"):
        spmm_table(one, one + 1, one, 1)
    with pytest.raises(ValueError, match="real must be"):
        spmm_table(one, one, one, 1, real=np.ones((1, 3), bool))
    with pytest.raises(ValueError, match="b_map"):
        spmm_table(one, one, one, 1, b_map=[0, 1])
    with pytest.raises(ValueError, match="negative"):
        spmm_table(one - 1, one, one, 1)
    with pytest.raises(ValueError, match="n_block_rows"):
        spmm_table(one, one, one, 0)
    # an entry off the real mask may hold anything; no real entry: all fill
    none = spmm_table(one - 5, one + 7, one, 3, real=np.zeros((1, 2), bool))
    assert none.real_blocks == 0 and none.chunks.shape[1] == 0
    np.testing.assert_array_equal(none.fill.numpy().T, [[0, 0], [0, 1],
                                                        [0, 2]])
    assert none.max_slot == none.max_col == -1 and none.max_b_tile == 0
    assert CHUNK == 128


def test_impl_dispatch_refuses_the_kernel_on_cpu_tensors():
    a = tbsr.BSR.from_dense(tbsr.random_sparse(8, 8, 0.5, seed=1), 4,
                            device=CPU)
    b = torch.ones((8, 3))
    assert tops.default_impl(b) == "ref"
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.bsr_spmm(a, b, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.bsr_spmm(a, b, impl="pallas")
    table = spmm_table(a.rows[None].long() * 0 + torch.arange(
        a.capacity), a.rows[None], a.cols[None], 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsr_spmm_cuda(a.blocks[None], b[None], table)



# ---------------------------------------------------------------------------
# pair kernels: bsr_pair_matmul (B3) and bsr_pair_accumulate (B2)
# ---------------------------------------------------------------------------
# the shape grid of tests/test_kernels.py::test_pair_matmul_spgemm_matches_dense
PAIR_SHAPES = [(16, 8, 0.4, 0.4), (32, 8, 0.15, 0.3), (16, 16, 1.0, 1.0),
               (24, 8, 0.05, 0.05)]


@pytest.mark.parametrize("mk,bs,da,db", PAIR_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_matmul_matches_jax_interpret_and_ref(mk, bs, da, db, dtype):
    a_d = tbsr.random_sparse(mk, mk, da, seed=4)
    b_d = tbsr.random_sparse(mk, mk, db, seed=5)
    a_t, b_t = (tbsr.BSR.from_dense(x, bs, dtype=getattr(torch, dtype),
                                    device=CPU) for x in (a_d, b_d))
    a_j, b_j = (jbsr.BSR.from_dense(x, bs, dtype=getattr(jnp, dtype))
                for x in (a_d, b_d))
    lists = tops.build_pair_lists(a_t.rows, a_t.cols, a_t.nnzb, b_t.rows,
                                  b_t.cols, b_t.nnzb, a_t.n_block_rows,
                                  b_t.n_block_cols)
    nb = dict(n_block_rows=a_t.n_block_rows, n_block_cols=b_t.n_block_cols)
    got = tops.bsr_pair_matmul(a_t.blocks, b_t.blocks,
                               *(torch.from_numpy(x) for x in lists[:4]),
                               **nb)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (mk, mk)
    tol = TOL[dtype]
    for impl in ("interpret", "ref"):
        want = jops.bsr_pair_matmul(a_j.blocks, b_j.blocks,
                                    *(jnp.asarray(x) for x in lists[:4]),
                                    impl=impl, **nb)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                                   err_msg=impl)
    # and the dense product, for float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), a_d @ b_d, rtol=1e-4,
                                   atol=1e-4)


def _symbolic_lists(g: int, bs: int, dtype: str, seed: int = 0):
    """Stored blocks and the symbolic phase's (i, j, k) pair lists of A @ A
    on a g x g grid, as the engine's sparse-output step feeds them."""
    a_d = tbsr.random_sparse(12 * bs, 12 * bs, 0.04, seed=seed)
    a_d[:bs, :] += tbsr.random_sparse(bs, 12 * bs, 0.5, seed=seed + 1)
    t = tbsr.TiledBSR.from_dense(a_d, ProcessGrid(g, g), bs,
                                 dtype=getattr(torch, dtype), device=CPU)
    j = jbsr.TiledBSR.from_dense(a_d, jbsr.ProcessGrid(g, g), bs,
                                 dtype=getattr(jnp, dtype))
    return t, j, jsym.symbolic_spgemm(j, j)


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_accumulate_matches_jax_interpret_and_ref(bs, dtype):
    t, j, sym = _symbolic_lists(2, bs, dtype)
    tol = TOL[dtype]
    for (i, jj, k) in [(0, 0, 0), (0, 1, 1), (1, 1, 0)]:
        lists = [sym.pair_a[i, jj, k], sym.pair_b[i, jj, k],
                 sym.pair_slot[i, jj, k]]
        got = tops.bsr_pair_accumulate(
            t.blocks[i, k], t.blocks[k, jj],
            *(torch.from_numpy(x) for x in lists),
            n_slots=sym.store_capacity)
        assert got.dtype == getattr(torch, dtype)
        for impl in ("interpret", "ref"):
            want = jops.bsr_pair_accumulate(
                j.blocks[i, k], j.blocks[k, jj],
                *(jnp.asarray(x) for x in lists),
                n_slots=sym.store_capacity, impl=impl)
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                       atol=tol, err_msg=impl)
        # float32 output and a carry: c + step, each slot's sum once
        f32 = tops.bsr_pair_accumulate(
            t.blocks[i, k], t.blocks[k, jj],
            *(torch.from_numpy(x) for x in lists),
            n_slots=sym.store_capacity, out_dtype=torch.float32)
        carry = torch.ones_like(f32)
        out = tops.bsr_pair_accumulate(
            t.blocks[i, k], t.blocks[k, jj],
            *(torch.from_numpy(x) for x in lists),
            n_slots=sym.store_capacity, acc=carry)
        assert out is carry
        np.testing.assert_array_equal(out.numpy(), (1 + f32).numpy())


def test_pair_accumulate_batched_equals_per_tile_and_chunking(monkeypatch):
    t, j, sym = _symbolic_lists(2, 4, "float32", seed=3)
    pairs = sym.scheduled_pairs(lambda i, jj, s, g: (i + jj + s) % g)
    # step 0 on the stacked grid: position (i, j) holds A[i, k], A[k, j]
    k = (np.arange(2)[:, None] + np.arange(2)[None, :]) % 2
    ii, jj = np.arange(2)[:, None], np.arange(2)[None, :]
    a = t.blocks[ii, k].reshape(4, -1, 4, 4)
    b = t.blocks[k, jj].reshape(4, -1, 4, 4)
    lists = [torch.from_numpy(pairs[x][:, :, 0].reshape(4, -1))
             for x in ("pa", "pb", "ps")]
    whole = tref.bsr_pair_accumulate_raw_ref(a, b, *lists,
                                             sym.store_capacity)
    for n in range(4):
        np.testing.assert_array_equal(
            tref.bsr_pair_accumulate_raw_ref(
                a[n], b[n], *(x[n] for x in lists),
                sym.store_capacity).numpy(), whole[n].numpy())
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 1)    # one pair a chunk
    np.testing.assert_allclose(
        tref.bsr_pair_accumulate_raw_ref(a, b, *lists,
                                         sym.store_capacity).numpy(),
        whole.numpy(), rtol=1e-6, atol=1e-6)


def _replay_pair_kernel(a, b, pa, pb, table, bs, acc=None):
    """The CUDA pair kernel's work, step by step in plain PyTorch: a fresh
    output's fill runs zero the slots no real pair visits; each chunk sums
    its real pairs (found through ``pidx``) in order; a segment's only
    chunk stores C (carry + sum with ``acc``), longer segments store
    partials that the reduce pass sums in chunk order.  Returns the output
    and how many times each pair was multiplied ([T, P])."""
    t, n_slots = a.shape[0], table.n_slots
    out = torch.full((t, n_slots, bs, bs), float("nan")) if acc is None \
        else acc.clone()
    written = torch.zeros((t, n_slots), dtype=torch.int64)
    if acc is None:
        for tile, s0, n in table.fill.T.tolist():
            assert 0 < n <= bsr_pair.FILL_RUN and s0 + n <= n_slots
            out[tile, s0:s0 + n] = 0
            written[tile, s0:s0 + n] += 1
    partial = torch.full((table.n_parts, bs, bs), float("nan"))
    multiplied = torch.zeros(pa.shape, dtype=torch.int64)
    pidx = table.pidx.tolist()
    for tile, q0, q1, slot, part in table.chunks.T.tolist():
        assert q0 < q1
        s = torch.zeros((bs, bs))
        for q in range(q0, q1):
            p = pidx[q]
            s += a[tile, pa[tile, p]].float() @ b[tile, pb[tile, p]].float()
            multiplied[tile, p] += 1
        if part < 0:
            out[tile, slot] = s if acc is None else out[tile, slot] + s
            written[tile, slot] += 1
        else:
            partial[part] = s
    for tile, slot, first, n in table.reduce.T.tolist():
        s = torch.zeros((bs, bs))
        for c in range(first, first + n):
            s += partial[c]
        out[tile, slot] = s if acc is None else out[tile, slot] + s
        written[tile, slot] += 1
    assert int(written.max()) <= 1, "an output block is written twice"
    if acc is None:
        assert bool((written == 1).all()), "a fresh slot is left unwritten"
    return out, multiplied


@pytest.mark.parametrize("chunk,max_parts", [(1, 2048), (2, 3), (32, 2048),
                                             (3, 1)])
def test_pair_table_work_split_covers_every_pair_once(chunk, max_parts):
    """Without a mask every pair is real: the table covers each pair once
    and leaves no slot unwritten."""
    t, j, sym = _symbolic_lists(2, 4, "float32", seed=5)
    i, jj, k = 0, 0, 0
    a = t.blocks[i, k][None].expand(3, -1, -1, -1)
    b = t.blocks[k, jj][None].expand(3, -1, -1, -1)
    lists = [torch.from_numpy(x[i, jj, k]).expand(3, -1).contiguous()
             for x in (sym.pair_a, sym.pair_b, sym.pair_slot)]
    n_slots = sym.store_capacity
    # the padding segment (inert pairs on the last slot) is long
    assert int((lists[2][0] == n_slots - 1).sum()) > 5
    table = pair_table(lists[2], n_slots, chunk=chunk, max_parts=max_parts)
    assert table.tiles == 3 and table.real_pairs == lists[0].numel()
    assert table.fill.shape[1] == 0          # coverage pairs visit every slot
    seg = np.diff(np.flatnonzero(np.r_[True, np.diff(
        lists[2][0].numpy()) != 0, True]))
    size = np.maximum(chunk, -(-seg // max_parts))
    assert table.chunks.shape[1] == 3 * int((-(-seg // size)).sum())
    want = tref.bsr_pair_accumulate_raw_ref(a, b, *lists, n_slots)
    got, multiplied = _replay_pair_kernel(a, b, lists[0], lists[1], table, 4)
    assert bool((multiplied == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    carry = torch.from_numpy(np.random.default_rng(1).standard_normal(
        want.shape).astype(np.float32))
    got, _ = _replay_pair_kernel(a, b, lists[0], lists[1], table, 4,
                                 acc=carry)
    np.testing.assert_allclose(got.numpy(), (carry + want).numpy(),
                               rtol=1e-5, atol=1e-5)


def _ring_step(t, sched, g: int, step: int):
    """Step ``step`` of the sparse-output ring on the stacked grid: the
    [g*g, S, bs, bs] tiles position (i, j) holds, A[i, k] and B[k, j] with
    k = (i + j + step) % g, and the step's [g*g, P] lists and real mask."""
    bs = t.block_size
    ii, jj = np.arange(g)[:, None], np.arange(g)[None, :]
    k = (ii + jj + step) % g
    a = t.blocks[ii, k].reshape(g * g, -1, bs, bs)
    b = t.blocks[k, jj].reshape(g * g, -1, bs, bs)
    lists = [torch.from_numpy(np.ascontiguousarray(
        sched[x][:, :, step].reshape(g * g, -1))) for x in ("pa", "pb", "ps")]
    return a, b, lists, sched["real"][:, :, step].reshape(g * g, -1)


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compacted_table_replays_the_ring_steps(g, bs, dtype):
    """The ring's lists at plan-time real masks, replayed step by step as
    the sparse body runs them (step 0 fresh, then into the carry): every
    real pair multiplied once and no inert one, slots that only inert
    pairs visit exactly 0 in a fresh output and bit-identical in a carry,
    and the sums those of the plain version."""
    t, _, _ = _symbolic_lists(g, bs, dtype, seed=g)
    sym = tsym.symbolic_spgemm(t, t)
    sched = sym.scheduled_pairs(lambda i, jj, s, g_: (i + jj + s) % g_)
    n_slots = sym.store_capacity
    carry = want_c = None
    for step in range(g):
        a, b, lists, real = _ring_step(t, sched, g, step)
        assert (~real).any() and real.sum() == sum(
            sym.n_real_pairs[i, jj, (i + jj + step) % g]
            for i in range(g) for jj in range(g))
        # short chunks, so that hub segments take the partial path
        table = pair_table(lists[2], n_slots, real=real, chunk=2)
        assert table.real_pairs == int(real.sum())
        want = tref.bsr_pair_accumulate_raw_ref(a, b, *lists, n_slots)
        fresh, multiplied = _replay_pair_kernel(a, b, lists[0], lists[1],
                                                table, bs)
        np.testing.assert_array_equal(multiplied.numpy(), real.astype(int))
        np.testing.assert_allclose(fresh.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        visited = np.zeros((g * g, n_slots), dtype=bool)
        for n in range(g * g):
            visited[n, lists[2][n].numpy()[real[n]]] = True
        assert (~visited).any(), "the case needs slots only inert pairs visit"
        assert bool((fresh[torch.from_numpy(~visited)] == 0).all())
        if carry is None:
            carry, want_c = fresh, want
            continue
        got, _ = _replay_pair_kernel(a, b, lists[0], lists[1], table, bs,
                                     acc=carry)
        untouched = torch.from_numpy(~visited)
        assert torch.equal(got[untouched], carry[untouched])
        want_c = want_c + want
        np.testing.assert_allclose(got.numpy(), want_c.numpy(), rtol=1e-5,
                                   atol=1e-5)
        carry = got


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_plan_real_mask_matches_the_data(g, wire):
    """The plan-time mask (both blocks the operands' zero slots = inert)
    equals the data: (a != 0).any & (b != 0).any at pa / pb of every
    step's stacked operands, on the padded and on the packed wire."""
    from repro_torch.core.api import DistBSR
    from repro_torch.core.wire import remap_pairs_packed
    a_d = tbsr.random_sparse(12 * 4, 12 * 4, 0.04, seed=g)
    a_d[:4, :] += tbsr.random_sparse(4, 12 * 4, 0.5, seed=g + 1)
    h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    t = h.tiled
    sym = tsym.symbolic_spgemm(t, t)
    k_order = lambda i, jj, s, g_: (i + jj + s) % g_
    blocks = t.blocks
    if wire == "packed":
        po = h.packed_operand()
        sched = sym.scheduled_pairs(
            k_order, pair_a=remap_pairs_packed(sym.pair_a, po, "a"),
            pair_b=remap_pairs_packed(sym.pair_b, po, "b"))
        ii = np.arange(g)[:, None, None]
        jj = np.arange(g)[None, :, None]
        blocks = t.blocks[ii, jj, torch.from_numpy(po.pack_idx).long()]
    else:
        sched = sym.scheduled_pairs(k_order)
    nz = (blocks != 0).flatten(3).any(dim=3)            # [g, g, S]
    for step in range(g):
        ii, jj = np.arange(g)[:, None], np.arange(g)[None, :]
        k = (ii + jj + step) % g
        a_nz = nz[ii, k].reshape(g * g, -1)
        b_nz = nz[k, jj].reshape(g * g, -1)
        tile = torch.arange(g * g)[:, None]
        pa = torch.from_numpy(sched["pa"][:, :, step].reshape(g * g, -1))
        pb = torch.from_numpy(sched["pb"][:, :, step].reshape(g * g, -1))
        data = (a_nz[tile, pa.long()] & b_nz[tile, pb.long()]).numpy()
        np.testing.assert_array_equal(
            sched["real"][:, :, step].reshape(g * g, -1), data)


def test_pair_table_dense_tile_slots_and_inert_coverage():
    """The pair-matmul table (slot = row * nbc + col) over real pairs: the
    coverage dummies on the appended zero slot are left out, and a block
    no real product touches comes out 0 through the fill list."""
    a_d = tbsr.random_sparse(48, 48, 0.004, seed=9)
    a = tbsr.BSR.from_dense(a_d, 8, device=CPU)
    nb = 6
    pa, pb, pr, pc, _ = tops.build_pair_lists(a.rows, a.cols, a.nnzb, a.rows,
                                              a.cols, a.nnzb, nb, nb)
    slots = torch.from_numpy(pr.astype(np.int64) * nb + pc)[None]
    real = ((pa != a.nnzb) | (pb != a.nnzb))[None]
    table = pair_table(slots, nb * nb, real=real)
    assert table.n_slots == nb * nb and table.real_pairs == int(real.sum())
    zero = torch.zeros((1, 8, 8))
    a_ext = torch.cat([a.blocks, zero])[None]
    got, multiplied = _replay_pair_kernel(
        a_ext, a_ext, torch.from_numpy(pa)[None], torch.from_numpy(pb)[None],
        table, 8)
    np.testing.assert_array_equal(multiplied.numpy(), real.astype(int))
    dense = got.reshape(nb, nb, 8, 8).permute(0, 2, 1, 3).reshape(48, 48)
    np.testing.assert_allclose(dense.numpy(), a_d @ a_d, rtol=1e-5,
                               atol=1e-5)
    plain = tops.bsr_pair_matmul(
        a.blocks, a.blocks, *(torch.from_numpy(x) for x in (pa, pb, pr, pc)),
        n_block_rows=nb, n_block_cols=nb)
    inert = [(r, c) for r in range(nb) for c in range(nb)
             if ((pr == r) & (pc == c) & (pa < a.nnzb)).sum() == 0]
    assert inert, "the case needs an output block with no real product"
    filled = {(tile, s) for tile, s0, n in table.fill.T.tolist()
              for s in range(s0, s0 + n)}
    assert filled == {(0, r * nb + c) for r, c in inert}
    for r, c in inert:
        assert bool((got[0, r * nb + c] == 0).all())
        assert bool((plain[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] == 0).all())


def test_pair_table_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="nondecreasing"):
        pair_table(np.array([[0, 2, 1]]), 3)
    with pytest.raises(ValueError, match="outside"):
        pair_table(np.array([[0, 3]]), 3)
    with pytest.raises(ValueError, match=r"\[T, P\]"):
        pair_table(np.array([0, 1]), 3)
    with pytest.raises(ValueError, match="real must be"):
        pair_table(np.array([[0, 1]]), 3, real=np.ones((1, 3), bool))
    uncovered = pair_table(np.array([[0, 0, 2], [1, 1, 1]]), 3)
    assert uncovered.n_parts == 0 and uncovered.workspace_bytes(4) == 0
    np.testing.assert_array_equal(uncovered.fill.numpy().T,
                                  [[0, 1, 1], [1, 0, 1], [1, 2, 1]])
    # runs are cut at tile ends and every FILL_RUN slots
    assert bsr_pair.FILL_RUN == 64
    none = pair_table(np.zeros((2, 3), np.int64), 150,
                      real=np.zeros((2, 3), bool))
    assert none.chunks.shape[1] == 0 and none.real_pairs == 0
    np.testing.assert_array_equal(none.fill.numpy().T, [
        [0, 0, 64], [0, 64, 64], [0, 128, 22],
        [1, 0, 64], [1, 64, 64], [1, 128, 22]])
    assert bsr_pair.CHUNK == 32


def test_pair_ops_refuse_the_kernel_on_cpu_tensors():
    blocks = torch.zeros((2, 4, 4))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.bsr_pair_accumulate(blocks, blocks, idx, idx, idx, n_slots=1,
                                 impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.bsr_pair_matmul(blocks, blocks, idx, idx, idx, idx,
                             n_block_rows=1, n_block_cols=1, impl="cuda")
    table = pair_table(idx[None], 1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsr_pair_accumulate_cuda(blocks[None], blocks[None], idx[None],
                                 idx[None], table)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsr_pair_matmul_cuda(blocks[None], blocks[None], idx[None],
                             idx[None], table, n_block_rows=1,
                             n_block_cols=1)
