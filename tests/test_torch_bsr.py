"""The port's grid helpers, tiling and generators against the JAX package.

Metadata (rows, cols, counts, capacities, balance permutations) must be
bit-identical, and block values equal, so that both packages multiply the
same tiles.  Everything runs on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bsr as jbsr
from repro.core import grid as jgrid
from repro.core import schedule as jschedule
from repro_torch.core import bsr as tbsr
from repro_torch.core import grid as tgrid
from repro_torch.core import schedule as tschedule
from repro_torch.core.interop import tiled_from_arrays

CPU = torch.device("cpu")


def _np(x) -> np.ndarray:
    """numpy float32/int view of a tensor or a JAX array (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_same_tiled(port: tbsr.TiledBSR, ref: jbsr.TiledBSR) -> None:
    assert port.shape == ref.shape
    assert port.logical_shape == ref.logical_shape
    assert port.block_size == ref.block_size
    assert port.grid_shape == ref.grid_shape
    assert port.capacity == ref.capacity
    assert port.store_capacity == ref.store_capacity
    assert port.row_block_perm == ref.row_block_perm
    assert port.col_block_perm == ref.col_block_perm
    for name in ("rows", "cols", "counts"):
        got, want = _np(getattr(port, name)), _np(getattr(ref, name))
        assert got.dtype == np.int32 and want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(_np(port.blocks), _np(ref.blocks))


# ---------------------------------------------------------------------------
# grid and schedule helpers
# ---------------------------------------------------------------------------
def test_grid_helpers_match():
    for a in range(-7, 40):
        for b in range(1, 9):
            assert tgrid.ceil_div(a, b) == jgrid.ceil_div(a, b)
            assert tgrid.pad_to_multiple(a, b) == jgrid.pad_to_multiple(a, b)
    for rows, cols in ((1, 1), (2, 3), (3, 3)):
        t, j = tgrid.ProcessGrid(rows, cols), jgrid.ProcessGrid(rows, cols)
        assert t.nprocs == j.nprocs
        for r in range(t.nprocs):
            assert t.coords(r) == j.coords(r)
            assert t.owner(*t.coords(r)) == j.owner(*j.coords(r)) == r
            assert t.k_offset(*t.coords(r)) == j.k_offset(*j.coords(r))
        for m, n in ((7, 5), (16, 9)):
            assert t.tile_shape(m, n) == j.tile_shape(m, n)
            assert t.padded_shape(m, n) == j.padded_shape(m, n)
            assert t.tile_slice(m, n, rows - 1, cols - 1) == \
                j.tile_slice(m, n, rows - 1, cols - 1)
    assert tgrid.ProcessGrid.square(9) == tgrid.ProcessGrid(3, 3)
    with pytest.raises(ValueError):
        tgrid.ProcessGrid.square(8)
    with pytest.raises(IndexError):
        tgrid.ProcessGrid(2, 2).owner(2, 0)


def test_bucket_capacity_series():
    got = [tgrid.bucket_capacity(c) for c in range(0, 3000)]
    want = [jgrid.bucket_capacity(c) for c in range(0, 3000)]
    assert got == want
    assert got[:8] == [0, 1, 2, 3, 4, 5, 7, 7]
    assert sorted(set(got))[:9] == [0, 1, 2, 3, 4, 5, 7, 9, 12]
    for ratio in (1.1, 1.5, 2.0):
        assert [tgrid.bucket_capacity(c, ratio) for c in range(200)] == \
            [jgrid.bucket_capacity(c, ratio) for c in range(200)]
    with pytest.raises(ValueError):
        tgrid.bucket_capacity(-1)


@pytest.mark.parametrize("seed,n,g", [(0, 12, 3), (1, 16, 2), (2, 9, 3)])
def test_balance_row_perm_and_invert_match(seed, n, g):
    nnz = np.random.default_rng(seed).integers(0, 20, n)
    got = tschedule.balance_row_perm(nnz, g)
    want = jschedule.balance_row_perm(nnz, g)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tschedule.invert_perm(got),
                                  jschedule.invert_perm(want))
    inv = tschedule.invert_perm(got)
    np.testing.assert_array_equal(inv[got], np.arange(n))
    with pytest.raises(ValueError):
        tschedule.balance_row_perm(nnz, n + 1)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale,edgefactor,seed", [(5, 8, 0), (7, 4, 3)])
def test_rmat_generators_draw_the_same_numbers(scale, edgefactor, seed):
    np.testing.assert_array_equal(
        tbsr.rmat_edges(scale, edgefactor, seed=seed),
        jbsr.rmat_edges(scale, edgefactor, seed=seed))
    np.testing.assert_array_equal(
        tbsr.rmat_matrix(scale, edgefactor, seed=seed),
        jbsr.rmat_matrix(scale, edgefactor, seed=seed))
    kw = dict(a=0.5, b=0.2, c=0.2, d=0.1)
    np.testing.assert_array_equal(
        tbsr.rmat_edges(scale, edgefactor, seed=seed, **kw),
        jbsr.rmat_edges(scale, edgefactor, seed=seed, **kw))


@pytest.mark.parametrize("m,n,density,seed", [(13, 7, 0.3, 0), (32, 32, 0.05, 9)])
def test_random_sparse_draws_the_same_numbers(m, n, density, seed):
    np.testing.assert_array_equal(tbsr.random_sparse(m, n, density, seed),
                                  jbsr.random_sparse(m, n, density, seed))


# ---------------------------------------------------------------------------
# BSR and TiledBSR construction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("capacity", [None, 11])
def test_bsr_from_dense_matches(capacity):
    a = tbsr.random_sparse(13, 11, 0.2, seed=4)
    port = tbsr.BSR.from_dense(a, 4, capacity=capacity, device=CPU)
    ref = jbsr.BSR.from_dense(a, 4, capacity=capacity)
    assert (port.shape, port.nnzb, port.logical_shape, port.capacity) == \
        (ref.shape, ref.nnzb, ref.logical_shape, ref.capacity)
    for name in ("blocks", "rows", "cols"):
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      _np(getattr(ref, name)))
    np.testing.assert_array_equal(_np(port.to_dense()), _np(ref.to_dense()))
    grown, ref_grown = port.with_capacity(12), ref.with_capacity(12)
    np.testing.assert_array_equal(_np(grown.rows), _np(ref_grown.rows))
    np.testing.assert_array_equal(_np(grown.cols), _np(ref_grown.cols))
    assert grown.flops(5) == ref_grown.flops(5)
    with pytest.raises(ValueError, match="cannot shrink"):
        grown.with_capacity(grown.capacity - 1)


def _matrix(kind: str) -> np.ndarray:
    if kind == "empty":
        return np.zeros((22, 17), np.float32)
    if kind == "dense":
        return np.random.default_rng(3).standard_normal(
            (22, 17)).astype(np.float32)
    if kind == "skewed":        # mass in the first rows and columns
        a = tbsr.random_sparse(48, 40, 0.01, seed=7)
        a[:12, :] += tbsr.random_sparse(12, 40, 0.5, seed=8)
        a[:, :8] += tbsr.random_sparse(48, 8, 0.5, seed=9)
        return a
    return tbsr.random_sparse(29, 23, 0.15, seed=5)


@pytest.mark.parametrize("kind", ["random", "skewed", "empty", "dense"])
@pytest.mark.parametrize("capacity", [None, "bucket", 40])
@pytest.mark.parametrize("g", [2, 3])
def test_tiled_from_dense_bit_identical(kind, capacity, g):
    a = _matrix(kind)
    grid = (g, g)
    port = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(*grid), 4,
                                    capacity=capacity, device=CPU)
    ref = jbsr.TiledBSR.from_dense(a, jgrid.ProcessGrid(*grid), 4,
                                   capacity=capacity)
    assert_same_tiled(port, ref)
    np.testing.assert_array_equal(_np(port.to_dense()), _np(ref.to_dense()))
    assert port.load_imbalance() == pytest.approx(ref.load_imbalance())
    assert port.padded_flop_waste() == pytest.approx(ref.padded_flop_waste())


@pytest.mark.parametrize("kind", ["random", "skewed", "empty", "dense"])
@pytest.mark.parametrize("capacity", [None, "bucket", 40])
def test_layout_real_slots_are_the_blocks_that_hold_data(kind, capacity):
    """The real mask read off the storage layout (rows and counts, no block
    values) is the JAX package's stored data mask, on 2 x 3 tiles of every
    kind and capacity."""
    a = _matrix(kind)
    port = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(2, 3), 4,
                                    capacity=capacity, device=CPU)
    ref = jbsr.TiledBSR.from_dense(a, jgrid.ProcessGrid(2, 3), 4,
                                   capacity=capacity)
    data = np.abs(_np(ref.blocks)).sum(axis=(3, 4)) != 0
    np.testing.assert_array_equal(port.real_slots(), data)
    np.testing.assert_array_equal(port.real_slots().sum(axis=2),
                                  _np(port.counts))


def test_layout_real_slots_of_the_symbolic_layout_and_refusals():
    """The symbolic phase lays C out the same way: the layout's mask is its
    predicted real blocks.  A list not laid out so is refused."""
    from repro_torch.core.symbolic import symbolic_spgemm
    a = _matrix("skewed")[:40, :40]
    t = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(2, 2), 4, device=CPU)
    sym = symbolic_spgemm(t, t)
    s = sym.store_capacity
    real = tbsr.layout_real_slots(sym.c_rows.reshape(-1, s),
                                  sym.c_counts.reshape(-1), sym.tile_nbr)
    np.testing.assert_array_equal(real.reshape(sym.c_real.shape),
                                  sym.c_real)
    with pytest.raises(ValueError, match="row-sorted"):
        tbsr.layout_real_slots(np.array([[1, 0, 1]]), np.array([1]), 2)
    with pytest.raises(ValueError, match="storage layout"):
        tbsr.layout_real_slots(np.array([[0, 0, 1]]), np.array([3]), 2)


@pytest.mark.parametrize("balance", ["none", "rows", "cols", "auto"])
@pytest.mark.parametrize("grid", [(2, 2), (3, 3), (2, 3)])
def test_tiled_balance_bit_identical(balance, grid):
    a = _matrix("skewed")
    port = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(*grid), 4,
                                    capacity="bucket", balance=balance,
                                    device=CPU)
    ref = jbsr.TiledBSR.from_dense(a, jgrid.ProcessGrid(*grid), 4,
                                   capacity="bucket", balance=balance)
    assert_same_tiled(port, ref)


@pytest.mark.parametrize("source", ["numpy", "tensor", "bf16-tensor",
                                    "float64-to-float32"])
@pytest.mark.parametrize("balance", ["none", "rows", "cols"])
def test_from_dense_keeps_the_input_type_and_the_stored_real_mask(source,
                                                                  balance):
    """One tiling path for every input: a numpy array or a tensor gives
    the JAX package's tiles (balanced too), the blocks take the input's
    type unless ``dtype`` is given, and the kept real mask
    (``TiledBSR.host()["real"]``) is the stored blocks' data mask, also
    where the cast to ``dtype`` rounds a listed block to zero."""
    a = _matrix("skewed")
    dtype = jdtype = None
    if source == "float64-to-float32":
        a = a.astype(np.float64)
        a[44:48, 36:40] = 1e-300        # a block float32 rounds to zero
        dtype, jdtype = torch.float32, jnp.float32
    x, ref_in = a, a
    if source == "tensor":
        x = torch.from_numpy(a)
    elif source == "bf16-tensor":
        x = torch.from_numpy(a).bfloat16()
        ref_in = jnp.asarray(a, jnp.bfloat16)
    grid = (2, 2)
    port = tbsr.TiledBSR.from_dense(x, tgrid.ProcessGrid(*grid), 4,
                                    capacity="bucket", balance=balance,
                                    dtype=dtype, device=CPU)
    ref = jbsr.TiledBSR.from_dense(ref_in, jgrid.ProcessGrid(*grid), 4,
                                   capacity="bucket", balance=balance,
                                   dtype=jdtype)
    assert_same_tiled(port, ref)
    assert port.dtype == {"bf16-tensor": torch.bfloat16,
                          "float64-to-float32": torch.float32}.get(
                              source, torch.float32)
    data = np.abs(_np(ref.blocks)).sum(axis=(3, 4)) != 0
    np.testing.assert_array_equal(port.host()["real"], data)
    if source == "float64-to-float32":
        assert (port.real_slots() & ~data).any()


def test_balance_permutations_are_exercised():
    """The skewed matrix does make each axis shrink the capacity, so the
    bit-identity above covers set permutations, not only None."""
    a = _matrix("skewed")
    grid = tgrid.ProcessGrid(2, 2)
    rows = tbsr.TiledBSR.from_dense(a, grid, 4, balance="rows", device=CPU)
    cols = tbsr.TiledBSR.from_dense(a, grid, 4, balance="cols", device=CPU)
    none = tbsr.TiledBSR.from_dense(a, grid, 4, device=CPU)
    assert rows.row_block_perm is not None and rows.col_block_perm is None
    assert cols.col_block_perm is not None and cols.row_block_perm is None
    assert rows.capacity < none.capacity and cols.capacity < none.capacity
    with pytest.raises(ValueError, match="unknown balance"):
        tbsr.TiledBSR.from_dense(a, grid, 4, balance="diag", device=CPU)


def test_tiled_bf16_and_capacity_errors():
    a = _matrix("random")
    grid = (2, 2)
    port = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(*grid), 4,
                                    dtype=torch.bfloat16, device=CPU)
    ref = jbsr.TiledBSR.from_dense(a, jgrid.ProcessGrid(*grid), 4,
                                   dtype=jnp.bfloat16)
    assert port.dtype == torch.bfloat16
    assert_same_tiled(port, ref)
    with pytest.raises(ValueError, match="capacity 1 < max tile nnzb"):
        tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(*grid), 4, capacity=1,
                                 device=CPU)


def test_tile_view_and_storage_contract():
    a = _matrix("random")
    t = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(2, 2), 4,
                                 capacity="bucket", device=CPU)
    nbr = t.tile_shape[0] // 4
    for i in range(2):
        for j in range(2):
            rows = t.rows[i, j]
            assert bool((rows[1:] >= rows[:-1]).all())          # sorted
            assert set(rows.tolist()) == set(range(nbr))          # covered
            tile = t.tile(i, j)
            tm, tn = t.tile_shape
            np.testing.assert_array_equal(
                _np(tile.to_dense()),
                _np(t.to_dense()[i * tm:(i + 1) * tm, j * tn:(j + 1) * tn]))


def test_default_device_is_the_card():
    a = _matrix("random")
    if torch.cuda.is_available():
        t = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(1, 1), 4)
        assert t.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(1, 1), 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbsr.BSR.from_dense(a, 4)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("balance", ["none", "rows", "cols"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_from_arrays_round_trips(balance, dtype):
    a = _matrix("skewed")
    ref = jbsr.TiledBSR.from_dense(a, jgrid.ProcessGrid(2, 2), 4,
                                   capacity="bucket", balance=balance,
                                   dtype=getattr(jnp, dtype))
    port = tiled_from_arrays(
        np.asarray(ref.blocks), np.asarray(ref.rows), np.asarray(ref.cols),
        np.asarray(ref.counts), shape=ref.shape, block_size=ref.block_size,
        grid_shape=ref.grid_shape, capacity=ref.capacity,
        logical_shape=ref.logical_shape, row_block_perm=ref.row_block_perm,
        col_block_perm=ref.col_block_perm, device=CPU)
    assert port.dtype == getattr(torch, dtype)
    assert_same_tiled(port, ref)
    built = tbsr.TiledBSR.from_dense(a, tgrid.ProcessGrid(2, 2), 4,
                                     capacity="bucket", balance=balance,
                                     dtype=getattr(torch, dtype), device=CPU)
    assert_same_tiled(built, ref)


def test_tiled_from_arrays_rejects_bad_shapes():
    ref = jbsr.TiledBSR.from_dense(_matrix("random"), jgrid.ProcessGrid(2, 2),
                                   4)
    fields = [np.asarray(x) for x in (ref.blocks, ref.rows, ref.cols,
                                      ref.counts)]
    kw = dict(shape=ref.shape, block_size=4, grid_shape=(2, 2),
              capacity=ref.capacity, device=CPU)
    with pytest.raises(ValueError, match="rows has shape"):
        tiled_from_arrays(fields[0], fields[1][:, :, :-1], *fields[2:], **kw)
    with pytest.raises(ValueError, match="store capacity"):
        tiled_from_arrays(*fields, **{**kw, "capacity": ref.capacity + 1})
