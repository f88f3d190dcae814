"""The port's kernel ops against the JAX package's.

On the CPU the port's ``ops`` run the plain PyTorch version
(``kernels/ref.py``); it is held against the JAX package's Pallas kernel in
interpret mode and against its jnp reference, on the grid of shapes of
``tests/test_kernels.py``, at the reference's tolerances (float32 1e-5,
bf16 2e-2).  The kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``, which imports no JAX.
"""
import bisect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bsr as jbsr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bsr as tbsr
from repro_torch.core.grid import ProcessGrid
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda, segment_bounds

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


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_augment_coverage_matches_augment_tile(density):
    a_d = tbsr.random_sparse(20, 12, density, seed=3)
    flat = jbsr.BSR.from_dense(a_d, 4, capacity=16)
    nbr = flat.n_block_rows
    want = jbsr._augment_tile(np.asarray(flat.blocks), np.asarray(flat.rows),
                              np.asarray(flat.cols), nbr)
    blocks, rows, cols = (torch.from_numpy(np.array(x))[None] for x in
                          (flat.blocks, flat.rows, flat.cols))
    got = tops.augment_coverage(blocks, rows, cols, nbr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
    # batched: each tile is augmented on its own
    two = tops.augment_coverage(blocks.expand(2, -1, -1, -1),
                                rows.expand(2, -1), cols.expand(2, -1), nbr)
    for g, w in zip(two, want):
        np.testing.assert_array_equal(g[1].numpy(), w)


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


def _two_pass(blocks, rows, cols, dense, nbr, chunk):
    """The CUDA kernel's work split, step by step in plain PyTorch: chunk
    partials found through ``chunk_ptr`` (the last r with cp[r] <= c), then
    each segment's partials summed in chunk order."""
    row_ptr, chunk_ptr, max_chunks = segment_bounds(rows, nbr, chunk)
    t, s, bs, _ = blocks.shape
    n = dense.shape[-1]
    partial = torch.full((t, max_chunks, bs, n), float("nan"))
    out = torch.zeros((t, nbr * bs, n))
    for ti in range(t):
        cp, rp = chunk_ptr[ti].tolist(), row_ptr[ti].tolist()
        assert cp[0] == 0 and cp[-1] <= max_chunks
        assert all(b > a for a, b in zip(cp, cp[1:]))
        for c in range(cp[-1]):
            r = bisect.bisect_right(cp, c) - 1
            s0 = rp[r] + (c - cp[r]) * chunk
            s1 = min(rp[r + 1], s0 + chunk)
            assert s0 <= s1 and (s0 < s1 or rp[r] == rp[r + 1])
            acc = torch.zeros((bs, n))
            for si in range(s0, s1):
                col = int(cols[ti, si])
                acc += blocks[ti, si].float() @ \
                    dense[ti, col * bs:(col + 1) * bs].float()
            partial[ti, c] = acc
        for r in range(nbr):
            out[ti, r * bs:(r + 1) * bs] = partial[ti, cp[r]:cp[r + 1]].sum(0)
    return out


@pytest.mark.parametrize("chunk", [1, 2, 3, 32])
def test_kernel_work_split_covers_every_block_once(chunk):
    a_d = tbsr.random_sparse(36, 24, 0.35, seed=8)
    a_d[8:16] = 0                                   # empty block-rows
    t = tbsr.TiledBSR.from_dense(a_d, ProcessGrid(1, 2), 4, capacity=40,
                                 device=CPU)       # long padding segment
    s, nbr = t.store_capacity, t.tile_shape[0] // 4
    dense = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 12, 5)).astype(np.float32))
    args = (t.blocks.reshape(2, s, 4, 4), t.rows.reshape(2, s),
            t.cols.reshape(2, s), dense)
    got = _two_pass(*args, nbr, chunk)
    want = tref.bsr_spmm_raw_ref(*args, nbr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    row_ptr, chunk_ptr, max_chunks = segment_bounds(args[1], nbr, chunk)
    seg = (row_ptr[:, 1:] - row_ptr[:, :-1]).numpy()
    np.testing.assert_array_equal(
        np.diff(chunk_ptr.numpy(), axis=1),
        np.maximum(1, -(-seg // chunk)))
    assert max_chunks == nbr + -(-s // chunk)


def test_impl_dispatch_refuses_the_kernel_on_cpu_tensors():
    a = tbsr.BSR.from_dense(tbsr.random_sparse(8, 8, 0.5, seed=1), 4,
                            device=CPU)
    b = torch.ones((8, 3))
    assert tops.default_impl(b) == "ref"
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.bsr_spmm(a, b, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.bsr_spmm(a, b, impl="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsr_spmm_cuda(a.blocks[None], a.rows[None], a.cols[None], b[None],
                      n_block_rows=2)

