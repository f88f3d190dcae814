"""The rest of ``repro_torch.core`` against the JAX package's.

``reshard`` re-tiles a handle onto another grid: from g = 2 to g = 1 and
back it equals the port's direct tiling field for field, and at g = 1 it
equals the JAX package's ``reshard``.  ``invalidate_plans`` evicts what the
JAX package's evicts for the same plans and filters.  ``BSR.from_scipy`` and
``BSR.block_fill_ratio`` match; the deprecated shims of ``core/spmm.py``
warn and share the plan cache; ``validate_mesh`` refuses a grid the
stacked executor cannot run.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import bsr as jbsr
from repro_torch.core import api as tapi
from repro_torch.core import bsr as tbsr
from repro_torch.core import spmm as legacy
from repro_torch.core.api import DistBSR, DistDense, matmul, plan_matmul
from repro_torch.core.executor import StackedExecutor
from repro_torch.core.grid import ProcessGrid

CPU = torch.device("cpu")


def _skewed(m=40, n=36, seed=0):
    a = tbsr.random_sparse(m, n, 0.05, seed=seed)
    a[:8, :] += tbsr.random_sparse(8, n, 0.5, seed=seed + 1)
    return a


def _same_tiled(got, want):
    for f in ("blocks", "rows", "cols", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("shape", "grid_shape", "capacity", "block_size",
              "logical_shape"):
        assert tuple(np.atleast_1d(getattr(got, f))) == \
            tuple(np.atleast_1d(getattr(want, f))), f


@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2), (3, 2), (2, 3)])
@pytest.mark.parametrize("capacity", ["bucket", None])
def test_reshard_equals_direct_tiling(src, dst, capacity):
    a = _skewed()
    h = DistBSR.from_dense(a, g=src, block_size=4, device=CPU)
    got = tapi.reshard(h, dst, capacity=capacity)
    want = DistBSR.from_dense(a, g=dst, block_size=4, capacity=capacity,
                              device=CPU)
    assert got.g == dst
    _same_tiled(got.tiled, want.tiled)
    np.testing.assert_array_equal(got.densify().numpy(), a)
    # and back
    _same_tiled(tapi.reshard(got, src, capacity=capacity).tiled,
                DistBSR.from_dense(a, g=src, block_size=4,
                                   capacity=capacity, device=CPU).tiled)


@pytest.mark.parametrize("src", [2, 3])
def test_reshard_to_one_tile_matches_jax(src):
    a = _skewed(seed=3)
    got = tapi.reshard(DistBSR.from_dense(a, g=src, block_size=4,
                                          device=CPU), 1)
    want = japi.reshard(japi.DistBSR.from_dense(a, g=src, block_size=4), 1)
    _same_tiled(got.tiled, want.tiled)
    b = np.random.default_rng(0).standard_normal((36, 5)).astype(np.float32)
    np.testing.assert_allclose(matmul(got, b).numpy(), a @ b, rtol=1e-5,
                               atol=1e-5)


def test_reshard_dense_same_grid_and_refusals():
    x = np.random.default_rng(1).standard_normal((10, 7)).astype(np.float32)
    d = DistDense.from_global(x, 2, device=CPU)
    d3 = tapi.reshard(d, 3)
    assert d3.g == 3 and d3.logical_shape == (10, 7)
    np.testing.assert_array_equal(d3.data[:10, :7].numpy(), x)
    assert tapi.reshard(d, 2) is d
    h = DistBSR.from_dense(_skewed(), g=2, block_size=4, device=CPU)
    assert tapi.reshard(h, 2) is h
    with pytest.raises(ValueError, match="grid size must be >= 1"):
        tapi.reshard(h, 0)
    bal = DistBSR.from_dense(_skewed(), g=2, block_size=4, balance="rows",
                             device=CPU)
    with pytest.raises(ValueError) as e_t:
        tapi.reshard(bal, 1)
    with pytest.raises(ValueError) as e_j:
        japi.reshard(japi.DistBSR.from_dense(_skewed(), g=2, block_size=4,
                                             balance="rows"), 1)
    assert str(e_t.value) == str(e_j.value)
    with pytest.raises(ValueError, match="capacity 1 < max tile nnzb"):
        tapi.reshard(h, 1, capacity=1)
    with pytest.raises(TypeError, match="cannot reshard"):
        tapi.reshard(object(), 1)


def _plans(api, handle, rhs, kw):
    """The same plans through one package (g = 1): ring_c and steal3d on
    SpMM, a sparse output, and ring_c on a second structure."""
    api.clear_plan_cache()
    a_h, s_h = handle(_skewed(32, 32, 5)), handle(_skewed(32, 32, 7))
    b_h = rhs(np.ones((32, 4), np.float32), a_h)
    api.plan_matmul(a_h, b_h, algorithm="ring_c", **kw)
    api.plan_matmul(a_h, b_h, algorithm="steal3d", **kw)
    api.plan_matmul(a_h, s_h, output="sparse", **kw)
    api.plan_matmul(s_h, rhs(np.ones((32, 4), np.float32), s_h),
                    algorithm="ring_c", **kw)
    return a_h.structure_key(), s_h.structure_key()


def test_invalidate_plans_matches_jax():
    """Each filter evicts what the JAX package's evicts, cache by cache."""
    def run(api, handle, rhs, kw):
        counts = []
        for filt in ("algorithm", "structure", "g", "combined"):
            fa, fs = _plans(api, handle, rhs, kw)
            n = {"algorithm": lambda: api.invalidate_plans(
                     algorithm="steal3d"),
                 "structure": lambda: api.invalidate_plans(structure=fa),
                 "g": lambda: api.invalidate_plans(g=1),
                 "combined": lambda: api.invalidate_plans(
                     algorithm="ring_c", structure=fs)}[filt]()
            counts.append((filt, n, api.plan_cache_size(),
                           {k: v["size"] for k, v in
                            api.cache_stats().items()}))
        return counts

    got = run(tapi, lambda d: DistBSR.from_dense(d, g=1, block_size=4,
                                                 device=CPU),
              lambda b, a_h: DistDense.for_rhs(b, a_h), {})
    want = run(japi, lambda d: japi.DistBSR.from_dense(d, g=1, block_size=4),
               lambda b, a_h: japi.DistDense.for_rhs(jnp.asarray(b), a_h),
               {"impl": "ref"})
    assert got == want
    assert got[0][1] == 1 and got[2][2] == 0
    with pytest.raises(ValueError) as e_t:
        tapi.invalidate_plans()
    with pytest.raises(ValueError) as e_j:
        japi.invalidate_plans()
    assert str(e_t.value) == str(e_j.value)


def test_invalidate_plans_by_grid():
    tapi.clear_plan_cache()
    a = _skewed(32, 32, 5)
    for g in (1, 2):
        h = DistBSR.from_dense(a, g=g, block_size=4, device=CPU)
        plan_matmul(h, np.ones((32, 4), np.float32), algorithm="steal3d")
        plan_matmul(h, np.ones((32, 4), np.float32), algorithm="ring_c")
    assert tapi.plan_cache_size() == 4
    assert tapi.invalidate_plans(g=2) == 3     # 2 plans + 1 steal plan
    assert tapi.plan_cache_size() == 2
    assert tapi.cache_stats()["steal"]["size"] == 1


def test_bsr_from_scipy_matches_dense_and_fill_ratio():
    d = tbsr.random_sparse(24, 24, 0.1, seed=3)
    a1 = tbsr.BSR.from_scipy(sps.csr_matrix(d), 8, device=CPU)
    a2 = tbsr.BSR.from_dense(d, 8, device=CPU)
    np.testing.assert_array_equal(a1.to_dense().numpy(),
                                  a2.to_dense().numpy())
    assert a1.nnzb == a2.nnzb
    j = jbsr.BSR.from_scipy(sps.coo_matrix(d), 8)
    assert a1.nnzb == j.nnzb
    np.testing.assert_array_equal(a1.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    assert a1.block_fill_ratio() == j.block_fill_ratio()
    padded = tbsr.BSR.from_dense(d, 8, capacity=a2.nnzb + 3, device=CPU)
    assert padded.block_fill_ratio() == a2.block_fill_ratio()
    assert tbsr.BSR.from_dense(np.zeros((8, 8), np.float32), 4,
                               device=CPU).block_fill_ratio() == 0.0


def test_shims_warn_and_share_the_plan_cache():
    a_d = tbsr.random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    t = tbsr.TiledBSR.from_dense(a_d, ProcessGrid(1, 1), 4, device=CPU)
    tapi.clear_plan_cache()
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.core\.spmm\.spmm is deprecated"):
        old1 = legacy.spmm(t, b, algorithm="ring_c", device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        old2 = legacy.spmm(t, b, algorithm="ring_c", device=CPU)
    assert tapi.plan_cache_size() == 1
    new = matmul(DistBSR.from_tiled(t), b, algorithm="ring_c")
    np.testing.assert_array_equal(old1.numpy(), new.numpy())
    np.testing.assert_array_equal(old2.numpy(), new.numpy())
    s = tbsr.TiledBSR.from_dense(tbsr.random_sparse(16, 16, 0.2, seed=1),
                                 ProcessGrid(1, 1), 4, device=CPU)
    with pytest.warns(DeprecationWarning, match="spgemm is deprecated"):
        got = legacy.spgemm(t, s, algorithm="steal3d")
    np.testing.assert_allclose(got.numpy(),
                               a_d @ s.to_dense().numpy(), atol=1e-5)
    x = np.random.default_rng(1).standard_normal((10, 7)).astype(np.float32)
    y = np.random.default_rng(2).standard_normal((7, 5)).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="dense_matmul is deprecated"):
        got = legacy.dense_matmul(x, y, g=1, device=CPU)
    np.testing.assert_allclose(got.numpy(), x @ y, atol=1e-5)
    assert legacy.ALGORITHMS == tapi.algorithms()


def test_validate_mesh_refuses_what_the_executor_cannot_run():
    h = DistBSR.from_dense(_skewed(), g=2, block_size=4, device=CPU)
    ex = StackedExecutor(2, CPU)
    tapi.validate_mesh(ex, 2, h)
    assert legacy.validate_mesh is tapi.validate_mesh
    with pytest.raises(ValueError, match="grid size must be >= 1"):
        tapi.validate_mesh(ex, 0)
    with pytest.raises(ValueError, match="does not match the 3x3"):
        tapi.validate_mesh(ex, 3)
    with pytest.raises(ValueError, match="lives on a 2x2 grid"):
        tapi.validate_mesh(StackedExecutor(3, CPU), 3, h)
    with pytest.raises(ValueError, match="lives on cpu"):
        tapi.validate_mesh(StackedExecutor(2, torch.device("meta")), 2, h)
