"""Tile placement and the stacked-grid executor against the JAX package.

The skews are gathers on the ``[g, g, ...]`` tile grid and must place the
same tiles as ``repro.core.dist``; the executor's ring shift must move
tiles as ``lax.ppermute`` does with the ring bodies' perm
``[((d + sign) % g, d)]`` (pairs of source and destination: device d
receives from d + sign).  g=3 tells a wrong sign from a right one, which
g=2 cannot.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import bsr as jbsr
from repro.core import dist as jdist
from repro_torch.core import bsr as tbsr
from repro_torch.core import dist as tdist
from repro_torch.core.executor import StackedExecutor
from repro_torch.core.grid import ProcessGrid

CPU = torch.device("cpu")


def _global(g: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (4 * g, 6 * g)).astype(np.float32)


@pytest.mark.parametrize("g", [1, 2, 3])
def test_tileize_untileize_match(g):
    x = _global(g)
    tiles = tdist.tileize(torch.from_numpy(x), g)
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(jdist.tileize(jnp.asarray(x), g)))
    assert tiles.is_contiguous()
    np.testing.assert_array_equal(tdist.untileize(tiles).numpy(), x)


@pytest.mark.parametrize("g", [2, 3, 4])
@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_skew_dense_matches_and_unskew_inverts(g, kind):
    x = _global(g, seed=g)
    got = tdist.skew_dense(torch.from_numpy(x), g, kind)
    want = jdist.skew_dense(jnp.asarray(x), g, kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "rows":
        # the epilogue's unskew undoes the rows skew
        np.testing.assert_array_equal(
            tdist.unskew_c_rows(got, g).numpy(), x)
    with pytest.raises(ValueError):
        tdist.skew_dense(torch.from_numpy(x), g, "diag")


@pytest.mark.parametrize("g", [2, 3])
def test_unskew_matches(g):
    x = _global(g, seed=5)
    np.testing.assert_array_equal(
        tdist.unskew_c_rows(torch.from_numpy(x), g).numpy(),
        np.asarray(jdist.unskew_c_rows(jnp.asarray(x), g)))


@pytest.mark.parametrize("g", [2, 3])
def test_place_b_for_stationary_a_matches(g):
    x = _global(g, seed=7)
    np.testing.assert_array_equal(
        tdist.place_b_for_stationary_a(torch.from_numpy(x), g).numpy(),
        np.asarray(jdist.place_b_for_stationary_a(jnp.asarray(x), g)))


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_skew_bsr_matches(g, kind):
    a = tbsr.random_sparse(8 * g, 8 * g, 0.3, seed=g)
    port = tdist.skew_bsr(tbsr.TiledBSR.from_dense(
        a, ProcessGrid(g, g), 4, capacity="bucket", device=CPU), kind)
    ref = jdist.skew_bsr(jbsr.TiledBSR.from_dense(
        a, jbsr.ProcessGrid(g, g), 4, capacity="bucket"), kind)
    for name in ("blocks", "rows", "cols", "counts"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (port.capacity, port.shape, port.logical_shape) == \
        (ref.capacity, ref.shape, ref.logical_shape)
    # skewing back with the inverse roll restores natural placement
    inv = tdist._roll_rows if kind == "rows" else tdist._roll_cols
    t0 = tbsr.TiledBSR.from_dense(a, ProcessGrid(g, g), 4, capacity="bucket",
                                  device=CPU)
    np.testing.assert_array_equal(inv(port.blocks, -1).numpy(),
                                  t0.blocks.numpy())
    with pytest.raises(ValueError):
        tdist.skew_bsr(t0, "diag")


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("sign", [1, -1])
def test_ring_shift_is_the_ppermute_perm(g, axis, sign):
    """Position d along ``axis`` ends up holding what position ``src`` held,
    for every (src, dst) pair of the JAX ring bodies' perm."""
    ex = StackedExecutor(g, CPU)
    # tile (i, j) carries the value 10*i + j in every element
    ids = (10 * torch.arange(g)[:, None] + torch.arange(g)[None, :])
    tree = {"dense": ids[:, :, None, None].expand(g, g, 2, 3).contiguous(),
            "rows": ids.clone()}
    out = ex.shift(tree, axis, sign)
    perm = japi._ring_perm(g, sign)
    assert perm == [((d + sign) % g, d) for d in range(g)]
    for src, dst in perm:
        for other in range(g):
            i_dst, j_dst = (dst, other) if axis == "row" else (other, dst)
            i_src, j_src = (src, other) if axis == "row" else (other, src)
            want = 10 * i_src + j_src
            assert int(out["rows"][i_dst, j_dst]) == want
            assert bool((out["dense"][i_dst, j_dst] == want).all())
    # g shifts in one direction go round the ring once
    back = tree
    for _ in range(g):
        back = ex.shift(back, axis, sign)
    assert torch.equal(back["dense"], tree["dense"])


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("sign", [1, -1])
def test_map_driven_ring_steps_read_the_rolled_tiles(g, sign):
    """A ring of tile-map compositions (the dense-output bodies') reads,
    at every step, the tiles that the rolls of the stacked grid (the
    sparse-output body's) hold there, along either axis and both ways."""
    ex = StackedExecutor(g, CPU)
    ids = (10 * torch.arange(g)[:, None] + torch.arange(g)[None, :])
    stack = ids[:, :, None, None].expand(g, g, 2, 3).contiguous()
    tree = {"dense": stack}
    maps = {"row": ex.identity_map(), "col": ex.identity_map()}
    rolled = {"row": tree, "col": tree}
    for step in range(2 * g + 1):
        for axis in ("row", "col"):
            if step:
                maps[axis] = ex.shift_map(maps[axis], axis, sign)
                rolled[axis] = ex.shift(rolled[axis], axis, sign)
            read = ex.batch(stack)[torch.from_numpy(maps[axis])]
            assert torch.equal(ex.unbatch(read), rolled[axis]["dense"])
    assert maps["row"].dtype.kind == "i" and maps["row"].shape == (g * g,)


def test_executor_batches_the_grid():
    ex = StackedExecutor(3, CPU)
    x = torch.arange(3 * 3 * 2 * 5).reshape(3, 3, 2, 5)
    b = ex.batch(x)
    assert tuple(b.shape) == (9, 2, 5)
    assert torch.equal(b[3 * 1 + 2], x[1, 2])
    assert torch.equal(ex.unbatch(b), x)
