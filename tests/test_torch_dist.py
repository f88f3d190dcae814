"""Tile placement and the stacked-grid executor against the JAX package.

A placement is one index map of the ``[g, g]`` tile grid
(``placement_tiles``): the handles' placed trees it gathers, and the
maps the stacked bodies launch with, must place the same tiles as
``repro.core.dist``; the executor's ring shift, a composition of tile
maps, must read tiles as ``lax.ppermute`` moves them with the ring
bodies' perm ``[((d + sign) % g, d)]`` (pairs of source and destination:
device d receives from d + sign).  g=3 tells a wrong sign from a right
one, which g=2 cannot.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import bsr as jbsr
from repro.core import dist as jdist
from repro_torch.core import api as tapi
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
    """A dense handle's skewed tile grid (one gather by ``placement_tiles``)
    is the JAX package's ``skew_dense`` tileized, and ``unplace`` (the
    epilogue's inverse) gives the natural matrix back."""
    x = _global(g, seed=g)
    placement = "skew_" + kind
    got = tapi.DistDense(torch.from_numpy(x), g).placed(placement)["dense"]
    want = jdist.tileize(jdist.skew_dense(jnp.asarray(x), g, kind), g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tdist.unplace(got, placement).numpy(), x)
    with pytest.raises(ValueError, match="unknown placement"):
        tdist.placement_tiles("skew_diag", g)


@pytest.mark.parametrize("g", [2, 3])
def test_unskew_matches(g):
    """The epilogue's un-skew of ``ring_a``'s C, gathered in the copy that
    untileizes it, is the JAX package's ``unskew_c_rows``."""
    x = _global(g, seed=5)
    np.testing.assert_array_equal(
        tdist.unplace(tdist.tileize(torch.from_numpy(x), g),
                      "skew_rows").numpy(),
        np.asarray(jdist.unskew_c_rows(jnp.asarray(x), g)))


@pytest.mark.parametrize("g", [2, 3])
def test_place_b_for_stationary_a_matches(g):
    """``ring_a``'s placement of B is the JAX package's
    ``place_b_for_stationary_a``."""
    x = _global(g, seed=7)
    got = tapi.DistDense(torch.from_numpy(x), g).placed("stationary_a")
    np.testing.assert_array_equal(
        got["dense"].numpy(),
        np.asarray(jdist.tileize(jdist.place_b_for_stationary_a(
            jnp.asarray(x), g), g)))


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_skew_bsr_matches(g, kind):
    """A sparse handle's skewed tree, and its counts placed alike, are the
    JAX package's ``skew_bsr``; the inverse index map restores the natural
    tiles."""
    a = tbsr.random_sparse(8 * g, 8 * g, 0.3, seed=g)
    t0 = tbsr.TiledBSR.from_dense(a, ProcessGrid(g, g), 4, capacity="bucket",
                                  device=CPU)
    placement = "skew_" + kind
    port = dict(tapi.DistBSR(t0).placed(placement),
                counts=tdist.place(t0.counts, placement))
    ref = jdist.skew_bsr(jbsr.TiledBSR.from_dense(
        a, jbsr.ProcessGrid(g, g), 4, capacity="bucket"), kind)
    for name in ("blocks", "rows", "cols", "counts"):
        np.testing.assert_array_equal(port[name].numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (t0.capacity, t0.shape, t0.logical_shape) == \
        (ref.capacity, ref.shape, ref.logical_shape)
    # gathering back by the inverse index map restores natural placement
    inv = torch.from_numpy(np.argsort(tdist.placement_index(placement, g)))
    blocks = port["blocks"]
    np.testing.assert_array_equal(
        blocks.reshape(g * g, *blocks.shape[2:])[inv].reshape(
            blocks.shape).numpy(), t0.blocks.numpy())
    with pytest.raises(ValueError, match="unknown placement"):
        tapi.DistBSR(t0).placed("skew_diag")


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("sign", [1, -1])
def test_ring_shift_is_the_ppermute_perm(g, axis, sign):
    """Through one ``shift_map``, position d along ``axis`` reads the tile
    position ``src`` held, for every (src, dst) pair of the JAX ring
    bodies' perm."""
    ex = StackedExecutor(g, CPU)
    # tile (i, j) carries the value 10*i + j in every element
    ids = (10 * torch.arange(g)[:, None] + torch.arange(g)[None, :])
    stack = ids[:, :, None, None].expand(g, g, 2, 3).contiguous()
    tile_map = ex.shift_map(ex.identity_map(), axis, sign)
    out = ex.unbatch(ex.batch(stack)[torch.from_numpy(tile_map)])
    perm = japi._ring_perm(g, sign)
    assert perm == [((d + sign) % g, d) for d in range(g)]
    for src, dst in perm:
        for other in range(g):
            i_dst, j_dst = (dst, other) if axis == "row" else (other, dst)
            i_src, j_src = (src, other) if axis == "row" else (other, src)
            want = 10 * i_src + j_src
            assert int(tile_map[i_dst * g + j_dst]) == i_src * g + j_src
            assert bool((out[i_dst, j_dst] == want).all())
    # g shifts in one direction go round the ring once
    back = ex.identity_map()
    for _ in range(g):
        back = ex.shift_map(back, axis, sign)
    np.testing.assert_array_equal(back, ex.identity_map())


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("sign", [1, -1])
def test_map_driven_ring_steps_read_the_rolled_tiles(g, sign):
    """A ring of tile-map compositions, composed with ``ring_c``'s
    placements (A skewed by rows on the col ring, B by columns on the row
    ring), reads from the natural stack, at every step and both ways, the
    tiles that rolling the placed grid (the JAX ppermute) holds there."""
    ex = StackedExecutor(g, CPU)
    ids = (10 * torch.arange(g)[:, None] + torch.arange(g)[None, :])
    stack = ids[:, :, None, None].expand(g, g, 2, 3).contiguous()
    for placement, axis in (("skew_rows", "col"), ("skew_cols", "row")):
        place = tdist.placement_index(placement, g)
        rolled = tdist.place(stack, placement)
        tile_map = ex.identity_map()
        for step in range(2 * g + 1):
            if step:
                tile_map = ex.shift_map(tile_map, axis, sign)
                rolled = torch.roll(rolled, -sign,
                                    dims=0 if axis == "row" else 1)
            read = ex.batch(stack)[torch.from_numpy(place[tile_map])]
            assert torch.equal(ex.unbatch(read), rolled)
        assert tile_map.dtype.kind == "i" and tile_map.shape == (g * g,)


def test_executor_batches_the_grid():
    ex = StackedExecutor(3, CPU)
    x = torch.arange(3 * 3 * 2 * 5).reshape(3, 3, 2, 5)
    b = ex.batch(x)
    assert tuple(b.shape) == (9, 2, 5)
    assert torch.equal(b[3 * 1 + 2], x[1, 2])
    assert torch.equal(ex.unbatch(b), x)
