"""The port's packed wire layout against the JAX package's.

Host numpy on both sides, in this process at g = 1, 2 and 3:
``wire_capacity``, ``pack_operand``, the placement and ring-step tile maps,
``schedule_consume``, ``schedule_dense_map``, ``remap_pairs_packed`` and
the byte helpers must be bit-identical; the packed blocks a handle ships
(``DistBSR.packed_wire``) and ``ops.densify_packed`` must equal the JAX
package's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import symbolic as jsym  # analysis: allow(source.import.repro.core.symbolic)
from repro.core import wire as jwire  # analysis: allow(source.import.repro.core.wire)
from repro.kernels import ops as jops
from repro_torch.core import api as tapi
from repro_torch.core import symbolic as tsym
from repro_torch.core import wire as twire
from repro_torch.kernels import ops as tops

import test_torch_symbolic as ts

CPU = torch.device("cpu")
PLACEMENTS = ("natural", "skew_rows", "skew_cols", "stationary_a")
TILE_MAPS = ("tiles_ring_c", "tiles_ring_c_bwd", "tiles_ring_c_b",
             "tiles_ring_a_b", "tiles_summa_a", "tiles_summa_b")


def _packed(kind: str, g: int):
    (ta, tb), (ja, jb) = ts._pair(kind, g)
    return ((twire.pack_operand(tsym.extract_structure(ta)),
             twire.pack_operand(tsym.extract_structure(tb))),
            (jwire.pack_operand(jsym.extract_structure(ja)),
             jwire.pack_operand(jsym.extract_structure(jb))),
            (ta, tb), (ja, jb))


def test_wire_capacity_and_bytes_bit_identical():
    for max_real in (0, 1, 5, 17, 100):
        for store in (None, 3, 20, 1000):
            assert twire.wire_capacity(max_real, store) == \
                jwire.wire_capacity(max_real, store)
    assert twire.packed_block_bytes(9, 4, 2) == jwire.packed_block_bytes(9, 4,
                                                                         2)
    assert twire.padded_tile_bytes(9, 4, 4) == jwire.padded_tile_bytes(9, 4,
                                                                       4)


@pytest.mark.parametrize("g", ts.GRIDS)
def test_tile_maps_bit_identical(g):
    for p in PLACEMENTS:
        ts._assert_same(twire.placement_tiles(p, g),
                        jwire.placement_tiles(p, g), p)
    for name in TILE_MAPS:
        ts._assert_same(getattr(twire, name)(g), getattr(jwire, name)(g),
                        name)
    with pytest.raises(ValueError, match="unknown placement"):
        twire.placement_tiles("diagonal", g)


@pytest.mark.parametrize("g", ts.GRIDS)
@pytest.mark.parametrize("kind", ts.KINDS)
def test_pack_operand_and_schedules_bit_identical(kind, g):
    (t_pos, j_pos, _, (ja, jb)) = _packed(kind, g)
    for t_po, j_po in zip(t_pos, j_pos):
        for f in ("pack_idx", "gidx", "rows", "cols", "dmap", "slot_map",
                  "n_real"):
            ts._assert_same(getattr(t_po, f), getattr(j_po, f), f)
        for f in ("wire_capacity", "aug_capacity", "tile_nbr", "tile_nbc",
                  "fingerprint", "zero_slot"):
            assert getattr(t_po, f) == getattr(j_po, f), f
        for name in TILE_MAPS:
            tiles = getattr(jwire, name)(g)
            bases = np.arange(g * g * g).reshape(g, g, g) * 3
            for b in (None, bases):
                got = twire.schedule_consume(t_po, tiles, b)
                want = jwire.schedule_consume(j_po, tiles, b)
                for k in ("gidx", "rows", "cols"):
                    ts._assert_same(got[k], want[k], f"{name} {k}")
                ts._assert_same(twire.schedule_dense_map(t_po, tiles, b),
                                jwire.schedule_dense_map(j_po, tiles, b),
                                f"{name} dmap")
    sym = jsym.symbolic_spgemm(ja, jb)
    for arr, po_t, po_j, side in ((sym.pair_a, t_pos[0], j_pos[0], "a"),
                                  (sym.pair_b, t_pos[1], j_pos[1], "b")):
        ts._assert_same(twire.remap_pairs_packed(arr, po_t, side),
                        jwire.remap_pairs_packed(arr, po_j, side),
                        f"remap {side}")
    with pytest.raises(ValueError, match="tiles_of_k must be"):
        twire.remap_pairs_packed(sym.pair_a, t_pos[0], "c")


@pytest.mark.parametrize("g", ts.GRIDS)
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_packed_wire_blocks_match_jax(placement, g):
    a = ts._operands("skewed")[0]
    a_t = tapi.DistBSR.from_dense(a, g=g, block_size=4, device=CPU)
    a_j = japi.DistBSR.from_dense(a, g=g, block_size=4)
    got = a_t.packed_wire(placement)["blocks"]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(a_j.packed_wire(placement)["blocks"]))
    assert a_t.packed_wire(placement)["blocks"] is got      # cached
    assert a_t.structure_key() == a_j.structure_key()
    assert a_t.packed_operand() is a_t.packed_operand()
    assert a_t.footprint_bytes() == a_j.footprint_bytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_packed_matches_jax(dtype):
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((7, 4, 4)).astype(np.float32)
    blocks[-1] = 0
    dmap = rng.integers(0, 7, 12).astype(np.int32)
    b_t = torch.from_numpy(blocks).to(getattr(torch, dtype))
    got = tops.densify_packed(b_t, torch.from_numpy(dmap), n_block_rows=3,
                              n_block_cols=4)
    want = jops.densify_packed(jnp.asarray(blocks, getattr(jnp, dtype)),
                               jnp.asarray(dmap), n_block_rows=3,
                               n_block_cols=4)
    assert got.dtype == b_t.dtype and tuple(got.shape) == (12, 16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # batched: each tile densifies on its own
    two = tops.densify_packed(b_t.expand(2, -1, -1, -1),
                              torch.from_numpy(dmap).expand(2, -1),
                              n_block_rows=3, n_block_cols=4)
    np.testing.assert_array_equal(two[1].float().numpy(),
                                  got.float().numpy())
