"""The port's symbolic phase and pair-list builders against the JAX package's.

Everything here is host numpy on both sides (the port reads each operand's
block mask from its device once), so it runs in this process at any grid
size: ``match_block_pairs``, ``build_pair_lists``, ``extract_structure``
(fingerprint included), ``symbolic_spgemm`` with its statistics and
``scheduled_pairs`` must be bit-identical at g = 1, 2 and 3.
"""
import numpy as np
import pytest
import torch

from repro.core import bsr as jbsr
from repro.core import symbolic as jsym  # analysis: allow(source.import.repro.core.symbolic)
from repro.kernels import ops as jops
from repro_torch.core import bsr as tbsr
from repro_torch.core import symbolic as tsym
from repro_torch.core.grid import ProcessGrid
from repro_torch.kernels import ops as tops

CPU = torch.device("cpu")
GRIDS = [1, 2, 3]

# (name, A, B) dense operands: random, skewed (mass in one block-row and
# block-column), one operand empty, and a block-dense product
_R = lambda m, n, d, seed: tbsr.random_sparse(m, n, d, seed=seed)


def _operands(name: str):
    if name == "random":
        return _R(40, 36, 0.08, 1), _R(36, 44, 0.1, 2)
    if name == "skewed":
        a = _R(48, 48, 0.02, 3)
        a[:6] += _R(6, 48, 0.6, 4)
        a[:, :5] += _R(48, 5, 0.6, 5)
        return a, a.T.copy()
    if name == "empty":
        return np.zeros((24, 24), np.float32), _R(24, 24, 0.2, 6)
    if name == "dense":
        return _R(24, 24, 0.9, 7), _R(24, 24, 0.9, 8)
    raise ValueError(name)


KINDS = ["random", "skewed", "empty", "dense"]


def _pair(name: str, g: int, bs: int = 4, capacity="bucket"):
    a, b = _operands(name)
    tt = [tbsr.TiledBSR.from_dense(x, ProcessGrid(g, g), bs,
                                   capacity=capacity, device=CPU)
          for x in (a, b)]
    jt = [jbsr.TiledBSR.from_dense(x, jbsr.ProcessGrid(g, g), bs,
                                   capacity=capacity) for x in (a, b)]
    return tt, jt


def _assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", range(4))
def test_match_block_pairs_bit_identical(seed):
    rng = np.random.default_rng(seed)
    a_cols = rng.integers(0, 6, 30)
    b_rows = rng.integers(0, 6, 25)
    for got, want in zip(tops.match_block_pairs(a_cols, b_rows),
                         jops.match_block_pairs(a_cols, b_rows)):
        _assert_same(got, want, "match_block_pairs")
    # empty sides
    for got, want in zip(tops.match_block_pairs([], b_rows),
                         jops.match_block_pairs([], b_rows)):
        _assert_same(got, want, "empty A")


@pytest.mark.parametrize("capacity", [None, 400])
@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
def test_build_pair_lists_bit_identical(density, capacity):
    a_d = tbsr.random_sparse(32, 24, density, seed=9)
    b_d = tbsr.random_sparse(24, 40, density, seed=10)
    a_t, b_t = (tbsr.BSR.from_dense(x, 8, device=CPU) for x in (a_d, b_d))
    a_j, b_j = (jbsr.BSR.from_dense(x, 8) for x in (a_d, b_d))
    got = tops.build_pair_lists(a_t.rows, a_t.cols, a_t.nnzb, b_t.rows,
                                b_t.cols, b_t.nnzb, 4, 5, capacity=capacity)
    want = jops.build_pair_lists(a_j.rows, a_j.cols, a_j.nnzb, b_j.rows,
                                 b_j.cols, b_j.nnzb, 4, 5, capacity=capacity)
    for i, (x, y) in enumerate(zip(got[:4], want[:4])):
        _assert_same(x, y, f"list {i}")
    assert got[4] == want[4]
    with pytest.raises(ValueError, match="pair capacity 1 < required"):
        tops.build_pair_lists(a_t.rows, a_t.cols, a_t.nnzb, b_t.rows,
                              b_t.cols, b_t.nnzb, 4, 5, capacity=1)


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_extract_structure_bit_identical(kind, g):
    (ta, tb), (ja, jb) = _pair(kind, g)
    for t, j in ((ta, ja), (tb, jb)):
        got, want = tsym.extract_structure(t), jsym.extract_structure(j)
        for f in ("rows", "cols", "real", "zero_slot"):
            _assert_same(getattr(got, f), getattr(want, f), f)
        for f in ("grid_shape", "block_size", "shape", "tile_nbr",
                  "tile_nbc", "fingerprint"):
            assert getattr(got, f) == getattr(want, f), f
        assert tsym.structure_fingerprint(t) == want.fingerprint


def test_extract_structure_reads_nan_and_negative_zero_as_jax_does():
    a = _R(16, 16, 0.3, 11)
    a[0, 0], a[5, 9] = np.nan, -0.0
    a[8:12, 8:12] = -0.0
    t = tbsr.TiledBSR.from_dense(a, ProcessGrid(2, 2), 4, device=CPU)
    j = jbsr.TiledBSR.from_dense(a, jbsr.ProcessGrid(2, 2), 4)
    _assert_same(tsym.extract_structure(t).real,
                 jsym.extract_structure(j).real, "real")
    assert tsym.extract_structure(t).fingerprint == \
        jsym.extract_structure(j).fingerprint


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_symbolic_spgemm_bit_identical(kind, g):
    (ta, tb), (ja, jb) = _pair(kind, g)
    got, want = tsym.symbolic_spgemm(ta, tb), jsym.symbolic_spgemm(ja, jb)
    for f in ("c_rows", "c_cols", "c_real", "c_counts", "pair_a", "pair_b",
              "pair_slot", "n_real_pairs"):
        _assert_same(getattr(got, f), getattr(want, f), f)
    for f in ("g", "block_size", "tile_nbr", "tile_nbc", "shape", "capacity",
              "a_fingerprint", "b_fingerprint", "store_capacity",
              "pair_capacity"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.density() == want.density()
    assert got.flops() == want.flops()
    assert got.output_bytes() == want.output_bytes()
    assert got.total_real_pairs() == want.total_real_pairs()
    _assert_same(got.block_mask(), want.block_mask(), "block_mask")
    assert tsym.predicted_density(ta, tb) == jsym.predicted_density(ja, jb)
    for k_order in (lambda i, j, t, g: (i + j + t) % g,
                    lambda i, j, t, g: t + 0 * (i + j)):
        s_got, s_want = got.scheduled_pairs(k_order), \
            want.scheduled_pairs(k_order)
        for k in ("pa", "pb", "ps"):
            _assert_same(s_got[k], s_want[k], k)


@pytest.mark.parametrize("g", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_pair_real_marks_the_pairs_of_nonzero_blocks(kind, g):
    """The derived real-pair mask (both operands' zero slots = inert) marks
    exactly the pairs of the JAX package's lists whose two blocks hold
    data, counts ``n_real_pairs``, and is scheduled like the lists."""
    (ta, tb), (ja, jb) = _pair(kind, g)
    got, want = tsym.symbolic_spgemm(ta, tb), jsym.symbolic_spgemm(ja, jb)
    real = got.pair_real()
    assert real.dtype == bool and real.shape == want.pair_a.shape
    np.testing.assert_array_equal(real.sum(axis=3), want.n_real_pairs)
    nz = [np.abs(np.asarray(x.blocks, np.float32)).reshape(
        g, g, x.blocks.shape[2], -1).sum(-1) != 0 for x in (ja, jb)]
    for i in range(g):
        for j in range(g):
            for k in range(g):
                data = nz[0][i, k][want.pair_a[i, j, k]] \
                    & nz[1][k, j][want.pair_b[i, j, k]]
                np.testing.assert_array_equal(real[i, j, k], data)
    k_order = lambda i, j, t, g_: (i + j + t) % g_
    sched = got.scheduled_pairs(k_order)
    i, j, t = np.ogrid[:g, :g, :g]
    np.testing.assert_array_equal(sched["real"], real[i, j, (i + j + t) % g])


@pytest.mark.parametrize("g", [1, 2])
def test_symbolic_spgemm_pinned_capacity(g):
    (ta, tb), (ja, jb) = _pair("random", g)
    cap = 2 * int(jsym.symbolic_spgemm(ja, jb).c_counts.max())
    want = jsym.symbolic_spgemm(ja, jb, capacity=cap)
    got = tsym.symbolic_spgemm(ta, tb, capacity=cap)
    assert got.capacity == want.capacity == cap
    _assert_same(got.pair_slot, want.pair_slot, "pair_slot")
    with pytest.raises(ValueError) as e_got:
        tsym.symbolic_spgemm(ta, tb, capacity=1)
    with pytest.raises(ValueError) as e_want:
        jsym.symbolic_spgemm(ja, jb, capacity=1)
    assert str(e_got.value) == str(e_want.value)


def test_symbolic_validates_operands_as_jax_does():
    a = _R(16, 16, 0.3, 12)
    cases = [
        # block sizes disagree
        (dict(g=(1, 1), bs=(4, 8), shape=(16, 16))),
        # grids disagree
        (dict(g=(1, 2), bs=(4, 4), shape=(16, 16))),
        # inner dimensions disagree
        (dict(g=(1, 1), bs=(4, 4), shape=(16, 12))),
    ]
    for case in cases:
        b = _R(*case["shape"], 0.3, 13)
        t = [tbsr.TiledBSR.from_dense(x, ProcessGrid(gg, gg), bs, device=CPU)
             for x, gg, bs in zip((a, b.T.copy()), case["g"], case["bs"])]
        j = [jbsr.TiledBSR.from_dense(x, jbsr.ProcessGrid(gg, gg), bs)
             for x, gg, bs in zip((a, b.T.copy()), case["g"], case["bs"])]
        with pytest.raises(ValueError) as e_got:
            tsym.symbolic_spgemm(*t)
        with pytest.raises(ValueError) as e_want:
            jsym.symbolic_spgemm(*j)
        assert str(e_got.value) == str(e_want.value)
