"""The port's plan API (``repro_torch.core.api``) against the JAX package's.

Parity: ``matmul(algorithm="ring_c")`` on SpMM, dense-output SpGEMM and
dense x dense, with overlap on and off and with balanced left operands,
against ``repro.core.api.matmul(algorithm="ring_c", impl="ref")`` on the
same numpy inputs.  g = 1 runs in this process; g = 2 and 3 need one JAX
device per tile, so their JAX results come from one child process
(``torch_jax_child.py``) started with 9 host devices.  Float32 sums of a
few dozen products taken in other orders: tolerance 1e-5.

Besides: plan-cache and placement reuse, the operand validation of
``_coerce_pair`` (same messages as the JAX package), the refusals of what
this slice does not have, and the default device.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import dist as jdist
from repro.runtime.platform import subprocess_env
from repro_torch.core import api as tapi
from repro_torch.core.api import DistBSR, DistDense, matmul, plan_matmul
from repro_torch.core.bsr import TiledBSR, random_sparse
from repro_torch.core.grid import ProcessGrid
from repro_torch.core.interop import tiled_from_arrays

import torch_jax_child as child

CPU = torch.device("cpu")
TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {name: (kind, balance, overlap)
         for name, kind, balance, overlap in child.CASES}


def port_result(kind: str, balance: str, overlap: str, g: int,
                ops: dict) -> np.ndarray:
    kw = dict(algorithm="ring_c", overlap=overlap)
    if kind == "dense":
        return matmul(ops["x"], ops["y"], g=g, device=CPU, **kw).numpy()
    a_h = DistBSR.from_dense(ops["a"], g=g, block_size=child.BLOCK,
                             balance=balance, device=CPU)
    if kind == "spmm":
        b_h = DistDense.for_rhs(ops["b"], a_h)
    else:
        b_h = DistBSR.from_dense(ops["s"], g=g, block_size=child.BLOCK,
                                 device=CPU)
    return matmul(a_h, b_h, **kw).numpy()


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    """JAX results at g = 2 and 3, from one child process."""
    out = tmp_path_factory.mktemp("jax_child") / "ring_c.npz"
    env = subprocess_env(9, overlap=False)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(child.__file__)), str(out), "2",
         "3"], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ops():
    return child.inputs()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_ring_c_parity_g1_in_process(case, ops):
    kind, balance, overlap = CASES[case]
    got = port_result(kind, balance, overlap, 1, ops)
    want = child.jax_result(kind, balance, overlap, 1, ops)
    assert got.shape == want.shape == child.oracle(kind, ops).shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, child.oracle(kind, ops), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_ring_c_parity_multi_tile(case, g, ops, jax_multi):
    kind, balance, overlap = CASES[case]
    got = port_result(kind, balance, overlap, g, ops)
    want = jax_multi[f"{case}/g{g}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, child.oracle(kind, ops), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("g", [2, 3])
def test_balanced_cases_carry_permutations(g, ops):
    """The balanced parity cases do run the un-balance epilogue and the
    right-operand compensation, not the identity layout."""
    rows = DistBSR.from_dense(ops["a"], g=g, block_size=4, balance="rows",
                              device=CPU)
    cols = DistBSR.from_dense(ops["a"], g=g, block_size=4, balance="cols",
                              device=CPU)
    assert rows.row_block_perm is not None
    assert cols.col_block_perm is not None
    s = DistBSR.from_dense(ops["s"], g=g, block_size=4, device=CPU)
    _, b_c = tapi._coerce_pair(cols, s)
    assert b_c is not s and b_c._compensated_for == cols.col_block_perm
    # re-coercion reuses the compensated handle
    assert tapi._coerce_pair(cols, s)[1] is b_c
    assert tapi._coerce_pair(cols, b_c)[1] is b_c


@pytest.mark.parametrize("g", [2, 3])
def test_interop_tiled_feeds_the_port(g, ops, jax_multi):
    """The JAX TiledBSR, handed over as numpy arrays, multiplies to the JAX
    result in the port."""
    meta = jax_multi[f"tiled-meta/g{g}"].tolist()
    tiled = tiled_from_arrays(
        *(jax_multi[f"tiled-{f}/g{g}"] for f in ("blocks", "rows", "cols",
                                                  "counts")),
        shape=tuple(meta[:2]), block_size=child.BLOCK, grid_shape=(g, g),
        capacity=meta[4], logical_shape=tuple(meta[2:4]), device=CPU)
    got = matmul(tiled, ops["b"], overlap="off").numpy()
    np.testing.assert_allclose(got, jax_multi[f"spmm-none-off/g{g}"],
                               rtol=TOL, atol=TOL)


def test_bf16_spmm_parity_g1(ops):
    a_j = japi.DistBSR.from_dense(ops["a"], g=1, block_size=4,
                                  dtype=jnp.bfloat16)
    want = japi.matmul(a_j, jnp.asarray(ops["b"], jnp.bfloat16),
                       algorithm="ring_c", impl="ref")
    a_t = DistBSR.from_dense(ops["a"], g=1, block_size=4,
                             dtype=torch.bfloat16, device=CPU)
    got = matmul(a_t, torch.from_numpy(ops["b"]).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_densify_and_from_tiled_rebalance_match(ops):
    a_j = japi.DistBSR.from_tiled(
        japi.DistBSR.from_dense(ops["a"], g=2, block_size=4).tiled,
        balance="rows", capacity=None)
    a_t = DistBSR.from_tiled(
        DistBSR.from_dense(ops["a"], g=2, block_size=4, device=CPU).tiled,
        balance="rows", capacity=None)
    assert a_t.row_block_perm == a_j.row_block_perm is not None
    assert a_t.capacity == a_j.capacity
    np.testing.assert_array_equal(a_t.tiled.rows.numpy(),
                                  np.asarray(a_j.tiled.rows))
    np.testing.assert_array_equal(a_t.densify().numpy(), ops["a"])
    with pytest.raises(ValueError, match="capacity can only be changed"):
        DistBSR.from_tiled(a_t.tiled, capacity=None)
    with pytest.raises(ValueError, match="unknown balance"):
        DistBSR.from_tiled(a_t.tiled, balance="diag")


# ---------------------------------------------------------------------------
# plan cache and placement reuse
# ---------------------------------------------------------------------------
@pytest.fixture
def handles():
    a_d = random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=2, block_size=4, device=CPU)
    return a_d, b, a_h, DistDense.for_rhs(b, a_h)


def test_plan_cache_reuses_plans(handles):
    a_d, b, a_h, b_h = handles
    tapi.clear_plan_cache()
    tapi.cache_stats(reset=True)
    p1 = plan_matmul(a_h, b_h)
    p2 = plan_matmul(a_h, b_h)
    assert p1 is p2 and tapi.plan_cache_size() == 1
    assert p1.kind == "spmm" and p1.output == "dense" and p1.wire == "padded"
    stats = tapi.cache_stats(reset=True)["plans"]
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 1, 1)
    assert tapi.cache_stats()["plans"]["hits"] == 0
    # another overlap mode or impl is another plan
    assert plan_matmul(a_h, b_h, overlap="off") is not p1
    assert plan_matmul(a_h, b_h, impl="ref") is not p1
    assert plan_matmul(a_h, b_h, overlap="off").geom.overlap is False
    # auto resolves to the bulk body on the single-stream executor
    assert p1.geom.overlap is False and p1.overlap == "auto"
    assert p1.geom == plan_matmul(a_h, b_h, overlap="off").geom
    assert plan_matmul(a_h, b_h, overlap="on").geom.overlap is True
    assert tapi.plan_cache_size() == 4
    # an uncached plan is fresh and not stored
    assert plan_matmul(a_h, b_h, cache=False) is not p1
    assert tapi.plan_cache_size() == 4
    # matmul goes through the cache and a plan is reusable on new values
    matmul(a_h, b_h)
    assert tapi.plan_cache_size() == 4
    b2 = DistDense.for_rhs(2 * b, a_h)
    np.testing.assert_allclose(p1(a_h, b2).numpy(), 2 * (a_d @ b),
                               rtol=TOL, atol=TOL)
    tapi.clear_plan_cache()
    assert tapi.plan_cache_size() == 0


def test_plan_cache_is_bounded(handles, monkeypatch):
    _, _, a_h, b_h = handles
    monkeypatch.setattr(tapi, "_PLAN_CACHE", tapi._LRUCache(2))
    for overlap in ("auto", "on", "off"):
        plan_matmul(a_h, b_h, overlap=overlap)
    stats = tapi.cache_stats()["plans"]
    assert (stats["size"], stats["maxsize"], stats["evictions"]) == (2, 2, 1)


def test_placements_are_materialised_once(handles):
    _, _, a_h, b_h = handles
    assert a_h.placements() == ()
    matmul(a_h, b_h)
    assert a_h.placements() == (tapi.SKEW_ROWS,)
    assert b_h.placements() == (tapi.SKEW_COLS,)
    tree = a_h.placed(tapi.SKEW_ROWS)
    matmul(a_h, b_h, overlap="off")
    assert a_h.placed(tapi.SKEW_ROWS) is tree
    assert a_h.placements() == (tapi.SKEW_ROWS,)


@pytest.mark.parametrize("placement", tapi.PLACEMENTS)
def test_placements_match_jax(placement, ops):
    a_j = japi.DistBSR.from_dense(ops["a"], g=3, block_size=4)
    a_t = DistBSR.from_dense(ops["a"], g=3, block_size=4, device=CPU)
    for name in ("blocks", "rows", "cols"):
        np.testing.assert_array_equal(
            a_t.placed(placement)[name].numpy(),
            np.asarray(a_j.placed(placement)[name]))
    d_j = japi.DistDense.from_global(jnp.asarray(ops["b"][:39]), 3)
    d_t = DistDense.from_global(ops["b"][:39], 3, device=CPU)
    # the JAX handle keeps the placed global matrix, the port its tile grid
    np.testing.assert_array_equal(
        d_t.placed(placement)["dense"].numpy(),
        np.asarray(jdist.tileize(d_j.placed(placement)["dense"], 3)))
    with pytest.raises(ValueError, match="unknown placement"):
        a_t.placed("diagonal")


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_ring_shifts_each_operand_g_minus_1_times(g, overlap, monkeypatch):
    """No shift is made whose tiles no step consumes: g - 1 per operand and
    one local multiply per step, in either body."""
    calls = []
    shift = tapi.StackedExecutor.shift
    monkeypatch.setattr(tapi.StackedExecutor, "shift",
                        lambda self, tree, axis, sign=1: calls.append(axis)
                        or shift(self, tree, axis, sign))
    local_mm = tapi._local_mm
    steps = []
    monkeypatch.setattr(tapi, "_local_mm", lambda *args: steps.append(1)
                        or local_mm(*args))
    a_d = random_sparse(24, 24, 0.3, seed=g)
    b = np.random.default_rng(g).standard_normal((24, 5)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    got = matmul(a_h, b, overlap=overlap).numpy()
    assert sorted(calls) == ["col"] * (g - 1) + ["row"] * (g - 1)
    assert len(steps) == g
    np.testing.assert_allclose(got, a_d @ b, rtol=TOL, atol=TOL)


def test_plan_refuses_other_shapes(handles):
    _, b, a_h, b_h = handles
    plan = plan_matmul(a_h, b_h)
    other = DistBSR.from_dense(random_sparse(24, 16, 0.3, seed=1), g=2,
                               block_size=4, device=CPU)
    with pytest.raises(ValueError, match="do not match this plan"):
        plan(other, DistDense.for_rhs(b, other))


# ---------------------------------------------------------------------------
# validation: the same messages as the JAX package
# ---------------------------------------------------------------------------
def _both(fn_port, fn_jax):
    with pytest.raises(Exception) as got:
        fn_port()
    with pytest.raises(Exception) as want:
        fn_jax()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    return got.value


def test_coerce_pair_errors_match_jax():
    a_d = random_sparse(16, 14, 0.3, seed=0)
    b = np.ones((14, 8), np.float32)
    x = np.ones((10, 7), np.float32)
    jt = lambda d, g, **kw: japi.DistBSR.from_dense(d, g=g, block_size=4,
                                                    **kw)
    tt = lambda d, g, **kw: DistBSR.from_dense(d, g=g, block_size=4,
                                               device=CPU, **kw)
    skew = child.inputs()["a"]
    cases = [
        # dense left operand without g
        (lambda: tapi._coerce_pair(x, x.T),
         lambda: japi._coerce_pair(x, x.T)),
        # handle on another grid than g
        (lambda: tapi._coerce_pair(tt(a_d, 2), b, g=1),
         lambda: japi._coerce_pair(jt(a_d, 2), b, g=1)),
        # right operand carrying a row balance
        (lambda: tapi._coerce_pair(tt(skew, 2), tt(skew.T.copy(), 2,
                                                   balance="rows")),
         lambda: japi._coerce_pair(jt(skew, 2), jt(skew.T.copy(), 2,
                                                   balance="rows"))),
        # dense x sparse
        (lambda: tapi._coerce_pair(
            DistDense.from_global(np.ones((16, 16), np.float32), 2,
                                  device=CPU), tt(a_d, 2)),
         lambda: japi._coerce_pair(
             japi.DistDense.from_global(np.ones((16, 16), np.float32), 2),
             jt(a_d, 2))),
        # operands on different grids
        (lambda: tapi._coerce_pair(tt(a_d, 1), tt(b, 2)),
         lambda: japi._coerce_pair(jt(a_d, 1), jt(b, 2))),
        # padded inner dimensions disagree
        (lambda: tapi._coerce_pair(
            tt(a_d, 2), DistDense.from_global(np.ones((12, 8), np.float32),
                                              2, device=CPU)),
         lambda: japi._coerce_pair(
             jt(a_d, 2), japi.DistDense.from_global(
                 np.ones((12, 8), np.float32), 2))),
        # right operand too tall / neither logical nor padded K
        (lambda: tapi._coerce_pair(tt(a_d, 2), np.ones((20, 3), np.float32)),
         lambda: japi._coerce_pair(jt(a_d, 2), np.ones((20, 3), np.float32))),
        (lambda: tapi._coerce_pair(tt(a_d, 2), np.ones((13, 3), np.float32)),
         lambda: japi._coerce_pair(jt(a_d, 2), np.ones((13, 3), np.float32))),
        # bad padding request
        (lambda: DistDense.from_global(x, 2, rows_pad=9, device=CPU),
         lambda: japi.DistDense.from_global(x, 2, rows_pad=9)),
    ]
    for fn_port, fn_jax in cases:
        _both(fn_port, fn_jax)
    # allow_pad pads the short right operand instead
    a_h, b_h = tapi._coerce_pair(tt(a_d, 2), np.ones((13, 3), np.float32),
                                 allow_pad=True)
    assert b_h.shape == (16, 4) and b_h.logical_shape == (13, 3)


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="auto"), "algorithm='auto' is not in the port yet"),
    (dict(algorithm="summa_ag"), "does not have algorithm 'summa_ag' yet"),
    (dict(algorithm="steal3d"), "does not have algorithm 'steal3d' yet"),
    (dict(algorithm="bogus"), "unknown algorithm 'bogus'"),
    (dict(output="sparse"), "does not have output='sparse' yet"),
    (dict(output="auto"), "does not have output='auto' yet"),
    (dict(output="csr"), "unknown output 'csr'"),
    (dict(wire="packed"), "does not have wire='packed' yet"),
    (dict(wire="wide"), "unknown wire 'wide'"),
    (dict(overlap="maybe"), "unknown overlap 'maybe'"),
    (dict(impl="pallas"), "unknown impl 'pallas'"),
])
def test_refuses_what_the_slice_lacks(handles, kw, match):
    _, _, a_h, b_h = handles
    for fn in (matmul, plan_matmul):
        with pytest.raises(ValueError, match=match):
            fn(a_h, b_h, **kw)


def test_padded_wire_and_algorithms():
    assert tapi.algorithms() == ("ring_c",)
    a_d = random_sparse(16, 16, 0.3, seed=0)
    a_h = DistBSR.from_dense(a_d, g=1, block_size=4, device=CPU)
    b = np.ones((16, 2), np.float32)
    np.testing.assert_allclose(matmul(a_h, b, wire="padded").numpy(),
                               a_d @ b, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="square process grid"):
        DistBSR(TiledBSR.from_dense(a_d, ProcessGrid(1, 2), 4, device=CPU))


# ---------------------------------------------------------------------------
# the default device
# ---------------------------------------------------------------------------
def test_entry_points_default_to_the_card():
    a_d = random_sparse(16, 16, 0.3, seed=0)
    x = np.ones((8, 8), np.float32)
    if torch.cuda.is_available():
        assert DistBSR.from_dense(a_d, g=2, block_size=4).device.type == \
            "cuda"
        assert DistDense.from_global(x, 2).device.type == "cuda"
        return
    for build in (lambda: DistBSR.from_dense(a_d, g=2, block_size=4),
                  lambda: DistDense.from_global(x, 2),
                  lambda: matmul(x, x, g=2),
                  lambda: plan_matmul(x, x, g=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistDense.from_global(x, 2, device="cuda")
