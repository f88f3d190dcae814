"""The process-group executor: the schedules on real ranks, one tile each.

``repro_torch.launch.grid.run_grid`` starts g² ranks (gloo, on the CPU) at
g = 2 (4 processes) and g = 3 (9); each grid is spawned once for the
module and runs every case of ``torch_jax_child`` inside
(``torch_grid_ranks.grid_cases``): the six schedules on SpMM,
dense-output SpGEMM and dense x dense, overlap on and off, balanced rows
and cols; the packed wire; sparse outputs through ring_c and both SUMMAs,
the cube chained on the grid; steal3d.  Every result is held against the
JAX package's at the reference's 1e-5, from one JAX child process started
at the top of the module (it runs while the ranks do); a sparse result's
structure must be bit-identical.

Besides:

* every shift's peers are ``_ring_perm(g, sign)``'s pairs (position d
  receives from d + sign), read off the tiles the exchange delivered;
* ``summa_ag`` holds the g-tile gathered pool at every launch,
  ``summa_bcast`` one tile;
* the bytes each rank sends in a multiply's body are a stated function of
  ``plan.cost_model()["net_bytes_per_step"]`` (:func:`expected_body_bytes`);
* a plan on the grid and a stacked plan of the same operands never share
  a cache entry;
* a rank that raises fails ``run_grid`` with its traceback, and a grid
  past its deadline is killed;
* ``make_grid_mesh(backend="nccl")`` with more ranks than cards raises
  before any process group exists (where CUDA is present).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.runtime.platform import subprocess_env
from repro_torch.core.dist import check_layout, make_grid_mesh
from repro_torch.launch.grid import GridError, run_grid

import torch_grid_ranks as ranks
import torch_jax_child as child

TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
# a grid that has not finished by then has hung; each finishes in ~10 s
GRID_DEADLINE_S = 240
CASES = [c[0] for c in child.CASES]
SPARSE_CASES = [c[0] for c in child.SPARSE_CASES]
ALGS = {c[0]: c[1] for c in child.CASES + child.SPARSE_CASES}


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX child, started at once so that it runs while the grids do."""
    out = tmp_path_factory.mktemp("jax_child") / "grid.npz"
    env = subprocess_env(9, overlap=False)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(child.__file__)), str(out), "2",
         "3"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def grids(jax_proc):
    """Every rank's results at g = 2 and 3 (gloo ranks on the CPU)."""
    return {g: run_grid(g, ranks.grid_cases, backend="gloo", device="cpu",
                        timeout_s=GRID_DEADLINE_S) for g in (2, 3)}


@pytest.fixture(scope="module")
def jax_multi(jax_proc):
    proc, out = jax_proc
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ops():
    return child.inputs()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_dense_output_parity(case, g, grids, jax_multi, ops):
    """Every schedule's dense output on the grid, overlap on and off,
    balanced rows and cols: the JAX package's within 1e-5."""
    kind = next(c[2] for c in child.CASES if c[0] == case)
    got = grids[g][0]["dense"][case]
    want = jax_multi[f"{case}/g{g}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, child.oracle(kind, ops), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_and_packed_parity(case, g, grids, jax_multi, ops):
    """Sparse outputs (structure bit-identical, blocks within 1e-5), the
    cube chained on the grid, and the packed wire's dense outputs."""
    kind = next(c[2] for c in child.SPARSE_CASES if c[0] == case)
    got = grids[g][0]["sparse"][case]
    prefix = f"{case}/g{g}/"
    want = {k[len(prefix):]: v for k, v in jax_multi.items()
            if k.startswith(prefix)}
    assert set(got) == set(want)
    if "dense" in want:
        value = got["dense"]
        np.testing.assert_allclose(value, want["dense"], rtol=TOL, atol=TOL)
    else:
        for field in ("rows", "cols", "counts", "meta"):
            assert got[field].dtype == want[field].dtype, field
            np.testing.assert_array_equal(got[field], want[field],
                                          err_msg=field)
        np.testing.assert_allclose(got["blocks"], want["blocks"], rtol=TOL,
                                   atol=TOL)
        value = got["dense_value"]
    np.testing.assert_allclose(value, child.sparse_oracle(kind, ops),
                               rtol=10 * TOL, atol=10 * TOL)


@pytest.mark.parametrize("g", [2, 3])
def test_sparse_outputs_stay_on_the_grid(g, grids):
    """A sparse-output multiply on the grid returns a handle whose tiles
    stay on their ranks (the chained cube's first product among them); a
    dense one (``output="auto"`` above its threshold, the packed wire's
    dense outputs) the rank's tile."""
    sparse = {case: "dense" not in got
              for case, got in grids[g][0]["sparse"].items()}
    assert sum(sparse.values()) >= 10
    for rank in grids[g]:
        assert rank["on_grid"] == sparse


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g", [2, 3])
def test_shift_peers_are_the_ring_permutation(g, grids):
    """Per axis and direction, the (source, destination) positions of the
    tiles a shift delivered, over a grid row or column, are
    ``_ring_perm(g, sign)``'s pairs."""
    for axis in ("row", "col"):
        for sign in (1, -1):
            lines = {}
            for rank in grids[g]:
                r, c = divmod(rank["rank"], g)
                line = c if axis == "row" else r
                lines.setdefault(line, set()).add(
                    rank["peers"][(axis, sign)])
            for pairs in lines.values():
                assert pairs == set(japi._ring_perm(g, sign)), (axis, sign)


@pytest.mark.parametrize("g", [2, 3])
def test_summa_ag_holds_the_gathered_pool(g, grids):
    """``summa_ag`` reads the g-tile pool it gathered at each of its g
    launches; ``summa_bcast`` holds one broadcast tile at a time."""
    for rank in grids[g]:
        for wire in ("padded", "packed"):
            assert rank["pools"][("summa_ag", wire)] == [g] * g
            assert rank["pools"][("summa_bcast", wire)] == [1] * g


def expected_body_bytes(alg: str, sent: dict, g: int) -> float:
    """What a rank sends in one multiply's body, from the cost dict.

    ``net_bytes_per_step`` counts, per device and inner step, the tiles
    the schedule's ``wire`` names (an all-gather's ``(g - 1) / g`` of
    them).  The rings make g - 1 shifts per operand where the cost dict
    counts g (the port's shift divergence: the JAX bodies also ship the
    tiles after the last step, which nothing reads); a SUMMA broadcast's
    root sends its tile to the g - 1 others once per multiply.  So:

    * ``ring_c``, ``ring_c_bidir``, ``summa_bcast``: (g - 1) x net;
    * ``summa_ag``: g x net (its dict already holds the (g - 1) / g);
    * ``ring_a``: (g - 1) x net + one C tile: C hops g times, its last hop
      home, and B g - 1;
    * ``steal3d``: net itself, one dispatch whose dict counts the panel
      gathers, the moved tiles and the reduce rounds of the device
      (float32 partials, so only where C is float32).
    """
    net = sent["net_bytes_per_step"]
    if alg in ("ring_c", "ring_c_bidir", "summa_bcast"):
        return (g - 1) * net
    if alg == "summa_ag":
        return g * net
    if alg == "ring_a":
        return (g - 1) * net + sent["c_tile_bytes"]
    assert alg == "steal3d"
    return net


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_body_bytes_follow_the_cost_model(case, g, grids):
    """Every rank's body bytes in each dense-output multiply equal
    :func:`expected_body_bytes`; ring_a alone also unskews (an epilogue
    exchange within each grid row, all but row 0)."""
    alg = ALGS[case]
    for rank in grids[g]:
        sent = rank["sent"][case]
        assert sent["algorithm"] == alg
        assert sent["body"] == pytest.approx(
            expected_body_bytes(alg, sent, g), rel=1e-12), rank["rank"]
        assert sent["place"] == 0          # global operands: tiles loaded
        moves = alg == "ring_a" and rank["rank"] >= g
        assert (sent["epilogue"] > 0) == moves


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", [c for c in SPARSE_CASES
                                  if c.endswith(("sparse-padded-on",
                                                 "sparse-padded-off",
                                                 "sparse-packed-on",
                                                 "sparse-packed-off"))])
def test_sparse_body_bytes_follow_the_cost_model(case, g, grids):
    """Sparse outputs: only blocks ride, at the stored or the packed
    stride, and the relation is the dense schedules'."""
    for rank in grids[g]:
        sent = rank["sparse_sent"][case]
        assert sent["body"] == pytest.approx(
            expected_body_bytes(ALGS[case], sent, g), rel=1e-12)


@pytest.mark.parametrize("g", [2, 3])
def test_chained_operand_is_placed_by_one_exchange(g, grids):
    """The cube's second multiply places the product made on the grid by
    one exchange round of its tile permutation (ring_c's skews): at most
    one tile per operand and placement leaves each rank."""
    for rank in grids[g]:
        for case in ("chain-padded", "chain-packed"):
            placed = rank["sparse_sent"][case]["place"]
            assert placed >= 0
        assert any(r["sparse_sent"]["chain-padded"]["place"] > 0
                   for r in grids[g])


@pytest.mark.parametrize("g", [2, 3])
def test_grid_plans_never_share_the_stacked_cache_entry(g, grids):
    for rank in grids[g]:
        cache = rank["cache"]
        assert cache["distinct"] and cache["reused"]
        assert cache["grid_on_ranks"] and not cache["stacked_on_ranks"]
        assert (cache["hits"], cache["misses"]) == (1, 2)
        assert rank["transport"] == "gloo"


@pytest.mark.parametrize("g", [1, 2, 3])
def test_summa_ag_planner_on_ranks_is_the_jax_planner(g, ops):
    """The all-gather SUMMA's planner on a grid (``_wire_planner_summa_ag``,
    flat-pool bases ``_summa_bases``) equals the JAX package's bit for
    bit; the broadcast one its own."""
    from repro_torch.core import api as tapi
    a_t = tapi.DistBSR.from_dense(ops["a"], g=g, block_size=child.BLOCK,
                                  device="cpu")
    s_t = tapi.DistBSR.from_dense(ops["s"], g=g, block_size=child.BLOCK,
                                  device="cpu")
    a_j = japi.DistBSR.from_dense(ops["a"], g=g, block_size=child.BLOCK)
    s_j = japi.DistBSR.from_dense(ops["s"], g=g, block_size=child.BLOCK)
    geom_t = tapi._geometry(a_t, s_t, impl=None)
    geom_j = japi._geometry(a_j, s_j, impl=None, axis_row="row",
                            axis_col="col")
    np.testing.assert_array_equal(tapi._summa_bases(g, 7),
                                  japi._summa_bases(g, 7))
    for name in ("_wire_planner_summa_ag", "_wire_planner_summa_bcast"):
        got = getattr(tapi, name)(a_t.packed_operand(), s_t.packed_operand(),
                                  geom_t)
        want = getattr(japi, name)(a_j.packed_operand(),
                                   s_j.packed_operand(), geom_j)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
    assert tapi.REGISTRY.get("summa_ag").on_ranks.wire_planner \
        is tapi._wire_planner_summa_ag


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_a_failing_rank_fails_the_grid_with_its_traceback():
    with pytest.raises(GridError) as err:
        run_grid(2, ranks.fail_on_rank, 2, device="cpu", timeout_s=60)
    text = str(err.value)
    assert "rank 2" in text and "fails on purpose" in text
    assert "Traceback" in text


def test_a_grid_past_its_deadline_is_killed():
    with pytest.raises(GridError, match="deadline"):
        run_grid(2, ranks.hang, device="cpu", timeout_s=8)


def test_run_grid_refuses_a_function_of_main():
    def local(ex):
        return ex.rank
    local.__module__ = "__main__"
    with pytest.raises(ValueError, match="importable module"):
        run_grid(2, local, device="cpu", timeout_s=10)


def test_layout_checks():
    with pytest.raises(ValueError, match="unknown backend"):
        check_layout(2, "mpi", "cpu")
    with pytest.raises(ValueError, match="moves cpu tensors"):
        check_layout(2, "gloo", "cuda")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_grid_mesh(2, backend="gloo", device_type="cpu")


def test_nccl_with_more_ranks_than_cards_raises():
    """NCCL refuses two ranks on one card; the mesh says so before any
    process group starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: NCCL runs on cards only")
    g = 1
    while g * g <= torch.cuda.device_count():
        g += 1
    with pytest.raises(RuntimeError, match="Duplicate GPU detected"):
        make_grid_mesh(g, backend="nccl", device_type="cuda")
    with pytest.raises(RuntimeError, match="one card per rank"):
        run_grid(g, ranks.hang, backend="nccl", timeout_s=10)


def test_selftest_on_ranks():
    """``python -m repro_torch.launch.selftest --mesh --g 2 --device cpu``
    runs the grid checks on 4 gloo ranks and passes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--mesh",
         "--g", "2", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=GRID_DEADLINE_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "SELFTEST PASSED" in proc.stdout
