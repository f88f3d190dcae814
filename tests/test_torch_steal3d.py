"""steal3d (the paper's SS3.4 work stealing) in the port, against the JAX
package's.

The host planners are plain numpy and must be bit-identical:
``core/schedule.py``'s LPT, makespan, stage imbalance, stealing simulation
and 3D assignment, ``core/steal3d.py``'s ``validate_assignment`` (the same
refusals, word for word) and ``build_steal_plan`` (every field: the pair
lists, move and reduce rounds, the cost dict and the assignment) at g = 1,
2, 3, padded and packed, with and without the overlap split and with an
injected assignment.  The numpy cases of ``test_steal3d.py``,
``test_schedule_static.py`` and ``test_schedule.py`` run on the port's
planners.  End to end, ``matmul(algorithm="steal3d")`` on SpMM,
dense-output SpGEMM and dense A, padded and packed, overlap on and off, is
held against the JAX package at g = 1 in this process (float32 within
1e-5, bf16 within 1e-5 + g * 2^-8) and against the float64 product at g =
2 and 3 on a skewed operand whose assignment moves items; the JAX results
at g = 2 and 3 come from ``torch_jax_child.py`` (the ``steal3d:`` cases of
``test_torch_api.py``).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import schedule as jsch
from repro.core import steal3d as jst  # analysis: allow(source.import.repro.core.steal3d)
from repro_torch.core import api as tapi
from repro_torch.core import schedule as tsch
from repro_torch.core import steal3d as tst
from repro_torch.core.api import DistBSR, DistDense, matmul, plan_matmul
from repro_torch.core.bsr import random_sparse, rmat_matrix
from repro_torch.core.grid import bucket_capacity

CPU = torch.device("cpu")
TOL = 1e-5


# ---------------------------------------------------------------------------
# the schedule functions: bit-identical to the JAX package's
# ---------------------------------------------------------------------------
def _pareto_flops(g, seed, j_dep=False):
    rng = np.random.default_rng(seed)
    cost_ik = rng.pareto(1.1, size=(g, g)) + 0.01     # heavy-tailed R-MAT-ish
    if j_dep:
        return np.broadcast_to(cost_ik[:, :, None], (g, g, g)) \
            * (rng.random((g, g, g)) + 0.5)
    return np.broadcast_to(cost_ik[:, :, None], (g, g, g)).copy()


def _same_assignment(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) is type(b), f.name


@pytest.mark.parametrize("g,seed", [(1, 0), (2, 0), (3, 1), (4, 2), (8, 3)])
@pytest.mark.parametrize("locality", ["none", "random", "locality"])
@pytest.mark.parametrize("j_dep", [False, True])
def test_assign_3d_lpt_matches_jax(g, seed, locality, j_dep):
    flops = _pareto_flops(g, seed, j_dep)
    for kw in ({}, {"comm_penalty": 0.3}, {"max_stolen": 1}):
        _same_assignment(tsch.assign_3d_lpt(flops, g, locality=locality,
                                            **kw),
                         jsch.assign_3d_lpt(flops, g, locality=locality,
                                            **kw))


@pytest.mark.parametrize("seed", range(4))
def test_lpt_makespan_and_imbalance_match_jax(seed):
    rng = np.random.default_rng(seed)
    costs = rng.pareto(1.3, size=int(rng.integers(1, 40))) + 0.05
    for workers in (1, 2, 5):
        a = tsch.lpt_assign(costs, workers)
        np.testing.assert_array_equal(a, jsch.lpt_assign(costs, workers))
        assert tsch.makespan(costs, a, workers) == \
            jsch.makespan(costs, a, workers)
    g = int(rng.integers(1, 6))
    flops = rng.pareto(1.0, size=(g, g, g)) + 0.01
    assert tsch.stage_imbalance_3d(flops) == jsch.stage_imbalance_3d(flops)
    assert tsch.stage_imbalance_3d(np.zeros((g, g, g))) == (1.0, 1.0)
    tiles = rng.pareto(1.2, size=(g, g)) + 0.01
    for steal, pen in (("none", 0.0), ("random", 0.5), ("locality", 0.5),
                       ("locality", 0.0)):
        assert tsch.steal_simulation(tiles, steal, pen) == \
            jsch.steal_simulation(tiles, steal, pen)
    nnz = rng.pareto(1.2, size=4 * g) + 0.01
    np.testing.assert_array_equal(tsch.balance_row_perm(nnz, g),
                                  jsch.balance_row_perm(nnz, g))


def _bad_assignments(mod, g):
    """The same broken assignments, built on each package's own
    Assignment3D (by ``dataclasses.replace`` of a valid one)."""
    flops = np.ones((g, g, g))
    flops[0] = 50.0
    ok = mod.assign_3d_lpt(flops, g, locality="locality")
    off_grid = ok.dev.copy()
    off_grid[0, 0, 1] = g * g - 1          # device (g-1, g-1): row 2, col 2
    return [
        dataclasses.replace(ok, dev=ok.dev[:, :, :1]),
        dataclasses.replace(ok, dev=ok.dev.astype(np.float64)),
        dataclasses.replace(ok, dev=ok.dev + g * g),
        dataclasses.replace(ok, dev=off_grid),
        dataclasses.replace(ok, makespan=ok.owner_makespan * 2),
    ], ok


def test_validate_assignment_refuses_what_jax_refuses():
    g = 3
    (t_bad, t_ok), (j_bad, j_ok) = _bad_assignments(tsch, g), \
        _bad_assignments(jsch, g)
    for got, want in zip(t_bad, j_bad):
        with pytest.raises(ValueError) as e_t:
            tst.validate_assignment(got, g)
        with pytest.raises(ValueError) as e_j:
            jst.validate_assignment(want, g)
        assert str(e_t.value) == str(e_j.value)
    # the realized makespan against the operands' own item costs
    cost_ik = np.ones((g, g))
    cost_ik[:, 0] = 100.0
    for mod_st, ok in ((tst, t_ok), (jst, j_ok)):
        assert mod_st.validate_assignment(ok, g) is ok
    with pytest.raises(ValueError) as e_t:
        tst.validate_assignment(t_ok, g, cost_ik=cost_ik)
    with pytest.raises(ValueError) as e_j:
        jst.validate_assignment(j_ok, g, cost_ik=cost_ik)
    assert str(e_t.value) == str(e_j.value)
    assert "owner-computes" in str(e_t.value)


# ---------------------------------------------------------------------------
# build_steal_plan: bit-identical plans
# ---------------------------------------------------------------------------
def _skewed(seed=3):
    """A sparse 128 x 128 with a dense hub in the top-left corner, so at g
    = 2 and 3 (bs 4) the stealing equilibrium moves items off tile (0, 0)'s
    owner (4 and 15 items)."""
    a = random_sparse(128, 128, 0.003, seed=seed)
    a[:20, :20] += random_sparse(20, 20, 0.9, seed=seed + 1)
    return a


def _operands(kind, g, bs=4):
    """(port a, port b, JAX a, JAX b) on the same numpy inputs."""
    if kind == "dense":
        x = np.random.default_rng(1).standard_normal((24, 20)).astype(
            np.float32)
        y = np.random.default_rng(2).standard_normal((20, 6)).astype(
            np.float32)
        a_t = DistDense.from_global(x, g, device=CPU)
        a_j = japi.DistDense.from_global(jnp.asarray(x), g)
        return (a_t, DistDense.for_rhs(y, a_t), a_j,
                japi.DistDense.for_rhs(jnp.asarray(y), a_j))
    a_d = _skewed()
    a_t = DistBSR.from_dense(a_d, g=g, block_size=bs, device=CPU)
    a_j = japi.DistBSR.from_dense(a_d, g=g, block_size=bs)
    if kind == "spmm":
        b = np.random.default_rng(0).standard_normal(
            (a_d.shape[1], 12)).astype(np.float32)
        return (a_t, DistDense.for_rhs(b, a_t), a_j,
                japi.DistDense.for_rhs(jnp.asarray(b), a_j))
    s = random_sparse(a_d.shape[1], 40, 0.1, seed=5)
    return (a_t, DistBSR.from_dense(s, g=g, block_size=bs, device=CPU), a_j,
            japi.DistBSR.from_dense(s, g=g, block_size=bs))


def _geoms(a_t, b_t, a_j, b_j, overlap):
    return (tapi._geometry(a_t, b_t, impl=None, overlap=overlap),
            japi._geometry(a_j, b_j, impl=None, axis_row="row",
                           axis_col="col", overlap=overlap))


def _same_plan(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "aux":
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif f.name == "assignment":
            _same_assignment(a, b)
        elif f.name == "cost":
            assert a == b                  # every float, bit for bit
        else:
            assert a == b, f.name


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("kind,wire", [("spmm", "padded"),
                                       ("spmm", "packed"),
                                       ("spgemm", "padded"),
                                       ("spgemm", "packed"),
                                       ("dense", "padded")])
@pytest.mark.parametrize("overlap", [False, True])
def test_build_steal_plan_matches_jax(kind, wire, overlap, g):
    a_t, b_t, a_j, b_j = _operands(kind, g)
    gt, gj = _geoms(a_t, b_t, a_j, b_j, overlap)
    got = tst.build_steal_plan(a_t, b_t, gt, wire=wire, overlap=overlap)
    want = jst.build_steal_plan(a_j, b_j, gj, wire=wire, overlap=overlap)
    _same_plan(got, want)
    if kind != "dense" and g == 3:
        assert got.assignment.n_moved > 0   # the skew makes items move


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_injected_assignment_plans_match_jax(g, wire):
    """An injected assignment (the LPT at another comm penalty) gives
    bit-identical plans; one with an item off its grid row and column the
    same refusal."""
    a_t, b_t, a_j, b_j = _operands("spmm", g)
    gt, gj = _geoms(a_t, b_t, a_j, b_j, False)
    cost_ik = a_t.grid_structure().real.sum(axis=2).astype(np.float64)
    flops = np.broadcast_to(cost_ik[:, :, None], (g, g, g)).copy()
    t_loc = tsch.assign_3d_lpt(flops, g, locality="locality",
                               comm_penalty=0.5)
    j_loc = jsch.assign_3d_lpt(flops, g, locality="locality",
                               comm_penalty=0.5)
    assert t_loc.n_moved > 0
    _same_plan(tst.build_steal_plan(a_t, b_t, gt, wire=wire,
                                    assignment=t_loc),
               jst.build_steal_plan(a_j, b_j, gj, wire=wire,
                                    assignment=j_loc))
    errors = []
    for mod, asg, a_h, b_h, geom in ((tst, t_loc, a_t, b_t, gt),
                                     (jst, j_loc, a_j, b_j, gj)):
        dev = asg.dev.copy()
        dev[0, 0, 1] = 1 * g + 2 % g      # device (1, 2 % g): off row 0, col 1
        with pytest.raises(ValueError) as e:
            mod.build_steal_plan(a_h, b_h, geom, wire=wire,
                                 assignment=dataclasses.replace(asg, dev=dev))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "locality constraint" in errors[0]


def _local(dev, g):
    r, c = dev // g, dev % g
    return bool(((r == np.arange(g)[:, None, None])
                 | (c == np.arange(g)[None, None, :])).all())


def test_plan_with_injected_assignment_runs_and_bypasses_the_cache():
    g = 3
    a_t, b_t, a_j, b_j = _operands("spmm", g)
    cost_ik = a_t.grid_structure().real.sum(axis=2).astype(np.float64)
    flops = np.broadcast_to(cost_ik[:, :, None], (g, g, g)).copy()
    asg = tsch.assign_3d_lpt(flops, g, locality="locality",
                             comm_penalty=0.0)
    tapi.clear_plan_cache()
    plan = plan_matmul(a_t, b_t, algorithm="steal3d", assignment=asg)
    assert plan.steal.assignment is asg and tapi.plan_cache_size() == 0
    want = _skewed().astype(np.float64) @ b_t.data.numpy()[:_skewed().shape[1]]
    np.testing.assert_allclose(plan(a_t, b_t).numpy(), want, rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="requires an explicit algorithm"):
        plan_matmul(a_t, b_t, algorithm="ring_c", assignment=asg)
    with pytest.raises(ValueError, match="requires an explicit algorithm"):
        plan_matmul(a_t, b_t, algorithm="auto", assignment=asg)


# ---------------------------------------------------------------------------
# the numpy cases of test_steal3d.py, test_schedule_static.py and
# test_schedule.py on the port's planners
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g,seed", [(2, 0), (4, 1), (4, 2), (8, 3)])
@pytest.mark.parametrize("locality", ["none", "random", "locality"])
def test_assign_3d_every_item_assigned_once(g, seed, locality):
    flops = _pareto_flops(g, seed, j_dep=True)
    asg = tsch.assign_3d_lpt(flops, g, locality=locality)
    assert asg.dev.shape == (g, g, g)
    assert asg.dev.min() >= 0 and asg.dev.max() < g * g
    penalty = {"none": 1.0, "random": 1.0 + asg.comm_penalty,
               "locality": 1.0 + asg.comm_penalty / 3.0}[locality]
    ii, _, jj = np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                            indexing="ij")
    owner = ii * g + jj
    eff = np.where(asg.dev == owner, flops, flops * penalty)
    loads = np.zeros(g * g)
    np.add.at(loads, asg.dev.ravel(), eff.ravel())
    np.testing.assert_allclose(loads, asg.loads)
    assert asg.makespan == pytest.approx(loads.max())


@pytest.mark.parametrize("g,seed", [(2, 0), (4, 1), (4, 5), (8, 2)])
def test_assign_3d_locality_constraint(g, seed):
    asg = tsch.assign_3d_lpt(_pareto_flops(g, seed), g, locality="locality")
    assert _local(asg.dev, g)


@pytest.mark.parametrize("g,seed", [(2, 0), (4, 1), (4, 7), (8, 2), (8, 9)])
@pytest.mark.parametrize("locality", ["random", "locality"])
def test_assign_3d_makespan_never_worse_than_owner(g, seed, locality):
    asg = tsch.assign_3d_lpt(_pareto_flops(g, seed, j_dep=True), g,
                             locality=locality)
    assert asg.makespan <= asg.owner_makespan + 1e-9
    assert asg.gain() >= 1.0


def test_assign_3d_skew_beats_owner_computes():
    g = 4
    flops = np.ones((g, g, g))
    flops[0] = 50.0                       # grid row 0 is the hub
    asg = tsch.assign_3d_lpt(flops, g, locality="locality")
    assert asg.n_moved > 0
    assert asg.makespan < asg.owner_makespan
    assert tsch.steal_simulation(flops[:, :, 0], steal="locality") < \
        tsch.steal_simulation(flops[:, :, 0], steal="none")


def test_assign_3d_owner_mode_zero_items_and_max_stolen():
    g = 3
    flops = np.zeros((g, g, g))
    flops[1, 1, 1] = 5.0
    owner = tsch.assign_3d_lpt(flops, g, locality="none")
    assert owner.n_moved == 0
    loc = tsch.assign_3d_lpt(flops, g, locality="locality")
    assert (loc.dev[flops == 0] == owner.dev[flops == 0]).all()
    g = 4
    flops = np.ones((g, g, g))
    flops[0] = 100.0
    asg = tsch.assign_3d_lpt(flops, g, locality="locality", max_stolen=1)
    ii, _, jj = np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                            indexing="ij")
    stolen = np.zeros(g * g, dtype=int)
    np.add.at(stolen, asg.dev[asg.dev != ii * g + jj].ravel(), 1)
    assert stolen.max() <= 1
    with pytest.raises(ValueError, match="flops_ikj"):
        tsch.assign_3d_lpt(np.ones((2, 3, 2)), 2)
    with pytest.raises(ValueError, match="locality"):
        tsch.assign_3d_lpt(np.ones((2, 2, 2)), 2, locality="quantum")


def test_steal_simulation_zero_guard_and_ordering():
    z = np.zeros((4, 4))
    for steal in ("none", "random", "locality"):
        assert tsch.steal_simulation(z, steal=steal) == 1.0
    assert tsch.stage_imbalance(z) == (1.0, 1.0)
    assert bucket_capacity(0) == 0 and bucket_capacity(1) == 1
    costs = np.random.default_rng(2).pareto(1.2, size=(8, 8)) + 0.01
    none = tsch.steal_simulation(costs, "none")
    rand = tsch.steal_simulation(costs, "random", comm_penalty=0.5)
    loc = tsch.steal_simulation(costs, "locality", comm_penalty=0.5)
    assert rand <= none + 1e-9 and loc < none
    assert tsch.steal_simulation(costs, "random", comm_penalty=0.0) <= \
        tsch.steal_simulation(costs, "locality", comm_penalty=0.0) + 1e-9


def test_lpt_beats_owner_computes_on_skewed_costs():
    costs = np.random.default_rng(0).pareto(1.5, size=64) + 0.1
    naive_max, naive_avg = tsch.makespan(costs, np.arange(64) % 16, 16)
    lpt_max, lpt_avg = tsch.makespan(costs, tsch.lpt_assign(costs, 16), 16)
    assert abs(naive_avg - lpt_avg) < 1e-9
    assert lpt_max <= naive_max and lpt_max / lpt_avg < naive_max / naive_avg


def _opt_makespan(costs, n_workers):
    best = float("inf")
    for assign in itertools.product(range(n_workers), repeat=len(costs)):
        loads = np.zeros(n_workers)
        np.add.at(loads, np.asarray(assign), costs)
        best = min(best, loads.max())
    return best


@pytest.mark.parametrize("seed", range(6))
def test_lpt_within_four_thirds_of_optimal(seed):
    rng = np.random.default_rng(seed)
    n_items, n_workers = int(rng.integers(4, 9)), int(rng.integers(2, 4))
    costs = rng.pareto(1.3, size=n_items) + 0.05
    lpt_max, _ = tsch.makespan(costs, tsch.lpt_assign(costs, n_workers),
                               n_workers)
    opt = _opt_makespan(costs, n_workers)
    assert opt - 1e-9 <= lpt_max <= \
        (4.0 / 3.0 - 1.0 / (3 * n_workers)) * opt + 1e-9


@pytest.mark.parametrize("g,seed", [(2, 0), (4, 1), (8, 2)])
def test_stage_imbalance_matches_bruteforce(g, seed):
    costs = np.random.default_rng(seed).pareto(1.0, size=(g, g)) + 0.05
    totals, per_stage = np.zeros((g, g)), 0.0
    for t in range(g):
        stage = np.array([[costs[i, (i + j + t) % g] for j in range(g)]
                          for i in range(g)])
        per_stage += stage.max()
        totals += stage
    got = tsch.stage_imbalance(costs)
    assert got[0] == pytest.approx(per_stage / totals.mean())
    assert got[1] == pytest.approx(totals.max() / totals.mean())
    assert got[0] >= got[1] - 1e-9 and got[1] >= 1.0


def _steal_plan_4x4():
    a_h = DistBSR.from_dense(rmat_matrix(scale=8, edgefactor=8, seed=3),
                             g=4, block_size=8, device=CPU)
    b_h = DistDense.for_rhs(np.ones((a_h.shape[1], 32), np.float32), a_h)
    geom = tapi._geometry(a_h, b_h, impl=None)
    return a_h, b_h, geom, tapi._steal_plan_for(a_h, b_h, geom)


def test_steal_plan_pair_conservation_bounds_and_cost():
    """Every real A block of every (i, k) tile appears exactly g times over
    the devices' pair lists, slot lists are nondecreasing and cover every
    slot, the pair capacity beats the rings' g x store padding, and the
    cost fields add up; the plan is memoised on the structure."""
    a_h, b_h, geom, sp = _steal_plan_4x4()
    g = sp.g
    zero_base = (g + sum(sp.a_move_cap)) * sp.store_a
    pa, ps = sp.aux["pa"], sp.aux["ps"]
    assert int((pa < zero_base).sum()) == int(a_h.counts.sum()) * g
    assert pa.max() < zero_base + sp.store_a
    assert ps.min() >= 0 and ps.max() < sp.n_slots
    assert sp.aux["pb"].max() < (g + sum(sp.b_move_cap)) * sp.b_chunks
    for r in range(g):
        for c in range(g):
            assert (np.diff(ps[r, c]) >= 0).all()
            assert len(np.unique(ps[r, c])) == sp.n_slots
    assert sp.pair_capacity < g * a_h.tiled.store_capacity
    cm = sp.cost
    assert cm["total_net_bytes"] == pytest.approx(
        cm["gather_bytes"] + cm["moved_tile_bytes"] + cm["reduce_bytes"])
    assert sp.assignment.makespan <= sp.assignment.owner_makespan
    ring_cm = tapi._cost_model(tapi.REGISTRY.get("ring_c"), geom,
                               a_h.abstract_key(), b_h.abstract_key())
    assert cm["total_flops"] < ring_cm["total_flops"]
    assert tapi._steal_plan_for(a_h, b_h, geom) is sp


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
def _small_operands(kind, g, dtype="float32"):
    a_d = random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    s = random_sparse(16, 16, 0.25, seed=1)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    if kind == "dense":
        x = np.random.default_rng(1).standard_normal((10, 7)).astype(
            np.float32)
        y = np.random.default_rng(2).standard_normal((7, 5)).astype(
            np.float32)
        return (DistDense.from_global(torch.from_numpy(x).to(td), g,
                                      device=CPU),
                torch.from_numpy(y).to(td),
                japi.DistDense.from_global(jnp.asarray(x, jd), g),
                jnp.asarray(y, jd), x.astype(np.float64) @ y)
    a_t = DistBSR.from_dense(a_d, g=g, block_size=4, dtype=td, device=CPU)
    a_j = japi.DistBSR.from_dense(a_d, g=g, block_size=4, dtype=jd)
    if kind == "spmm":
        return (a_t, DistDense.for_rhs(torch.from_numpy(b).to(td), a_t),
                a_j, japi.DistDense.for_rhs(jnp.asarray(b, jd), a_j),
                a_d.astype(np.float64) @ b)
    return (a_t, DistBSR.from_dense(s, g=g, block_size=4, dtype=td,
                                    device=CPU),
            a_j, japi.DistBSR.from_dense(s, g=g, block_size=4, dtype=jd),
            a_d.astype(np.float64) @ s)


@pytest.mark.parametrize("kind", ["spmm", "spgemm", "dense"])
@pytest.mark.parametrize("wire", ["padded", "packed"])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_steal3d_parity_g1_in_process(kind, wire, overlap):
    if kind == "dense" and wire == "packed":
        wire = "auto"                 # dense operands have nothing to pack
    a_t, b_t, a_j, b_j, oracle = _small_operands(kind, 1)
    kw = dict(algorithm="steal3d", wire=wire, overlap=overlap)
    g = None if kind != "dense" else 1
    got = matmul(a_t, b_t, g=g, **kw).numpy()
    want = np.asarray(japi.matmul(a_j, b_j, g=g, impl="ref", **kw))
    assert got.shape == want.shape == oracle.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)
    plan = plan_matmul(a_t, b_t, g=g, **kw)
    jplan = japi.plan_matmul(a_j, b_j, g=g, impl="ref", **kw)
    assert (plan.wire, plan.overlap) == (jplan.wire, jplan.overlap)
    assert plan.cost_model() == jplan.cost_model()


@pytest.mark.parametrize("kind", ["spmm", "spgemm"])
def test_steal3d_bf16_parity_g1(kind):
    a_t, b_t, a_j, b_j, _ = _small_operands(kind, 1, "bfloat16")
    got = matmul(a_t, b_t, algorithm="steal3d")
    want = japi.matmul(a_j, b_j, algorithm="steal3d", impl="ref")
    assert got.dtype == torch.bfloat16
    tol = TOL + 1 * 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("kind", ["spmm", "spgemm"])
@pytest.mark.parametrize("wire,overlap", [("padded", "off"),
                                          ("packed", "on")])
def test_steal3d_on_skew_equals_the_product(kind, wire, overlap, g):
    """On a skewed R-MAT operand whose assignment moves items (so the
    moved-tile and reduce rounds are all taken), the result equals the
    float64 product; B1's real pairs are g x A's real blocks (the
    assignment conserves work)."""
    a_t, b_t, _, _ = _operands(kind, g)
    plan = plan_matmul(a_t, b_t, algorithm="steal3d", wire=wire,
                       overlap=overlap)
    assert plan.wire == wire and plan.steal.assignment.n_moved > 0
    assert plan._steal.real_pairs == g * int(a_t.counts.sum())
    assert len(plan._steal.segments) == (2 if overlap == "on" else 1)
    rhs = b_t.data.numpy() if kind == "spmm" else b_t.densify().numpy()
    a_d = _skewed()
    want = a_d.astype(np.float64) @ rhs[:a_d.shape[1]]
    got = plan(a_t, b_t).numpy()
    np.testing.assert_allclose(got, want[:, :got.shape[1]], rtol=TOL,
                               atol=TOL)


def test_steal3d_plan_reuse_and_structure_guard():
    a_t, b_t, _, _, _ = _small_operands("spmm", 1)
    tapi.clear_plan_cache()
    seen = []
    hook = tapi.add_trace_hook(seen.append)
    try:
        plan = plan_matmul(a_t, b_t, algorithm="steal3d")
        for _ in range(3):
            plan(a_t, b_t)
        assert plan_matmul(a_t, b_t, algorithm="steal3d") is plan
    finally:
        tapi.remove_trace_hook(hook)
    assert plan.traces == 1 and seen == [plan]
    other = DistBSR.from_dense(random_sparse(16, 16, 0.02, seed=9), g=1,
                               block_size=4, capacity=a_t.capacity,
                               device=CPU)
    assert other.abstract_key() == a_t.abstract_key()
    assert other.structure_key() != a_t.structure_key()
    assert plan_matmul(other, b_t, algorithm="steal3d") is not plan
    with pytest.raises(ValueError, match="structure") as e_t:
        plan(other, b_t)
    assert "steal3d plan" in str(e_t.value)


def test_steal3d_sparse_output_refused_as_jax():
    a_t, s_t, a_j, s_j, _ = _small_operands("spgemm", 1)
    with pytest.raises(ValueError) as e_t:
        plan_matmul(a_t, s_t, algorithm="steal3d", output="sparse")
    with pytest.raises(ValueError) as e_j:
        japi.plan_matmul(a_j, s_j, algorithm="steal3d", output="sparse")
    assert str(e_t.value) == str(e_j.value)
    assert "sparse-output" in str(e_t.value)


def test_empty_operand_through_every_schedule():
    """A genuinely empty DistBSR keeps capacity 0 and multiplies to zeros
    through every schedule, steal3d included."""
    empty = DistBSR.from_dense(np.zeros((32, 32), np.float32), g=1,
                               block_size=4, device=CPU)
    assert empty.capacity == 0
    assert empty.tiled.store_capacity == empty.tiled.tile_shape[0] // 4
    b_h = DistDense.for_rhs(np.ones((32, 8), np.float32), empty)
    for alg in tapi.algorithms():
        np.testing.assert_array_equal(matmul(empty, b_h,
                                             algorithm=alg).numpy(),
                                      np.zeros((32, 8), np.float32))
