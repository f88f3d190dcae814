"""The port's roofline and cost model against the JAX package's.

``repro_torch.core.roofline`` holds the paper's SS4 formulas and machine
presets; ``repro_torch.core.api`` the alpha-beta-gamma cost model, the
plans' ``cost_model()`` / ``predicted_cost()`` / ``predicted_perf()`` and
``auto_select``.  Every formula, every cost dict and every auto score must
equal the JAX package's on the same inputs (bit for bit: the same float
arithmetic in the same order).  ``auto_select`` is pure planning, so it
and ``_cost_model`` (steal3d: its planner's cost dict) run in this process
at any g; both sides score all six schedules, on a ``Machine`` of the same
fields.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import roofline as jrl
from repro.core import schedule as jschedule
from repro.core import steal3d as jsteal  # analysis: allow(source.import.repro.core.steal3d)
from repro_torch.core import api as tapi
from repro_torch.core import roofline as trl
from repro_torch.core import schedule as tschedule
from repro_torch.core.api import DistBSR, DistDense, plan_matmul
from repro_torch.core.bsr import random_sparse, rmat_matrix

import torch_jax_child as child

CPU = torch.device("cpu")
PORTED = ("summa_bcast", "summa_ag", "ring_c", "ring_a", "ring_c_bidir",
          "steal3d")


def jax_machine(m: trl.Machine) -> jrl.Machine:
    return jrl.Machine(**dataclasses.asdict(m))


def jax_registry() -> japi.AlgorithmRegistry:
    """The JAX package's registry: the port has all six schedules, in the
    same order."""
    assert japi.algorithms() == PORTED
    return japi.REGISTRY


# ---------------------------------------------------------------------------
# the paper's formulas and the presets
# ---------------------------------------------------------------------------
FORMULAS = [
    ("spmm_local_ai", (1024, 1024, 256, 16, 0.01)),
    ("spmm_local_ai", (1 << 20, 1 << 20, 512, 24, 1e-4, 2)),
    ("spmm_internode_ai", (1024, 1024, 256, 16, 0.01)),
    ("spmm_internode_ai", (17_500_000, 17_500_000, 512, 24, 1.7e-5)),
    ("spgemm_local_ai", (4.0, 4)),
    ("spgemm_internode_ai", (3.2e9, 1 << 16, 1 << 16, 1 << 16, 4, 1e-3)),
    ("steal3d_internode_ai", (1e9, 2e6, 3e5, 1e6)),
    ("steal3d_internode_ai", (1e9, 0.0, 0.0, 0.0)),
]


@pytest.mark.parametrize("name,args", FORMULAS)
def test_formulas_match_jax(name, args):
    assert getattr(trl, name)(*args) == getattr(jrl, name)(*args)


@pytest.mark.parametrize("machine", ["SUMMIT_V100", "DGX2_V100", "H100_SXM"])
def test_models_match_jax(machine):
    m = getattr(trl, machine)
    jm = jax_machine(m)
    d = 5.2e9 / (17.5e6 ** 2)
    for ai_net, ai_local in ((1.0, 100.0), (1e12, 100.0), (50.0, 0.5)):
        assert trl.local_peak(ai_local, m) == jrl.local_peak(ai_local, jm)
        assert trl.internode_roofline(ai_net, ai_local, m) == \
            jrl.internode_roofline(ai_net, ai_local, jm)
    assert trl.spmm_model(17_500_000, 17_500_000, 512, 24, d, m) == \
        jrl.spmm_model(17_500_000, 17_500_000, 512, 24, d, jm)
    assert trl.spgemm_model(3.2e9, 4.0, 1 << 16, 1 << 16, 1 << 16, 4, 1e-3,
                            m) == \
        jrl.spgemm_model(3.2e9, 4.0, 1 << 16, 1 << 16, 1 << 16, 4, 1e-3, jm)
    assert trl.steal3d_model(1e9, 2e6, 3e5, 1e6, 3.0, m) == \
        jrl.steal3d_model(1e9, 2e6, 3e5, 1e6, 3.0, jm)


def test_presets():
    """The paper's presets are the JAX package's; the port's card is the
    H100 SXM's data sheet; no TPU constant is in the port."""
    for name in ("SUMMIT_V100", "DGX2_V100"):
        assert dataclasses.asdict(getattr(trl, name)) == \
            dataclasses.asdict(getattr(jrl, name))
    h = trl.H100_SXM
    assert (h.arith_peak, h.mem_bw, h.net_bw, h.word_bytes) == \
        (67e12, 3.35e12, 450e9, 4)
    assert (h.hop_latency, h.overlap_eff) == (1e-6, 1.0)   # not fitted
    assert trl.H100_SXM_PEAK_OPS == {"float32": 67e12, "bfloat16": 989e12}
    assert not any("TPU" in name for name in dir(trl))
    # paper Fig. 2: SpMM on Summit is well into the network-bound regime
    d = 5.2e9 / (17.5e6 ** 2)
    out = trl.spmm_model(17_500_000, 17_500_000, 512, 24, d,
                         trl.SUMMIT_V100)
    assert out["net_bound"] and out["perf"] < trl.SUMMIT_V100.arith_peak


def test_save_and_load_machine(tmp_path):
    m = dataclasses.replace(trl.H100_SXM, name="fitted", overlap_eff=0.5,
                            hop_latency=3e-6)
    path = tmp_path / "machine.json"
    trl.save_machine(m, str(path))
    assert trl.load_machine(str(path)) == m
    # the JAX package reads the same file
    assert dataclasses.asdict(jrl.load_machine(str(path))) == \
        dataclasses.asdict(m)


@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_stage_imbalance_matches_jax(g):
    counts = np.random.default_rng(g).integers(0, 50, (g, g)).astype(
        np.float64)
    assert tschedule.stage_imbalance(counts) == \
        jschedule.stage_imbalance(counts)
    zero = np.zeros((g, g))
    assert tschedule.stage_imbalance(zero) == (1.0, 1.0)
    with pytest.raises(ValueError, match="square"):
        tschedule.stage_imbalance(np.ones((g, g + 1)))


# ---------------------------------------------------------------------------
# cost model dicts
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ops():
    return child.inputs()


def _handles(kind: str, g: int, ops: dict):
    """(port a, port b, JAX a, JAX b) for an operand kind."""
    if kind == "dense":
        a_t = DistDense.from_global(ops["x"], g, device=CPU)
        a_j = japi.DistDense.from_global(jnp.asarray(ops["x"]), g)
        return (a_t, DistDense.for_rhs(ops["y"], a_t), a_j,
                japi.DistDense.for_rhs(jnp.asarray(ops["y"]), a_j))
    a_t = DistBSR.from_dense(ops["a"], g=g, block_size=4, device=CPU)
    a_j = japi.DistBSR.from_dense(ops["a"], g=g, block_size=4)
    if kind == "spmm":
        return (a_t, DistDense.for_rhs(ops["b"], a_t), a_j,
                japi.DistDense.for_rhs(jnp.asarray(ops["b"]), a_j))
    return (a_t, DistBSR.from_dense(ops["s"], g=g, block_size=4,
                                    device=CPU),
            a_j, japi.DistBSR.from_dense(ops["s"], g=g, block_size=4))


# (operand kind, output, wire)
COST_CASES = [("spmm", "dense", "padded"), ("spmm", "dense", "packed"),
              ("spgemm", "dense", "padded"), ("spgemm", "dense", "packed"),
              ("dense", "dense", "padded"), ("spgemm", "sparse", "padded"),
              ("spgemm", "sparse", "packed")]


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("algorithm,kind,output,wire", [
    (alg, *case) for alg in PORTED for case in COST_CASES
    if case[1] == "dense" or alg in ("summa_bcast", "summa_ag", "ring_c")])
def test_cost_model_dicts_match_jax(algorithm, kind, output, wire, g, ops):
    """``plan.cost_model(a)`` equals the JAX package's for the same plan:
    the stored-slot counts (padding and coverage included), the packed
    wire's capacities, the symbolic phase's pair and slot counts, the
    stage imbalance, ``duplex`` and ``overlap``."""
    alg_j = japi.REGISTRY.get(algorithm)
    a_t, b_t, a_j, b_j = _handles(kind, g, ops)
    plan = plan_matmul(a_t, b_t, algorithm=algorithm, output=output,
                       wire=wire, overlap="off")
    got = plan.cost_model(a_t if kind != "dense" else None)
    if g == 1:
        want = japi.plan_matmul(a_j, b_j, algorithm=algorithm, output=output,
                                wire=wire, overlap="off", impl="ref") \
            .cost_model(a_j if kind != "dense" else None)
    else:
        sym = japi._symbolic_for(a_j, b_j) if output == "sparse" else None
        geom = japi._geometry(a_j, b_j, impl=None, axis_row="row",
                              axis_col="col",
                              c_store=sym.store_capacity if sym else 0)
        caps = {t: (a_j if t == "a" else b_j).packed_operand().wire_capacity
                for t in plan._packs} if plan.wire == "packed" else None
        if algorithm == "steal3d":
            want = dict(jsteal.build_steal_plan(a_j, b_j, geom,
                                                wire=plan.wire).cost)
        else:
            want = japi._cost_model(alg_j, geom, a_j.abstract_key(),
                                    b_j.abstract_key(), symbolic=sym,
                                    wire_caps=caps)
        if kind != "dense":
            want["per_stage_imbalance"], want["end_to_end_imbalance"] = \
                jschedule.stage_imbalance(np.asarray(a_j.counts, np.float64))
        want["duplex"] = float(alg_j.duplex)
        want["overlap"] = "off"
    assert got == want


def test_cost_model_ring_a_ships_c_not_a(ops):
    a_t, b_t, _, _ = _handles("spmm", 2, ops)
    ring_a = plan_matmul(a_t, b_t, algorithm="ring_a")
    ring_c = plan_matmul(a_t, b_t, algorithm="ring_c")
    assert ring_a.algorithm.wire == ("b", "c")
    assert ring_c.algorithm.wire == ("a", "b")
    assert ring_a.cost_model()["net_bytes_per_step"] != \
        ring_c.cost_model()["net_bytes_per_step"]


# ---------------------------------------------------------------------------
# auto_select and algorithm="auto"
# ---------------------------------------------------------------------------
AUTO_CASES = [
    # (operand kind, output, wire, overlap, machine)
    ("spmm", "dense", "auto", "auto", "H100_SXM"),
    ("spmm", "dense", "packed", "on", "H100_SXM"),
    ("spmm", "dense", "auto", "off", "SUMMIT_V100"),
    ("spgemm", "dense", "packed", "auto", "DGX2_V100"),
    ("spgemm", "sparse", "auto", "auto", "H100_SXM"),
    ("dense", "dense", "auto", "on", "H100_SXM"),
]


@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("kind,output,wire,overlap,machine", AUTO_CASES)
def test_auto_select_matches_jax(kind, output, wire, overlap, machine, g,
                                 ops):
    """The choice and every score equal the JAX package's, under one
    Machine given to both (a fitted overlap term too)."""
    m = getattr(trl, machine)
    if overlap == "on":
        m = dataclasses.replace(m, overlap_eff=0.4, hop_latency=2e-6)
    a_t, b_t, a_j, b_j = _handles(kind, g, ops)
    got = tapi.auto_select(a_t, b_t, machine=m, output=output, wire=wire,
                           overlap=overlap)
    want = japi.auto_select(a_j, b_j, machine=jax_machine(m),
                            registry=jax_registry(), output=output,
                            wire=wire, overlap=overlap)
    assert got == want
    if output == "sparse":
        assert set(got[1]) == set(tapi.sparse_algorithms())
    else:
        assert set(got[1]) == set(PORTED)


def test_auto_choice_differs_with_sparsity_and_shape():
    """The cost model flips the schedule across operand regimes, as the JAX
    package's does (the H100 preset here)."""
    a_sp = DistBSR.from_dense(random_sparse(64, 64, 0.05, seed=0), g=4,
                              block_size=8, device=CPU)
    comm = tapi.auto_select(a_sp, np.ones((64, 512), np.float32))
    ones = np.ones((2048, 2048), np.float32)
    comp = tapi.auto_select(ones, ones, g=4, device=CPU)
    a_j = japi.DistBSR.from_dense(random_sparse(64, 64, 0.05, seed=0), g=4,
                                  block_size=8)
    reg, h100 = jax_registry(), jax_machine(trl.H100_SXM)
    assert comm == japi.auto_select(a_j, jnp.ones((64, 512)), machine=h100,
                                    registry=reg)
    assert comp == japi.auto_select(jnp.asarray(ones), jnp.asarray(ones),
                                    g=4, machine=h100, registry=reg)
    assert comm[0] != comp[0]
    for _, scores in (comm, comp):
        assert all(s > 0 for s in scores.values())


def test_auto_plan_picks_min_score_and_is_correct(ops):
    tapi.clear_plan_cache()
    a_t, b_t, _, _ = _handles("spmm", 2, ops)
    plan = plan_matmul(a_t, b_t, algorithm="auto")
    assert plan.requested == "auto"
    assert set(plan.auto_scores) == set(tapi.algorithms())
    best = min(plan.auto_scores, key=plan.auto_scores.get)
    assert plan.algorithm.name == best
    assert plan.predicted_cost() == plan.auto_scores[best]
    np.testing.assert_allclose(plan(a_t, b_t).numpy(), ops["a"] @ ops["b"],
                               rtol=1e-5, atol=1e-5)
    # the schedule by name is the same cached plan, which keeps its origin
    again = plan_matmul(a_t, b_t, algorithm=best)
    assert again is plan and again.requested == "auto"
    out = tapi.matmul(a_t, b_t, algorithm="auto",
                      machine=trl.SUMMIT_V100)
    np.testing.assert_allclose(out.numpy(), ops["a"] @ ops["b"], rtol=1e-5,
                               atol=1e-5)


def test_auto_sparse_output_picks_a_sparse_schedule(ops):
    a_t, s_t, a_j, s_j = _handles("spgemm", 2, ops)
    plan = plan_matmul(a_t, s_t, algorithm="auto", output="sparse")
    assert plan.output == "sparse"
    assert set(plan.auto_scores) == set(tapi.sparse_algorithms())
    assert plan.algorithm.name == japi.auto_select(
        a_j, s_j, machine=jax_machine(trl.H100_SXM), registry=jax_registry(),
        output="sparse")[0]
    np.testing.assert_allclose(plan(a_t, s_t).densify().numpy(),
                               ops["a"] @ ops["s"], rtol=1e-5, atol=1e-5)


def _skewed(g):
    """``test_steal3d.py``'s skewed operand: R-MAT scale 11 (seed 3) at bs
    16, and a dense B 256 wide."""
    a = rmat_matrix(scale=11, edgefactor=8, seed=3)
    a_t = DistBSR.from_dense(a, g=g, block_size=16, device=CPU)
    a_j = japi.DistBSR.from_dense(a, g=g, block_size=16)
    b = np.ones((a.shape[1], 256), np.float32)
    return (a_t, DistDense.for_rhs(b, a_t), a_j,
            japi.DistDense.for_rhs(jnp.asarray(b), a_j))


def test_auto_picks_steal3d_when_stealing_wins_on_skew():
    """``test_steal3d.py::test_auto_picks_steal3d_when_stealing_wins_on_skew``
    with six schedules on both sides: where the stealing simulation says
    stealing wins and the machine is compute-bound (the JAX package's
    host-CPU preset, given to both as a Machine of the same fields), both
    packages score steal3d lowest; on the H100 preset the scores and the
    choice are equal too."""
    a_t, b_t, a_j, b_j = _skewed(4)
    counts = a_t.counts.numpy().astype(np.float64)
    assert tschedule.steal_simulation(counts, steal="locality") < \
        tschedule.steal_simulation(counts, steal="none")
    cpu = trl.Machine(**dataclasses.asdict(jrl.HOST_CPU))
    for m in (cpu, trl.H100_SXM):
        got = tapi.auto_select(a_t, b_t, machine=m)
        assert got == japi.auto_select(a_j, b_j, machine=jax_machine(m))
        assert set(got[1]) == set(PORTED)
    choice, scores = tapi.auto_select(a_t, b_t, machine=cpu)
    assert choice == "steal3d" and scores["steal3d"] == min(scores.values())
    plan = plan_matmul(a_t, b_t, algorithm="auto", machine=cpu)
    assert plan.algorithm.name == "steal3d"
    assert plan.steal.assignment.n_moved > 0


def test_auto_select_respects_registration(ops):
    """A (temporarily) registered free-comm algorithm wins auto."""
    a_t, b_t, _, _ = _handles("spmm", 2, ops)
    ring_c = tapi.REGISTRY.get("ring_c")
    tapi.REGISTRY.register(tapi.Algorithm(
        name="freebie", body=ring_c.body, a_placement=ring_c.a_placement,
        b_placement=ring_c.b_placement, wire=(), wire_amortized=True))
    try:
        choice, scores = tapi.auto_select(a_t, b_t)
        assert choice == "freebie" and "freebie" in scores
    finally:
        tapi.REGISTRY.unregister("freebie")


@pytest.mark.parametrize("algorithm", PORTED)
def test_predicted_perf_matches_jax(algorithm, ops):
    a_t, b_t, a_j, b_j = _handles("spmm", 1, ops)
    m = dataclasses.replace(trl.H100_SXM, overlap_eff=0.7)
    plan = plan_matmul(a_t, b_t, algorithm=algorithm)
    jplan = japi.plan_matmul(a_j, b_j, algorithm=algorithm, impl="ref")
    got = plan.predicted_perf(m)
    assert got == jplan.predicted_perf(jax_machine(m))
    assert 0 < got["perf"] <= m.arith_peak
    assert plan.predicted_cost(m) == jplan.predicted_cost(jax_machine(m)) > 0
