"""The port's static verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

* **healthy plans** — over ``tests/test_analysis.py``'s dispatch matrix
  (schedule x operand kind x output x wire x overlap) the port's
  ``check_plan`` is empty wherever the JAX package's is, at g = 1 in this
  process (the main pytest process owns one CPU device); the port's own
  matrix, ``check_plan`` and the op-trace lint, proves clean at g = 1, 2
  and 3 on the stacked executor;
* **mutations** — each seeded violation of ``test_analysis.py`` (a bad
  ring permutation, a dropped or duplicated steal3d accumulation, a
  broken consume map, a corrupt sparse pair list) is named by the JAX
  package's rule id on both sides; a reordered overlap body, a
  miscounted schedule, a sort between the launches and a copy of an
  operand are named by the op-trace rules (the JAX package's jaxpr lint
  does not run under jax 0.9.0: ``jax.core.ClosedJaxpr`` is gone);
* ``check_survivor_coverage`` and ``validate_assignment`` equal to the JAX
  package's on the same assignments;
* **plumbing** — ``plan_matmul(validate=...)`` modes, memoization and the
  never-cache-a-failing-plan rule (``test_analysis.py``'s), and the
  source rules: clean on the port, each rule firing on a planted file,
  ``--json`` / ``--list-rules``, rule-specific waivers.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import analysis as janalysis
from repro.core import api as japi
from repro.core import schedule as jsch
from repro.core import steal3d as jst  # analysis: allow(source.import.repro.core.steal3d)
from repro_torch import analysis
from repro_torch.analysis import op_lint, schedule_check, source_rules
from repro_torch.core import api
from repro_torch.core import schedule as tsch
from repro_torch.core import steal3d as tst
from repro_torch.core.api import DistBSR, DistDense, plan_matmul
from repro_torch.core.bsr import random_sparse, rmat_matrix
from repro_torch.core.executor import StackedExecutor
from repro_torch.kernels import ops as kops

CPU = torch.device("cpu")


def _operands(g: int):
    """``test_analysis.py``'s operands on the port's grid ``g``."""
    a_d = random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    s_d = random_sparse(16, 16, 0.25, seed=1)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    return (a_h, DistDense.for_rhs(b, a_h),
            DistBSR.from_dense(s_d, g=g, block_size=4, device=CPU))


@pytest.fixture
def operands():
    return _operands(1)


@pytest.fixture(scope="module")
def jax_operands():
    a_d = random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    a_h = japi.DistBSR.from_dense(a_d, g=1, block_size=4)
    return (a_h, japi.DistDense.for_rhs(jnp.asarray(b), a_h),
            japi.DistBSR.from_dense(random_sparse(16, 16, 0.25, seed=1),
                                    g=1, block_size=4))


def _rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# healthy plans prove clean
# ---------------------------------------------------------------------------
_DENSE_ALGS = ("ring_c", "ring_a", "ring_c_bidir", "summa_ag",
               "summa_bcast", "steal3d")
_SPARSE_OUT_ALGS = ("ring_c", "summa_ag", "summa_bcast")
_SPGEMM_ALGS = ("ring_c", "ring_a", "summa_ag", "summa_bcast", "steal3d")

_MATRIX = (
    [(alg, "spmm", "dense", wire, ov)
     for alg in _DENSE_ALGS
     for wire in ("padded", "packed")
     for ov in ("off", "on")]
    + [(alg, "spgemm", "sparse", wire, "off")
       for alg in _SPARSE_OUT_ALGS
       for wire in ("padded", "packed")]
    + [(alg, "spgemm", "dense", "padded", "off") for alg in _SPGEMM_ALGS]
)
_IDS = [f"{a}-{k}-{o}-{w}-ov_{v}" for a, k, o, w, v in _MATRIX]


@pytest.mark.parametrize("alg,kind,output,wire,overlap", _MATRIX, ids=_IDS)
def test_healthy_plans_clean_where_jax_is(jax_operands, operands, alg, kind,
                                          output, wire, overlap):
    """g = 1: the JAX package's schedule check and the port's, on the same
    plan request over the same matrices."""
    ja, jb, js = jax_operands
    jrhs = jb if kind == "spmm" else js
    jplan = japi.plan_matmul(ja, jrhs, algorithm=alg, impl="ref",
                             output=output, wire=wire, overlap=overlap)
    want = janalysis.check_plan(jplan, ja, jrhs)
    a_h, b_h, s_h = operands
    rhs = b_h if kind == "spmm" else s_h
    plan = plan_matmul(a_h, rhs, algorithm=alg, output=output, wire=wire,
                       overlap=overlap)
    assert (plan.wire, plan.output) == (jplan.wire, jplan.output)
    got = analysis.check_plan(plan, a_h, rhs) \
        + analysis.lint_plan(plan, a_h, rhs)
    assert not want, "\n".join(str(f) for f in want)
    assert not got, "\n".join(str(f) for f in got)


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("alg,kind,output,wire,overlap", _MATRIX, ids=_IDS)
def test_healthy_plans_prove_clean_at_g(g, alg, kind, output, wire, overlap):
    """The stacked executor at g = 2 and 3: every rule, the op-trace lint
    included (its shift count has teeth from g = 2 on)."""
    a_h, b_h, s_h = _operands(g)
    rhs = b_h if kind == "spmm" else s_h
    plan = plan_matmul(a_h, rhs, algorithm=alg, output=output, wire=wire,
                       overlap=overlap)
    findings = analysis.check_plan(plan, a_h, rhs) \
        + analysis.lint_plan(plan, a_h, rhs)
    assert not findings, "\n".join(str(f) for f in findings)


@pytest.mark.parametrize("g", [2, 3])
def test_skewed_steal3d_with_moved_items_proves_clean(g):
    """An R-MAT operand whose LPT moves items: the decode sees moved tiles,
    reduce rounds and the packed rounds' row lists."""
    a_d = rmat_matrix(6, 8, seed=0)
    b = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=CPU)
    b_h = DistDense.for_rhs(b, a_h)
    for wire in ("padded", "packed"):
        for overlap in ("off", "on"):
            plan = plan_matmul(a_h, b_h, algorithm="steal3d", wire=wire,
                               overlap=overlap)
            if g == 3:
                assert plan.steal.assignment.n_moved > 0
            findings = analysis.check_plan(plan, a_h, b_h) \
                + analysis.lint_plan(plan, a_h, b_h)
            assert not findings, "\n".join(str(f) for f in findings)


def test_dense_steal3d_checks_clean_where_jax_fails_to_decode():
    """Dense x dense steal3d: the JAX checker reads A's structure before it
    knows A is sparse and reports its own decode failure as a finding
    (``repro/analysis/schedule_check.py:636``); the port proves the plan
    clean (ROADMAP Queue C)."""
    x = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    ja = japi.DistDense.from_global(jnp.asarray(x), 1)
    jb = japi.DistDense.for_rhs(jnp.asarray(x), ja)
    jplan = japi.plan_matmul(ja, jb, algorithm="steal3d", impl="ref")
    want = janalysis.check_plan(jplan, ja, jb)
    assert [f.rule for f in want] == ["schedule.steal-exactly-once"]
    assert "could not decode" in want[0].message
    for g in (1, 2):
        a = DistDense.from_global(x, g, device=CPU)
        b = DistDense.for_rhs(x, a)
        plan = plan_matmul(a, b, algorithm="steal3d")
        assert not analysis.check_plan(plan, a, b) \
            + analysis.lint_plan(plan, a, b)


def test_registry_rule_ids_unique_and_documented():
    rules = analysis.all_rules()
    ids = [r for r, _ in rules]
    assert len(ids) == len(set(ids))
    for prefix in ("schedule.", "optrace.", "source."):
        assert any(r.startswith(prefix) for r in ids), prefix
    assert all(desc for _, desc in rules)
    # the schedule rules are the JAX package's, id for id
    assert [r for r, _ in analysis.schedule_check.RULES] \
        == [r for r, _ in janalysis.schedule_check.RULES]


def test_finding_and_error_formatting():
    f = analysis.Finding("x.rule", "broken thing", subject="ring_c/step 2")
    assert str(f) == "x.rule [ring_c/step 2]: broken thing"
    err = analysis.PlanValidationError([f])
    assert "x.rule" in str(err) and "1 finding" in str(err)
    assert err.findings == [f]
    assert isinstance(err, ValueError)
    jf = janalysis.Finding("x.rule", "broken thing", subject="ring_c/step 2")
    assert str(jf) == str(f) \
        and str(janalysis.PlanValidationError([jf])) == str(err)


# ---------------------------------------------------------------------------
# mutations: the JAX package's rule ids on both sides
# ---------------------------------------------------------------------------
def test_mutation_invalid_ring_perm(operands, jax_operands, monkeypatch):
    a_h, b_h, _ = operands
    ja, jb, _ = jax_operands
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    jplan = japi.plan_matmul(ja, jb, algorithm="ring_c", impl="ref",
                             cache=False)
    bad = lambda g, sign=1: ((0, 1),)
    monkeypatch.setattr(schedule_check, "_ring_perm", bad)
    monkeypatch.setattr(japi, "_ring_perm", bad)
    got = _rules_of(analysis.check_plan(plan, a_h, b_h))
    want = _rules_of(janalysis.check_plan(jplan, ja, jb))
    assert got == want == ["schedule.ppermute-bijection"]


@pytest.mark.parametrize("g", [2, 3])
def test_mutation_step_map_that_is_not_the_ring(g, monkeypatch):
    """A tile map the executor composes wrongly (here: no hop at all) is
    not the composition of the ring permutations."""
    a_h, b_h, _ = _operands(g)
    for alg in ("ring_c", "ring_a", "ring_c_bidir"):
        plan = plan_matmul(a_h, b_h, algorithm=alg, cache=False)
        monkeypatch.setattr(plan.executor, "shift_map",
                            lambda m, axis, sign=1: np.asarray(m))
        findings = analysis.check_plan(plan, a_h, b_h)
        assert _rules_of(findings) == ["schedule.ppermute-bijection"], alg
        assert "composition" in str(findings[0])
        monkeypatch.undo()
        assert not analysis.check_plan(plan, a_h, b_h)


def _steal_mutants(aux, kind):
    pa = aux["pa"]
    inert = pa.reshape(-1).max()            # the zero-block sentinel slot
    r0 = tuple(np.argwhere(pa != inert)[0])
    if kind == "drop":
        pa[r0] = inert
        return
    pb, ps = aux["pb"], aux["ps"]
    i0 = next(tuple(i) for i in np.argwhere(pa == inert)
              if tuple(i[:2]) == r0[:2])
    pa[i0], pb[i0], ps[i0] = pa[r0], pb[r0], ps[r0]


@pytest.mark.parametrize("kind", ["drop", "duplicate"])
def test_mutation_steal_accumulation(operands, jax_operands, kind):
    """Blanking a real pair drops its product; copying it onto an inert
    slot double-counts it: schedule.steal-exactly-once on both sides."""
    got = []
    for (a, b), mod, check in (
            (operands[:2], api, analysis.check_plan),
            (jax_operands[:2], japi, janalysis.check_plan)):
        plan = mod.plan_matmul(a, b, algorithm="steal3d", impl="ref",
                               cache=False)
        sp = plan.steal
        aux = {k: np.asarray(v).copy() for k, v in sp.aux.items()}
        _steal_mutants(aux, kind)
        plan.steal = dataclasses.replace(sp, aux=aux)
        got.append(_rules_of(check(plan, a, b)))
        plan.steal = sp
        assert not check(plan, a, b)
    assert got[0] == got[1] and "schedule.steal-exactly-once" in got[0]


def test_mutation_steal_lists_out_of_step_with_the_tables():
    """The stacked executor's lists must carry the plan's real pairs: a
    segment that lost one is flagged even though the StealPlan is whole."""
    a_h, b_h, _ = _operands(2)
    plan = plan_matmul(a_h, b_h, algorithm="steal3d", cache=False)
    seg = dict(plan._steal.segments[0])
    real = seg["real"].copy()
    real[tuple(np.argwhere(real)[0])] = False
    seg["real"] = real
    good = plan._steal
    plan._steal = dataclasses.replace(good, segments=(seg,)
                                      + good.segments[1:])
    try:
        assert "schedule.steal-exactly-once" in _rules_of(
            analysis.check_plan(plan, a_h, b_h))
    finally:
        plan._steal = good
    assert not analysis.check_plan(plan, a_h, b_h)


def test_mutation_steal_reduce_round_from_the_wrong_device():
    a_d = rmat_matrix(6, 8, seed=0)
    b = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=3, block_size=4, device=CPU)
    b_h = DistDense.for_rhs(b, a_h)
    plan = plan_matmul(a_h, b_h, algorithm="steal3d", cache=False)
    good = plan._steal
    assert good.rounds
    (src,) = good.rounds[0]
    plan._steal = dataclasses.replace(good, rounds=(
        (torch.roll(src, 1),),) + good.rounds[1:])
    try:
        assert _rules_of(analysis.check_plan(plan, a_h, b_h)) \
            == ["schedule.ppermute-bijection"]
    finally:
        plan._steal = good


def test_mutation_broken_consume_map(operands, jax_operands):
    """Rolling the packed-wire gidx consume map desynchronizes it from the
    pack layout: schedule.wire-contract on both sides."""
    a_h, b_h, _ = operands
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", wire="packed",
                       cache=False)
    good = plan._aux[0]["a_gidx"]
    plan._aux[0]["a_gidx"] = torch.roll(good, 1, dims=-1)
    got = _rules_of(analysis.check_plan(plan, a_h, b_h))
    plan._aux[0]["a_gidx"] = good
    assert not analysis.check_plan(plan, a_h, b_h)
    ja, jb, _ = jax_operands
    jplan = japi.plan_matmul(ja, jb, algorithm="ring_c", impl="ref",
                             wire="packed", cache=False)
    jgood = np.asarray(jplan._aux["a_gidx"])
    jplan._aux["a_gidx"] = np.roll(jgood, 1, axis=-1)
    want = _rules_of(janalysis.check_plan(jplan, ja, jb))
    jplan._aux["a_gidx"] = jgood
    assert got == want == ["schedule.wire-contract"]


def test_mutation_packed_launch_reads_the_wrong_tile(monkeypatch):
    """Consume maps right, tile maps wrong: the launch would read a placed
    tile its maps were not built for."""
    a_h, b_h, _ = _operands(2)
    plan = plan_matmul(a_h, b_h, algorithm="summa_bcast", wire="packed",
                       cache=False)
    steps = plan.step_maps()
    swapped = [((a_map[::-1], b_map),) for ((a_map, b_map),) in steps]
    monkeypatch.setattr(plan, "step_maps", lambda: swapped)
    assert "schedule.wire-contract" in _rules_of(
        analysis.check_plan(plan, a_h, b_h))


def test_mutation_duplicated_sparse_pair(operands, jax_operands):
    """Copying a real pair over an inert one accumulates its product
    twice: schedule.sparse-pairs-exactly-once on both sides."""
    a_h, _, s_h = operands
    plan = plan_matmul(a_h, s_h, algorithm="ring_c", output="sparse",
                       wire="padded", cache=False)
    real = plan._pair_real[0, 0, 0]
    src, dst = int(np.flatnonzero(real)[0]), int(np.flatnonzero(~real)[0])
    good = {k: plan._pairs[0][k] for k in ("pa", "pb", "ps")}
    for k in good:
        bad = good[k].clone()
        bad[0, dst] = bad[0, src]
        plan._pairs[0][k] = bad
    got = _rules_of(analysis.check_plan(plan, a_h, s_h))
    plan._pairs[0].update(good)
    assert not analysis.check_plan(plan, a_h, s_h)
    ja, _, js = jax_operands
    jplan = japi.plan_matmul(ja, js, algorithm="ring_c", impl="ref",
                             output="sparse", wire="padded", cache=False)
    jgood = dict(jplan._pairs)
    for k in ("pa", "pb", "ps"):
        bad = np.asarray(jgood[k]).copy()
        bad[0, 0, 0, dst] = bad[0, 0, 0, src]
        jplan._pairs[k] = bad
    want = _rules_of(janalysis.check_plan(jplan, ja, js))
    jplan._pairs.update(jgood)
    assert got == want == ["schedule.sparse-pairs-exactly-once"]


def test_mutation_corrupt_sparse_pair_list(operands, jax_operands):
    """Pointing a sparse-output pair at the zero slot drops a real
    contribution: schedule.sparse-pairs-exactly-once on both sides (the
    port also sees the kernel's real-pair mask disagree)."""
    a_h, _, s_h = operands
    plan = plan_matmul(a_h, s_h, algorithm="ring_c", output="sparse",
                       wire="padded", cache=False)
    zero = int(s_h.grid_structure().zero_slot[0, 0])
    good = plan._pairs[0]["pb"]
    pb = good.clone()
    pb[0, 0] = zero
    plan._pairs[0]["pb"] = pb
    findings = analysis.check_plan(plan, a_h, s_h)
    plan._pairs[0]["pb"] = good
    assert not analysis.check_plan(plan, a_h, s_h)
    assert any("real-pair mask" in str(f) for f in findings)
    ja, _, js = jax_operands
    jplan = japi.plan_matmul(ja, js, algorithm="ring_c", impl="ref",
                             output="sparse", wire="padded", cache=False)
    jgood = jplan._pairs["pb"]
    jpb = np.asarray(jgood).copy()
    jpb[0, 0, 0, 0] = zero
    jplan._pairs["pb"] = jpb
    want = _rules_of(janalysis.check_plan(jplan, ja, js))
    jplan._pairs["pb"] = jgood
    assert _rules_of(findings) == want \
        == ["schedule.sparse-pairs-exactly-once"]


# ---------------------------------------------------------------------------
# the op-trace rules: each fires on a broken body, silent on healthy ones
# ---------------------------------------------------------------------------
def _late_issue_body(a, b, steps, geom, ex):
    """Broken overlap: multiplies before issuing step t+1's shift."""
    b = api._densify_b(b, geom, ex)
    a_map = b_map = ex.identity_map()
    c = None
    for t in range(geom.g):
        c = api._local_mm(a, b, a_map, b_map, steps, c, geom, ex)
        if t < geom.g - 1:
            a_map = ex.shift_map(a_map, "col")
            b_map = ex.shift_map(b_map, "row")
    return ex.unbatch(c)


def _sorting_body(a, b, steps, geom, ex):
    """Re-sorts structure between the launches."""
    b = api._densify_b(b, geom, ex)
    c = None
    for (a_map, b_map), in steps.maps():
        c = api._local_mm(a, b, a_map, b_map, steps, c, geom, ex)
        torch.argsort(a["rows"].reshape(-1))
    return ex.unbatch(c)


def _gathering_body(a, b, steps, geom, ex):
    """Gathers a copy of the A stack before the ring."""
    idx = torch.arange(geom.g * geom.g, device=ex.device)
    a = dict(a, blocks=ex.unbatch(ex.batch(a["blocks"]).index_select(0,
                                                                      idx)))
    return api._stationary_c(a, b, steps, geom, ex)


def _densifying_body(a, b, steps, geom, ex):
    """Densifies the sparse A again at every step (a scatter in the hot
    loop, through the wire's ``densify``)."""
    b = api._densify_b(b, geom, ex)
    c = None
    for (a_map, b_map), in steps.maps():
        kops.densify(ex.batch(a["blocks"]), ex.batch(a["rows"]),
                     ex.batch(a["cols"]), n_block_rows=geom.a_nbr,
                     n_block_cols=geom.a_nbr)
        c = api._local_mm(a, b, a_map, b_map, steps, c, geom, ex)
    return ex.unbatch(c)


def _wire_gathering_body(a, b, steps, geom, ex):
    """Gathers the A stack through the wire's ``densify_packed``."""
    dmap = torch.zeros((geom.g * geom.g, geom.a_nbr * geom.a_nbr),
                       dtype=torch.int32, device=ex.device)
    kops.densify_packed(ex.batch(a["blocks"]), dmap,
                        n_block_rows=geom.a_nbr, n_block_cols=geom.a_nbr)
    return api._stationary_c(a, b, steps, geom, ex)


def _rolling_body(a, b, steps, geom, ex):
    """Rolls the dense B stack (a copy where a tile map would do)."""
    b = {"dense": torch.roll(b["dense"], -1, dims=0)}
    return api._stationary_c(a, b, steps, geom, ex)


@pytest.fixture
def registered():
    names = []

    def register(name, body):
        api.REGISTRY.register(dataclasses.replace(
            api.REGISTRY.get("ring_c"), name=name, body=body,
            packed_body=None, sparse_body=None))
        names.append(name)
        return name

    yield register
    for name in names:
        api.REGISTRY.unregister(name)


@pytest.mark.parametrize("g", [2, 3])
def test_overlap_carry_fires_on_late_issue(g, registered):
    a_h, b_h, _ = _operands(g)
    name = registered("late_issue", _late_issue_body)
    plan = plan_matmul(a_h, b_h, algorithm=name, overlap="on", cache=False)
    findings = analysis.lint_plan(plan, a_h, b_h)
    assert _rules_of(findings) == ["optrace.overlap-carry"]
    assert "transfer" in str(findings[0])
    off = plan_matmul(a_h, b_h, algorithm=name, overlap="off", cache=False)
    assert not analysis.lint_plan(off, a_h, b_h)   # bulk bodies: no rule
    ring = plan_matmul(a_h, b_h, algorithm="ring_c", overlap="on")
    assert not analysis.lint_plan(ring, a_h, b_h)


def test_shift_count_fires_on_a_miscounted_schedule():
    """ring_c charged 7 messages a step (test_analysis.py's bad_msgs,
    which the JAX package mutates in its selftest at g >= 2)."""
    a_h, b_h, _ = _operands(2)
    bad = dataclasses.replace(api.REGISTRY.get("ring_c"), name="bad_msgs",
                              msgs_per_step=7)
    api.REGISTRY.register(bad)
    try:
        plan = plan_matmul(a_h, b_h, algorithm="bad_msgs", cache=False)
        assert _rules_of(analysis.lint_plan(plan, a_h, b_h)) \
            == ["optrace.shift-count"]
        with pytest.raises(analysis.PlanValidationError,
                           match="optrace.shift-count"):
            plan_matmul(a_h, b_h, algorithm="bad_msgs", cache=False,
                        validate="full")
        a1, b1, _ = _operands(1)      # g = 1: the ring perms alias
        plan1 = plan_matmul(a1, b1, algorithm="bad_msgs", cache=False)
        assert op_lint.check_shift_count(
            plan1, op_lint.record_multiply(plan1, a1, b1)) == []
    finally:
        api.REGISTRY.unregister("bad_msgs")


def test_hot_loop_rule_binds_kernel_paths_only(registered):
    """The plain versions accumulate with index_add_, so the rule binds the
    kernel paths: the same record is clean under impl='ref' and flagged
    under 'cuda'; a healthy ring's record is clean under both."""
    a_h, b_h, _ = _operands(2)
    plan = plan_matmul(a_h, b_h, algorithm=registered("sorting",
                                                      _sorting_body),
                       cache=False)
    rec = op_lint.record_multiply(plan, a_h, b_h)
    assert op_lint.check_hot_loop(rec, impl="ref") == []
    assert _rules_of(op_lint.check_hot_loop(rec, impl="cuda")) \
        == ["optrace.step-hot-loop"]
    assert op_lint.check_hot_loop(rec, plan=plan) == []   # CPU: plain path
    for alg in ("ring_c", "steal3d"):
        healthy = plan_matmul(a_h, b_h, algorithm=alg, wire="packed")
        rec = op_lint.record_multiply(healthy, a_h, b_h)
        assert op_lint.check_hot_loop(rec, impl="cuda") == []


def test_hot_loop_rule_sees_the_wires_densify(registered):
    """A scatter run inside the wire's ``densify`` between the launches is
    the body's own: only a local multiply's ops are the kernel's."""
    a_h, b_h, _ = _operands(2)
    plan = plan_matmul(a_h, b_h, algorithm=registered("densifying",
                                                      _densifying_body),
                       cache=False)
    rec = op_lint.record_multiply(plan, a_h, b_h)
    assert _rules_of(op_lint.check_hot_loop(rec, impl="cuda")) \
        == ["optrace.step-hot-loop"]


@pytest.mark.parametrize("body", [_gathering_body, _wire_gathering_body,
                                  _rolling_body],
                         ids=["gather", "wire_gather", "roll"])
def test_no_operand_copy_fires(body, registered):
    a_h, b_h, _ = _operands(2)
    plan = plan_matmul(a_h, b_h, algorithm=registered("copying", body),
                       cache=False)
    assert _rules_of(analysis.lint_plan(plan, a_h, b_h)) \
        == ["optrace.no-operand-copy"]


def test_copy_ops_spy_sees_operands_by_storage():
    """The spy ``chip_smoke.py`` imports: an op counts as an operand copy
    when it reads the operand's storage (a reshaped view too), and every
    roll is listed."""
    x = torch.arange(12.0).reshape(3, 4)
    other = torch.zeros(3, 4)
    hits, rolls = op_lint.copy_ops(
        lambda: (x.reshape(4, 3).index_select(0, torch.tensor([1])),
                 other.index_select(0, torch.tensor([0])),
                 torch.roll(other, 1, 0)), [x])
    assert hits == ["aten::index_select[4, 3]"]
    assert rolls == ["aten::roll[3, 4]"]


def test_copy_ops_spy_counts_ops_inside_ops_calls():
    """Every copy op that reads an operand counts, those run inside an ops
    call too: the wire's gather and a plain multiply's reads."""
    blocks = torch.arange(32.0).reshape(2, 4, 2, 2)
    dmap = torch.zeros((2, 4), dtype=torch.int32)
    hits, _ = op_lint.copy_ops(
        lambda: kops.densify_packed(blocks, dmap, n_block_rows=2,
                                    n_block_cols=2), [blocks])
    assert hits and all(h.startswith("aten::index") for h in hits)
    a_h, b_h, _ = _operands(1)
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    hits, _ = op_lint.copy_ops(lambda: plan(a_h, b_h), [a_h.tiled.blocks])
    assert hits                 # the plain B1 gathers A's blocks


# ---------------------------------------------------------------------------
# survivor coverage and validate_assignment, against the JAX package
# ---------------------------------------------------------------------------
def _lpt(g=2, seed=3):
    rng = np.random.default_rng(seed)
    cost_ik = rng.integers(1, 20, size=(g, g)).astype(np.float64)
    flops = np.broadcast_to(cost_ik[:, :, None], (g, g, g))
    return cost_ik, tsch.assign_3d_lpt(flops, g), jsch.assign_3d_lpt(flops,
                                                                      g)


def _coverage_cases():
    _, asg, _ = _lpt(2)
    dev = asg.dev
    holes = dev.copy()
    holes[0, 1, 0] = -1
    dead = dev.copy()
    dead[1, 1, 1] = 7
    return [("healthy", dev, 2, (0, 3, 4, 5)),
            ("count", dev, 2, 4),
            ("too_few", dev, 2, (0, 3, 4)),
            ("shape", dev, 3, None),
            ("float", dev.astype(np.float64), 2, None),
            ("holes", holes, 2, None),
            ("dead_ids", dead, 2, 9),
            ("holes_dead_too_few", np.where(holes < 0, 9, holes), 2, 2)]


@pytest.mark.parametrize("name,dev,g,survivors", _coverage_cases(),
                         ids=[c[0] for c in _coverage_cases()])
def test_survivor_coverage_matches_jax(name, dev, g, survivors):
    got = analysis.check_survivor_coverage(dev, g, survivors)
    want = janalysis.check_survivor_coverage(dev, g, survivors)
    assert [(f.rule, f.message, f.subject) for f in got] \
        == [(f.rule, f.message, f.subject) for f in want]
    assert bool(got) == (name not in ("healthy", "count"))


def _assignment_mutants():
    cost_ik, asg, _ = _lpt(2)
    dev_oob = asg.dev.copy()
    dev_oob[0, 0, 0] = 4
    dev_loc = asg.dev.copy()
    dev_loc[0, 0, 1] = 2
    return [("healthy", {}), ("shape", {"dev": np.zeros((2, 2), np.int64)}),
            ("float", {"dev": asg.dev.astype(np.float64)}),
            ("out_of_range", {"dev": dev_oob}), ("locality", {"dev": dev_loc}),
            ("makespan", {"makespan": asg.owner_makespan * 2})]


@pytest.mark.parametrize("name,change", _assignment_mutants(),
                         ids=[m[0] for m in _assignment_mutants()])
def test_validate_assignment_matches_jax(name, change):
    cost_ik, asg, jasg = _lpt(2)
    outcome = []
    for mod, a in ((tst, asg), (jst, jasg)):
        bad = dataclasses.replace(a, **change)
        try:
            mod.validate_assignment(bad, 2, cost_ik=cost_ik)
            outcome.append("accepted")
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[0] == "accepted") == (name == "healthy")


# ---------------------------------------------------------------------------
# plan_matmul(validate=...) plumbing
# ---------------------------------------------------------------------------
def test_validate_modes_pass_and_memoize(operands):
    a_h, b_h, _ = operands
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False,
                       validate="fast")
    assert "fast" in plan._validated and "full" not in plan._validated
    plan.validate("full", a_h, b_h)
    assert {"fast", "full"} <= plan._validated
    plan.validate("full", a_h, b_h)        # memoized: no second multiply
    plan2 = plan_matmul(a_h, b_h, algorithm="steal3d", cache=False,
                        validate="full")
    assert {"fast", "full"} <= plan2._validated


def test_validate_is_memoized_without_rerunning(operands, monkeypatch):
    a_h, b_h, _ = operands
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False,
                       validate="full")
    calls = []
    monkeypatch.setattr(analysis, "check_plan",
                        lambda *a: calls.append(a) or [])
    plan.validate("fast", a_h, b_h)
    plan.validate("full", a_h, b_h)
    assert calls == []


def test_validate_off_and_bad_mode(operands):
    a_h, b_h, _ = operands
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    assert plan._validated == set()
    plan.validate("off")
    assert plan._validated == set()
    with pytest.raises(ValueError, match="validate"):
        plan_matmul(a_h, b_h, algorithm="ring_c", validate="paranoid")
    with pytest.raises(ValueError, match="validate mode"):
        plan.validate("paranoid")


def test_validate_full_needs_operands(operands):
    a_h, b_h, _ = operands
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    with pytest.raises(ValueError, match="operands"):
        plan.validate("full")


def test_validate_failing_plan_raises_and_is_not_cached(monkeypatch):
    a_h, b_h, _ = _operands(2)
    api.clear_plan_cache()
    # the executor's ring shifts hop nowhere (g = 2, where a hop is seen):
    # the schedule that would run is not the ring
    monkeypatch.setattr(StackedExecutor, "shift_map",
                        lambda self, m, axis, sign=1: np.asarray(m))
    with pytest.raises(analysis.PlanValidationError) as ei:
        plan_matmul(a_h, b_h, algorithm="ring_c", validate="fast")
    assert "schedule.ppermute-bijection" in str(ei.value)
    assert api.plan_cache_size() == 0      # a failing plan never enters
    monkeypatch.undo()
    plan = plan_matmul(a_h, b_h, algorithm="ring_c", validate="fast")
    assert api.plan_cache_size() == 1
    # the cache-hit path re-validates (memoized) instead of skipping
    plan_b = plan_matmul(a_h, b_h, algorithm="ring_c", validate="full")
    assert plan_b is plan and "full" in plan._validated


def test_validate_records_its_span(operands):
    from repro_torch import obs
    a_h, b_h, _ = operands
    obs.enable(clear=True)
    try:
        plan_matmul(a_h, b_h, algorithm="ring_a", cache=False,
                    validate="full")
    finally:
        obs.disable()
    spans = [e for e in obs.events() if e["name"] == "plan_build.validate"]
    assert len(spans) == 1 and spans[0]["args"]["mode"] == "full"
    assert spans[0]["args"]["algorithm"] == "ring_a"


def test_assignment_injection_validates(operands):
    a_h, b_h, _ = _operands(2)
    plan = plan_matmul(a_h, b_h, algorithm="steal3d", cache=False)
    inj = plan_matmul(a_h, b_h, algorithm="steal3d",
                      assignment=plan.steal.assignment, validate="fast")
    assert inj.steal.assignment is plan.steal.assignment
    assert "fast" in inj._validated


# ---------------------------------------------------------------------------
# source rules
# ---------------------------------------------------------------------------
def test_source_rules_pass_on_the_port(capsys):
    assert source_rules.violations() == []
    assert source_rules.main([]) == 0
    assert "OK" in capsys.readouterr().out


def test_source_rule_registry():
    ids = [r.id for r in source_rules.iter_rules()]
    assert len(ids) == len(set(ids))
    assert set(ids) == {"source.import.repro", "source.import.jax",
                        "source.import-time-build",
                        "source.assignment3d-construction",
                        "source.perf-counter-discipline"}


PLANTED = {
    "source.import.repro": "from repro.core import api\n",
    "source.import.jax": "import jax.numpy as jnp\n",
    "source.import-time-build": "from repro_torch.kernels import loader\n"
                                "LIB = loader.build()\n",
    "source.assignment3d-construction":
        "from repro_torch.core.schedule import Assignment3D\n"
        "def f():\n    return Assignment3D(dev=None)\n",
    "source.perf-counter-discipline":
        "import time\ndef f(fn):\n    t0 = time.perf_counter()\n"
        "    fn()\n    return time.perf_counter() - t0\n",
}


@pytest.mark.parametrize("rule", sorted(PLANTED))
def test_each_source_rule_fires_and_its_waiver_is_specific(rule, tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    bad = pkg / "bad.py"
    bad.write_text(PLANTED[rule])
    hits = source_rules._scan(str(tmp_path))
    assert {h["rule"] for h in hits} == {rule}
    line = hits[0]["line"]
    lines = PLANTED[rule].splitlines()
    other = next(r for r in sorted(PLANTED) if r != rule)
    lines[line - 1] += f"  # analysis: allow({other})"
    bad.write_text("\n".join(lines) + "\n")
    assert {h["rule"] for h in source_rules._scan(str(tmp_path))} == {rule}
    lines[line - 1] += f"  # analysis: allow({rule})"
    bad.write_text("\n".join(lines) + "\n")
    assert rule not in {h["rule"] for h in source_rules._scan(str(tmp_path))}


def test_import_time_build_ignores_function_bodies(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "ok.py").write_text(
        "from repro_torch.kernels import loader\n"
        "def launch():\n    import triton\n    return loader.build()\n")
    assert source_rules._scan(str(tmp_path)) == []


def test_source_rules_list_rules_and_json(tmp_path, capsys):
    assert source_rules.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in source_rules.iter_rules():
        assert rule.id in out
    assert source_rules.main(["--list-rules", "--json"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert {e["rule"] for e in listed} \
        == {r.id for r in source_rules.iter_rules()}
    (tmp_path / "chip_smoke.py").write_text("import repro\n")
    assert source_rules.main(["--json", str(tmp_path)]) == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"]
    assert report["violations"][0] == {
        "file": "chip_smoke.py", "line": 1, "rule": "source.import.repro",
        "desc": "imports repro"}
