"""Correctness self-test of the distributed engine.

    PYTHONPATH=src python -m repro_torch.launch.selftest --check all --g 3
    PYTHONPATH=src python -m repro_torch.launch.selftest --check spmm \
        --g 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.selftest --mesh --g 2 \
        --devices 4 --device cpu

Port of ``repro/launch/selftest.py``.  Where the JAX package plants fake
host devices and builds a ``g x g`` mesh, the port runs every schedule on
a :class:`~repro_torch.core.executor.StackedExecutor`, all g² tiles on
one device: the card unless ``--device cpu``.  With ``--mesh`` the grid
checks run on a process grid instead, one rank per tile
(``launch/grid.py``, the ``gloo`` transport; on the card, ranks share the
cards and stage their tiles through the host): each rank builds the
operands, every multiply runs with ``mesh=``, and results are gathered
with ``to_global()``.  Each check holds the
distributed results against dense products at the JAX selftest's sizes
and tolerance (1e-4); on the card every sparse multiply runs the CUDA
kernels (B1, and B2 for sparse outputs), and the ``[ref]`` cases run the
plain versions through the same schedules, where the JAX selftest runs
its Pallas kernels in interpret mode.

Checks: ``dense``, ``spmm``, ``spgemm``, ``spgemm_sparse``, ``api`` (plan
reuse, one build, cached placements, the deprecated shims equal to the
plan path), ``balance`` (``balance="rows"`` capacity, the epilogue's
inversion, ``algorithm="auto"``), ``steal3d``, ``wire`` (the packed wire),
``obs`` (spans, trace export, drift records), ``analysis`` (the static
verifier over the dispatch matrix, ``validate="full"``, a miscounted
schedule and a corrupt ring permutation caught), ``elastic`` (straggler
drift trips a refit and a re-selection; a 3x3 grid loses 5 of its 9
devices and recovers onto 2x2 through ``recover_from_loss``), ``moe``
(expert-parallel and ring dispatch on ``--devices`` ranks against the
single-process layer) and ``train_parallel`` (the loss of the model
sharded over a ``(data, model)`` mesh of ``--devices`` ranks against the
single-process loss).  The ``elastic`` check builds its own grids (3 and
2) whatever ``--g`` is; ``moe`` and ``train_parallel`` always run on
ranks (``launch/grid.py``'s ``run_ranks``), ``--devices`` of them, the
rank count of the JAX selftest's ``--devices``.

``--mesh`` runs :data:`MESH_CHECKS` on ranks: the grid checks and
``analysis`` on a ``g x g`` grid (the verifier on the ranks' plans),
``elastic`` on a 3x3 grid that recovers onto its survivors' 2x2, and
``moe`` and ``train_parallel`` on ``--devices`` ranks.

Every failed check prints ``[FAIL]``; the run ends with ``SELFTEST
PASSED`` (exit 0) or ``SELFTEST FAILED: [...]`` (exit 1).  Nothing is
caught: an exception ends the run with its traceback and a non-zero
exit.  The one ``except`` is the expected refusal of a miscounted plan by
``validate="full"``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

CHECKS = ("dense", "spmm", "spgemm", "spgemm_sparse", "api", "balance",
          "steal3d", "wire", "moe", "train_parallel", "obs", "analysis",
          "elastic")
# the checks that run on ranks (--mesh), and the seconds after which a
# grid that has not finished them is killed (they take ~10)
MESH_CHECKS = ("dense", "spmm", "spgemm", "spgemm_sparse", "api", "balance",
               "steal3d", "wire", "moe", "train_parallel", "obs",
               "analysis", "elastic")
# the checks that spawn their own ranks, and the grid checks' own grids
RANK_CHECKS = ("moe", "train_parallel")
MESH_TIMEOUT_S = 600.0


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--g", type=int, default=2,
                   help="grid size of the grid checks (g x g tiles)")
    p.add_argument("--check", default="all", choices=("all",) + CHECKS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", action="store_true",
                   help="run the checks on ranks: the grid checks on a "
                        "process grid of g x g ranks (gloo)")
    p.add_argument("--devices", type=int, default=4,
                   help="ranks of the moe and train_parallel checks")
    return p.parse_args(argv)


class _Checks:
    """Prints each check's verdict and collects the failures."""

    def __init__(self):
        self.failures: List[str] = []

    def close(self, name: str, got, want, tol: float = 1e-4) -> None:
        got = _value(got)
        err = float(np.max(np.abs(got - np.asarray(want)), initial=0.0))
        ok = err <= tol and got.shape == np.asarray(want).shape
        print(f"  [{'ok' if ok else 'FAIL'}] {name:34s} max|err|={err:.3e}",
              flush=True)
        if not ok:
            self.failures.append(name)

    def flag(self, name: str, ok: bool) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {name}", flush=True)
        if not ok:
            self.failures.append(name)


def _value(x) -> np.ndarray:
    """A result as a host array: a rank's tile gathered first (collective
    on a process grid)."""
    if hasattr(x, "to_global"):
        x = x.to_global()
    if hasattr(x, "densify"):
        x = x.densify()
    return x.detach().float().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def _entry_points(mesh):
    """``matmul`` and ``plan_matmul``, on ``mesh``'s ranks when given."""
    import functools

    from repro_torch.core import api
    if mesh is None:
        return api.matmul, api.plan_matmul
    return (functools.partial(api.matmul, mesh=mesh),
            functools.partial(api.plan_matmul, mesh=mesh))


def check_dense(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, _ = _entry_points(mesh)
    print(f"== dense matmul on a {g}x{g} grid ==")
    # odd shapes exercise the shared pad/crop epilogue on the dense path
    a = rng.standard_normal((23, 19)).astype(np.float32)
    b = rng.standard_normal((19, 11)).astype(np.float32)
    for alg in api.algorithms():
        ck.close(f"dense/{alg}",
                 mm(a, b, g=g, algorithm=alg, device=dev), a @ b)


def check_spmm(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import random_sparse
    print(f"== spmm on a {g}x{g} grid ==")
    a_d = random_sparse(32, 32, 0.2, seed=seed)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    for alg in api.algorithms():
        ck.close(f"spmm/{alg}", mm(a_h, b_h, algorithm=alg),
                 a_d @ b)
    ck.close("spmm/ring_c[ref]",
             mm(a_h, b_h, algorithm="ring_c", impl="ref"), a_d @ b)


def check_spgemm(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR
    from repro_torch.core.bsr import random_sparse
    print(f"== spgemm on a {g}x{g} grid ==")
    a_d = random_sparse(32, 32, 0.15, seed=seed + 1)
    b_d = random_sparse(32, 32, 0.2, seed=seed + 2)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistBSR.from_dense(b_d, g=g, block_size=4, device=dev)
    for alg in api.algorithms():
        ck.close(f"spgemm/{alg}", mm(a_h, b_h, algorithm=alg),
                 a_d @ b_d)


def check_spgemm_sparse(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR
    from repro_torch.core.bsr import random_sparse
    print(f"== sparse-output spgemm on a {g}x{g} grid ==")
    a_d = random_sparse(32, 32, 0.15, seed=seed + 4)
    b_d = random_sparse(32, 32, 0.2, seed=seed + 5)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistBSR.from_dense(b_d, g=g, block_size=4, device=dev)
    want = a_d @ b_d
    for alg in api.sparse_algorithms():
        c = mm(a_h, b_h, algorithm=alg, output="sparse")
        ck.close(f"spgemm_sparse/{alg}", c.densify(), want)
    ck.flag("spgemm_sparse/returns_handle",
            isinstance(mm(a_h, b_h, algorithm="ring_c",
                                  output="sparse"), DistBSR))
    # the chained cube stays packed: the product handle is the operand
    c2 = mm(a_h, a_h, algorithm="ring_c", output="sparse")
    c3 = mm(c2, a_h, algorithm="ring_c", output="sparse")
    ck.close("spgemm_sparse/chain_cube", c3.densify(), a_d @ a_d @ a_d,
             tol=1e-3)
    ck.close("spgemm_sparse/ring_c[ref]",
             mm(a_h, b_h, algorithm="ring_c", impl="ref",
                        output="sparse").densify(), want)


def check_balance(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import rmat_matrix
    print(f"== balanced tiling + auto-scheduling on a {g}x{g} grid ==")
    a_d = rmat_matrix(scale=6, edgefactor=8, seed=seed)        # skewed
    b = rng.standard_normal((64, 8)).astype(np.float32)
    h_none = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    h_rows = DistBSR.from_dense(a_d, g=g, block_size=4, balance="rows",
                                device=dev)
    ck.flag(f"balance/capacity ({h_rows.capacity} <= {h_none.capacity})",
            h_rows.capacity <= h_none.capacity)
    want = a_d @ b
    b_h = DistDense.for_rhs(b, h_rows)
    for alg in api.algorithms():
        ck.close(f"balance/{alg}", mm(h_rows, b_h, algorithm=alg),
                 want)
    plan = pm(h_rows, b_h, algorithm="auto")
    ck.close(f"balance/auto[{plan.algorithm.name}]", plan(h_rows, b_h),
             want)
    ck.flag("balance/auto_scores_recorded",
            plan.auto_scores is not None and plan.algorithm.name
            == min(plan.auto_scores, key=plan.auto_scores.get))


def check_steal3d(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import random_sparse, rmat_matrix
    print(f"== steal3d static work-grid dispatch on a {g}x{g} grid ==")
    a_d = rmat_matrix(scale=6, edgefactor=8, seed=seed)        # skewed
    b = rng.standard_normal((64, 8)).astype(np.float32)
    b_sp = random_sparse(64, 64, 0.1, seed=seed + 6)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    b_sph = DistBSR.from_dense(b_sp, g=g, block_size=4, device=dev)
    plan = pm(a_h, b_h, algorithm="steal3d")
    asg = plan.steal.assignment
    ck.flag(f"steal3d/makespan<=owner ({asg.makespan:.0f} <= "
            f"{asg.owner_makespan:.0f}, moved={asg.n_moved})",
            asg.makespan <= asg.owner_makespan)
    ck.close("steal3d/spmm", plan(a_h, b_h), a_d @ b)
    ck.close("steal3d/spmm_vs_ring_c", plan(a_h, b_h),
             _value(mm(a_h, b_h, algorithm="ring_c")))
    ck.close("steal3d/spgemm",
             mm(a_h, b_sph, algorithm="steal3d"), a_d @ b_sp)
    da = rng.standard_normal((23, 19)).astype(np.float32)
    db = rng.standard_normal((19, 11)).astype(np.float32)
    ck.close("steal3d/dense",
             mm(da, db, g=g, algorithm="steal3d", device=dev),
             da @ db)
    ck.close("steal3d/spmm[ref]",
             mm(a_h, b_h, algorithm="steal3d", impl="ref"), a_d @ b)
    # empty operand (capacity 0) end to end
    e_h = DistBSR.from_dense(np.zeros((64, 64), np.float32), g=g,
                             block_size=4, device=dev)
    ck.flag(f"steal3d/empty_capacity_0 (cap={e_h.capacity})",
            e_h.capacity == 0)
    ck.close("steal3d/empty_operand",
             mm(e_h, b_h, algorithm="steal3d"),
             np.zeros((64, 8), np.float32))


def check_wire(ck, g, dev, rng, seed, mesh=None):
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import random_sparse, rmat_matrix
    print(f"== packed wire format on a {g}x{g} grid ==")
    a_d = rmat_matrix(scale=6, edgefactor=8, seed=seed)        # skewed
    b = rng.standard_normal((64, 8)).astype(np.float32)
    b_sp = random_sparse(64, 64, 0.08, seed=seed + 9)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    b_sph = DistBSR.from_dense(b_sp, g=g, block_size=4, device=dev)
    for alg in api.algorithms():
        plan = pm(a_h, b_h, algorithm=alg, wire="packed")
        ck.close(f"wire/spmm/{alg}[{plan.wire}]", plan(a_h, b_h), a_d @ b)
        plan_sp = pm(a_h, b_sph, algorithm=alg, wire="packed")
        ck.close(f"wire/spgemm/{alg}[{plan_sp.wire}]", plan_sp(a_h, b_sph),
                 a_d @ b_sp)
        if plan.wire == "packed":
            pad = pm(a_h, b_h, algorithm=alg, wire="padded")
            bp = plan.cost_model()["total_net_bytes"]
            bd = pad.cost_model()["total_net_bytes"]
            ck.flag(f"wire/bytes/{alg} ({bp:.0f} <= {bd:.0f})", bp <= bd)
    for alg in api.sparse_algorithms():
        plan = pm(a_h, b_sph, algorithm=alg, output="sparse")
        ck.flag(f"wire/sparse_output/{alg}_auto_packs",
                plan.wire == "packed")
        ck.close(f"wire/sparse_output/{alg}", plan(a_h, b_sph).densify(),
                 a_d @ b_sp)
    ck.close("wire/spmm/ring_c[ref]",
             mm(a_h, b_h, algorithm="ring_c", impl="ref",
                        wire="packed"), a_d @ b)


def check_api(ck, g, dev, rng, seed, mesh=None):
    import warnings

    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core import spmm as legacy
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import random_sparse
    print(f"== plan-based API invariants on a {g}x{g} grid ==")
    a_d = random_sparse(32, 32, 0.2, seed=seed + 3)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    api.clear_plan_cache()
    plan = pm(a_h, b_h, algorithm="ring_c")
    outs = [plan(a_h, b_h) for _ in range(5)]
    ck.close("api/plan_result", outs[-1], a_d @ b)
    ck.flag(f"api/plan_builds_once (traces={plan.traces})",
            plan.traces == 1)
    got_new = _value(mm(a_h, b_h, algorithm="ring_c"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got_old = _value(legacy.spmm(a_h.tiled, b_h, algorithm="ring_c"))
    if mesh is None:
        ck.flag("api/placement_cached",
                a_h.placed("skew_rows") is a_h.placed("skew_rows"))
        ck.flag("api/shim_bit_identical", bool((got_new == got_old).all()))
    else:
        # the rank loaded one tile of each operand, once; the shim runs
        # stacked, where the same kernel sums each tile in the same order
        ck.flag("api/rank_tiles_loaded_once",
                len(a_h._rank_trees) == len(b_h._rank_trees) == 1)
        ck.flag("api/grid_equals_stacked_shim",
                bool((got_new == got_old).all()))
    # the shim's stacked plan is a second entry on a grid
    ck.flag(f"api/shared_plan_cache (size={api.plan_cache_size()})",
            api.plan_cache_size() == (1 if mesh is None else 2))


def check_analysis(ck, g, dev, rng, seed, mesh=None):
    import dataclasses

    from repro_torch import analysis
    from repro_torch.core import api
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import random_sparse, rmat_matrix
    _, pm = _entry_points(mesh)
    check, lint = (analysis.check_rank_plan, analysis.lint_rank_plan) \
        if mesh is not None else (analysis.check_plan, analysis.lint_plan)
    print(f"== static plan verification on a {g}x{g} grid ==")
    a_d = rmat_matrix(scale=6, edgefactor=8, seed=seed)        # skewed
    b = rng.standard_normal((64, 8)).astype(np.float32)
    b_sp = random_sparse(64, 64, 0.1, seed=seed + 7)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    b_sph = DistBSR.from_dense(b_sp, g=g, block_size=4, device=dev)
    # healthy plans across the dispatch matrix prove clean (the shift-count
    # rule has teeth from g = 2 on)
    combos = []
    for alg in api.algorithms():
        for wire in ("padded", "packed"):
            for ov in ("off", "on"):
                combos.append((alg, b_h, "dense", wire, ov))
        combos.append((alg, b_sph, "dense", "padded", "off"))
    for alg in api.sparse_algorithms():
        combos.append((alg, b_sph, "sparse", "packed", "off"))
    n_findings = 0
    for alg, rhs, out, wire, ov in combos:
        plan = pm(a_h, rhs, algorithm=alg, output=out, wire=wire,
                  overlap=ov)
        fs = check(plan, a_h, rhs) + lint(plan, a_h, rhs)
        for f in fs:
            print(f"    finding [{alg}/{out}/{wire}/ov={ov}]: {f}")
        n_findings += len(fs)
    ck.flag(f"analysis/healthy_matrix_clean ({len(combos)} plans)",
            n_findings == 0)
    plan = pm(a_h, b_h, algorithm="ring_c", validate="full")
    ck.flag("analysis/validate_full_passes",
            {"fast", "full"} <= plan._validated)
    # a schedule charging the wrong message count is caught by the
    # executor's shift count (g >= 2: at g = 1 the ring perms alias)
    bad = dataclasses.replace(api.REGISTRY.get("ring_c"), name="bad_msgs",
                              msgs_per_step=7)
    api.REGISTRY.register(bad)
    try:
        plan = pm(a_h, b_h, algorithm="bad_msgs", cache=False)
        fs = lint(plan, a_h, b_h)
        drift_seen = any(f.rule == "optrace.shift-count" for f in fs)
        ck.flag("analysis/shift_count_drift_caught",
                drift_seen or g < 2)
        raised = False
        try:
            pm(a_h, b_h, algorithm="bad_msgs", cache=False,
               validate="full")
        except analysis.PlanValidationError as e:
            raised = any(f.rule == "optrace.shift-count"
                         for f in e.findings)
        ck.flag("analysis/validate_full_raises_on_drift", raised or g < 2)
    finally:
        api.REGISTRY.unregister("bad_msgs")
    # a corrupted ring shift at the real grid size: every position reads
    # tile 0, so the step maps are no permutation
    plan = pm(a_h, b_h, algorithm="ring_c", cache=False)
    plan.executor.shift_map = lambda m, axis, sign=1: np.zeros_like(
        np.asarray(m))
    try:
        fs = check(plan, a_h, b_h)
    finally:
        del plan.executor.shift_map
    ck.flag("analysis/corrupt_perm_caught",
            any(f.rule == "schedule.ppermute-bijection" for f in fs)
            or g < 2)


def check_obs(ck, g, dev, rng, seed, mesh=None):
    import json
    import os
    import tempfile

    from repro_torch import obs
    from repro_torch.core import api
    mm, pm = _entry_points(mesh)
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import random_sparse
    print("== execution tracing + drift tracking ==")
    a_d = random_sparse(32, 32, 0.2, seed=seed + 6)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    # one tile (g = 1) stacked; the grid's own g on ranks
    a_h = DistBSR.from_dense(a_d, g=1 if mesh is None else g, block_size=4,
                             device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    obs.enable(clear=True)
    obs.reset_drift()
    try:
        plan = pm(a_h, b_h, algorithm="ring_c", cache=False)
        for _ in range(3):
            out = plan(a_h, b_h)
    finally:
        obs.disable()
    ck.close("obs/traced_result", out, a_d @ b)
    names = {e["name"] for e in obs.events()}
    ck.flag("obs/plan_build_span", "plan_build" in names)
    ck.flag("obs/multiply_span", "multiply.ring_c" in names)
    if mesh is not None:
        spans = [e for e in obs.events() if e["name"] == "multiply.ring_c"]
        ck.flag("obs/spans_carry_the_rank",
                all(e["args"].get("rank") == mesh.rank for e in spans))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        obs.export_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    ck.flag("obs/trace_schema_valid", not obs.validate_trace(trace))
    drift = obs.drift_report()
    if mesh is None or mesh.rank == 0:
        ck.flag(f"obs/drift_recorded ({len(drift)} keys)",
                any(d["n"] >= 3 for d in drift.values()))
    else:                          # rank 0 records the grid's drift
        ck.flag("obs/drift_on_rank_0_only", not drift)
    ck.flag("obs/disabled_is_noop", obs.span("x") is obs.span("y"))


def fast_net_machine():
    """The elastic check's nominal machine: the H100 preset with a network
    100x faster and a 1 ns hop, so a bandwidth-hungry schedule wins at
    plan time (the JAX selftest does the same to its TPU preset)."""
    import dataclasses

    from repro_torch.core import roofline
    h = roofline.H100_SXM
    return dataclasses.replace(h, name="h100-fastnet", net_bw=h.net_bw * 100,
                               hop_latency=1e-9)


def check_elastic(ck, g, dev, rng, seed, mesh=None):
    """Part 1 on a 2x2 grid (on ranks: the first four of ``mesh``'s 3x3),
    part 2 on a 3x3 grid that loses 5 devices (on ranks: ``mesh``, which
    recovers onto its survivors')."""
    from repro_torch import obs
    from repro_torch.core import api
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import rmat_matrix
    from repro_torch.core.executor import sub_grid
    from repro_torch.runtime.faultinject import (DeviceLoss,
                                                 record_straggler_drift)
    from repro_torch.runtime.replan import ElasticReplanner, ReplanConfig
    print("== elastic replanning: drift re-selection + grid shrink ==")
    # -- part 1: straggler drift trips a re-fit and a re-selection
    a_np = rng.standard_normal((64, 64)).astype(np.float32)
    b_np = rng.standard_normal((64, 32)).astype(np.float32)
    a = DistDense.from_global(a_np, 2, device=dev)
    b = DistDense.from_global(b_np, 2, device=dev)
    # on ranks every one makes the 2x2 grid; four of them run part 1
    mesh2 = None if mesh is None else sub_grid(mesh, range(4))
    _, pm = _entry_points(mesh2)
    base = fast_net_machine()
    obs.reset_all()
    obs.enable(clear=True)
    api.set_drift_machine(base)
    rp = ElasticReplanner(machine=base, config=ReplanConfig(drift_ratio=2.0))
    try:
        if mesh is None or mesh2 is not None:
            p0 = pm(a, b, algorithm="auto", machine=base)
            ref = a_np @ b_np
            ck.close("elastic/nominal_result", p0(a, b), ref)
            # straggling network: measured steps 8x the prediction, on two
            # algorithm series so the machine re-fit is well conditioned
            p_alt = pm(a, b, algorithm="summa_bcast")
            record_straggler_drift(p0, factor=8.0, n=4, machine=base)
            record_straggler_drift(p_alt, factor=8.0, n=4, machine=base)
            trips = rp.should_replan()
            ck.flag(f"elastic/drift_trips ({sorted(trips)})", bool(trips))
            res = rp.replan(a, b, **({} if mesh2 is None
                                     else {"mesh": mesh2}))
            ck.flag(f"elastic/reselect_flips ({p0.algorithm.name} -> "
                    f"{res.algorithm}, evicted={res.evicted})",
                    res.algorithm != p0.algorithm.name and res.evicted > 0)
            ck.close("elastic/replanned_result", res.plan(a, b), ref)

        # -- part 2: device loss -> grid shrink -> rebuilt steal plan
        _, pm = _entry_points(mesh)
        a_d = rmat_matrix(scale=6, edgefactor=8, seed=seed)
        bx = rng.standard_normal((64, 48)).astype(np.float32)
        a3 = DistBSR.from_dense(a_d, g=3, block_size=4, device=dev)
        b3 = DistDense.for_rhs(bx, a3)
        p3 = pm(a3, b3, algorithm="steal3d", validate="fast")
        want = a_d @ bx
        ck.close("elastic/preloss_result", p3(a3, b3), want)
        loss = DeviceLoss(9, 5, seed=seed)
        rec = rp.recover_from_loss(a3, b3, loss.survivors(), mesh=mesh)
        ck.flag(f"elastic/shrink_3x3_to_2x2 (survivors={loss.survivors()}, "
                f"g={rec.g}, evicted={rec.evicted})",
                rec.g == 2 and rec.evicted > 0)
        if rec.plan is not None:        # a rank outside the new grid idles
            ck.close("elastic/recovered_result", rec.plan(rec.a, rec.b),
                     want)
        snap = obs.registry().snapshot()
        wanted = ("replan.triggered", "replan.refits",
                  "replan.plans_evicted", "replan.recoveries") \
            if mesh is None or mesh2 is not None else ("replan.recoveries",)
        missing = [k for k in wanted if k not in snap]
        ck.flag(f"elastic/metrics_recorded (missing={missing})",
                not missing)
    finally:
        api.set_drift_machine(None)
        obs.disable()


_RUN = {"dense": check_dense, "spmm": check_spmm, "spgemm": check_spgemm,
        "spgemm_sparse": check_spgemm_sparse, "balance": check_balance,
        "steal3d": check_steal3d, "wire": check_wire, "api": check_api,
        "analysis": check_analysis, "obs": check_obs,
        "elastic": check_elastic}


def mesh_checks(ex, names: List[str], seed: int) -> List[str]:
    """The checks ``names`` on this rank of a process grid (the rank
    function of ``--mesh``): operands on the host, every multiply on the
    grid.  Rank 0 prints; every rank returns its failures."""
    import contextlib
    import io

    import torch
    rng = np.random.default_rng(seed)
    ck = _Checks()
    quiet = contextlib.redirect_stdout(io.StringIO()) if ex.rank \
        else contextlib.nullcontext()
    with quiet:
        for name in names:
            _RUN[name](ck, ex.g, torch.device("cpu"), rng, seed, mesh=ex)
    return [f"rank {ex.rank}: {f}" for f in ck.failures]


def check_moe(ck, devices: int, device) -> None:
    from repro_torch.models import moe
    print(f"== MoE dispatch/combine on {devices} ranks ==")
    ck.flag("moe/expert_parallel",
            moe.selftest_distributed(devices, device=device))
    ck.flag("moe/ring_dispatch", moe.selftest_ring(devices, device=device))


def check_train_parallel(ck, devices: int, device) -> None:
    from repro_torch.launch.train import selftest_parallel_equivalence
    print(f"== data/tensor-parallel loss equivalence on {devices} ranks ==")
    ck.flag("train/dp_tp_equivalence",
            selftest_parallel_equivalence(devices, device=device))


def _rank_checks(ck, names, args) -> None:
    if "moe" in names:
        check_moe(ck, args.devices, args.device)
    if "train_parallel" in names:
        check_train_parallel(ck, args.devices, args.device)


def _main_mesh(args) -> int:
    from repro_torch.launch.grid import run_grid
    names = [n for n in MESH_CHECKS if args.check in ("all", n)]
    if not names:
        raise SystemExit(f"--mesh runs the checks {MESH_CHECKS}, not "
                         f"{args.check!r}")
    # the ranks import this module by name (never as __main__)
    from repro_torch.launch import selftest
    failures: List[str] = []
    grid = [n for n in names if n not in RANK_CHECKS + ("elastic",)]
    where = args.device or "the card"
    if grid:
        print(f"== {args.g}x{args.g} process grid: {args.g ** 2} gloo ranks "
              f"on {where} ==", flush=True)
        per_rank = run_grid(args.g, selftest.mesh_checks, grid, args.seed,
                            backend="gloo", device=args.device,
                            timeout_s=MESH_TIMEOUT_S)
        failures += [f for fails in per_rank for f in fails]
    if "elastic" in names:
        print(f"== 3x3 process grid: 9 gloo ranks on {where} ==",
              flush=True)
        per_rank = run_grid(3, selftest.mesh_checks, ["elastic"], args.seed,
                            backend="gloo", device=args.device,
                            timeout_s=MESH_TIMEOUT_S)
        failures += [f for fails in per_rank for f in fails]
    ck = _Checks()
    _rank_checks(ck, names, args)
    failures += ck.failures
    if failures:
        print(f"SELFTEST FAILED: {failures}")
        return 1
    print("SELFTEST PASSED")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.mesh:
        return _main_mesh(args)
    from repro_torch.runtime.device import resolve_device, strict_fp32
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        strict_fp32()
    rng = np.random.default_rng(args.seed)
    ck = _Checks()
    for name in CHECKS:
        if args.check not in ("all", name):
            continue
        if name in RANK_CHECKS:
            _rank_checks(ck, [name], args)
        else:
            _RUN[name](ck, args.g, dev, rng, args.seed)
    if ck.failures:
        print(f"SELFTEST FAILED: {ck.failures}")
        return 1
    print("SELFTEST PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
