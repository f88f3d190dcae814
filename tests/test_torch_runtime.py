"""The port's elastic replanning runtime against the JAX package's.

``repro_torch.runtime``'s ``elastic`` (grid sizing), ``faultinject``
(seeded injectors and straggler drift), ``fit_machine`` (the least-squares
machine fit) and ``replan`` (``ElasticReplanner``) are held against
``repro.runtime`` and ``tools/fit_machine.py``:

* ``choose_mesh_shape`` / ``choose_grid_shape`` equal over counts and
  divisors; the injectors give equal sequences for equal seeds;
* ``fit`` on the same records gives the JAX package's ``net_bw`` and
  ``hop_latency`` (relative 1e-12);
* ``should_replan`` trips equal on identical drift records, and the
  replanner's choice, before and after its refit, equals the JAX
  package's ``auto_select`` under the same ``Machine`` values (the H100
  preset with a 100x network, the elastic selftest's machine); the JAX
  side gets its choice in this process, as ``test_torch_roofline.py``
  does, since its ``plan_matmul`` at g > 1 needs a device mesh;
* ``recover_from_loss`` from g 3 to g 2 on the stacked executor: the
  rebuilt assignment bit-identical to the JAX package's ``assign_3d_lpt``
  on the same cost grid, the result within 1e-5 of the numpy product;
* the real ``ElasticReplanner`` drives the port's ``ServeEngine``: a
  drain and one refit, tokens equal to the run without it;
* ``python -m repro_torch.launch.selftest`` on the CPU, in a subprocess.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.core import api as japi
from repro.core import roofline as jrl
from repro.core import schedule as jsch
from repro.runtime import elastic as jel
from repro.runtime import fault as jfault
from repro.runtime import faultinject as jfi
from repro.runtime import replan as jrp
from repro_torch import obs
from repro_torch.core import api
from repro_torch.core import roofline as trl
from repro_torch.core.api import DistBSR, DistDense, plan_matmul
from repro_torch.core.bsr import rmat_matrix
from repro_torch.runtime import elastic as tel
from repro_torch.runtime import fault as tfault
from repro_torch.runtime import faultinject as tfi
from repro_torch.runtime import fit_machine as tfm
from repro_torch.runtime import replan as trp

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
REL = 1e-12


def jax_machine(m: trl.Machine) -> jrl.Machine:
    return jrl.Machine(**dataclasses.asdict(m))


def fast_net() -> trl.Machine:
    """The elastic selftest's nominal machine on the port's preset."""
    h = trl.H100_SXM
    return dataclasses.replace(h, name="h100-fastnet", net_bw=h.net_bw * 100,
                               hop_latency=1e-9)


@pytest.fixture(autouse=True)
def clean_state():
    """Both packages' drift series, registries and drift baselines start
    and end empty."""
    for o, a in ((obs, api), (jobs, japi)):
        o.reset_all()
        a.set_drift_machine(None)
    yield
    for o, a in ((obs, api), (jobs, japi)):
        o.disable()
        o.reset_all()
        a.set_drift_machine(None)


# ---------------------------------------------------------------------------
# elastic sizing and the injectors
# ---------------------------------------------------------------------------
def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("divisors", [(), (8,), (64,), (7,), (16, 4),
                                      (48, 6), (0, 8)])
@pytest.mark.parametrize("max_model", [1, 8, 16, 64])
def test_choose_mesh_shape_matches_jax(divisors, max_model):
    for n in list(range(1, 70)) + [96, 128, 250, 256, 511, 1000]:
        for prefer in (None, 2, 4, 3):
            kw = dict(model_divisors=divisors, max_model=max_model,
                      prefer_model=prefer)
            assert _outcome(tel.choose_mesh_shape, n, **kw) \
                == _outcome(jel.choose_mesh_shape, n, **kw), (n, kw)


def test_choose_grid_shape_matches_jax():
    for n in list(range(0, 300)) + [10 ** 6, 10 ** 6 - 1, 2 ** 31]:
        for max_g in (None, 1, 2, 5):
            assert _outcome(tel.choose_grid_shape, n, max_g=max_g) \
                == _outcome(jel.choose_grid_shape, n, max_g=max_g)
    for ids in ((0, 3, 4, 5), range(9), (7,), ()):
        assert _outcome(tel.choose_grid_shape, ids) \
            == _outcome(jel.choose_grid_shape, ids)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_injectors_replay_the_jax_sequences(seed):
    kw = dict(factor=8.0, seed=seed, jitter=0.5, start_step=3)
    t, j = tfi.StragglerInjector(2, **kw), jfi.StragglerInjector(2, **kw)
    for step in range(10):
        for dev in range(4):
            assert t.step_time(step, dev, 1.5) == j.step_time(step, dev, 1.5)
            assert t.active(step, dev) == j.active(step, dev)
    for n, k in ((9, 5), (4, 1), (16, 7), (9, 0)):
        t, j = tfi.DeviceLoss(n, k, seed=seed), jfi.DeviceLoss(n, k,
                                                               seed=seed)
        assert (t.lost(), t.survivors()) == (j.lost(), j.survivors())
    assert _outcome(tfi.DeviceLoss, 4, 4) == _outcome(jfi.DeviceLoss, 4, 4)
    assert _outcome(tfi.StragglerInjector, 0, 0.5) \
        == _outcome(jfi.StragglerInjector, 0, 0.5)
    seqs = []
    for mod in (tfi, jfi):
        fail = mod.TransientFailure(fail_on=(2, 4 + seed), message="boom")
        call = fail(lambda x: x + 1)
        seq = []
        for _ in range(8):
            try:
                seq.append(call(1))
            except RuntimeError as e:
                seq.append(str(e))
        seqs.append((seq, fail.calls, fail.failures))
    assert seqs[0] == seqs[1]


# ---------------------------------------------------------------------------
# the machine fit
# ---------------------------------------------------------------------------
def _plans(g=2):
    a_d = rmat_matrix(7, 8, seed=0)
    b = np.random.default_rng(0).standard_normal((128, 16)).astype(
        np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=CPU)
    b_h = DistDense.for_rhs(b, a_h)
    return [plan_matmul(a_h, b_h, algorithm=alg, wire=wire)
            for alg in ("summa_bcast", "summa_ag", "ring_c", "ring_a",
                        "ring_c_bidir")
            for wire in ("padded", "packed")]


def _records(plans, factors):
    out = []
    for n, plan in enumerate(plans):
        pred = plan.predicted_cost(trl.H100_SXM)
        for f in factors:
            out.append({"name": plan.algorithm.name, "cm": plan.cost_model(),
                        "measured": pred * f * (1 + 0.01 * n)})
    return out


@pytest.mark.parametrize("factors", [(8.0,), (3.0, 5.0), (1.5, 40.0)])
def test_fit_matches_jax(factors):
    jfm = jrp._fit_machine()
    recs = _records(_plans(), factors)
    t_recs = [dict(r, alg=api.REGISTRY.get(r["name"])) for r in recs]
    j_recs = [dict(r, alg=japi.REGISTRY.get(r["name"])) for r in recs]
    got, gdiag = tfm.fit(t_recs, trl.H100_SXM)
    want, wdiag = jfm.fit(j_recs, jax_machine(trl.H100_SXM))
    assert got.name == want.name == "h100-sxm-fit"
    for key in ("net_bw", "hop_latency"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=REL)
    assert (gdiag["n_used"], gdiag["n_records"]) \
        == (wdiag["n_used"], wdiag["n_records"])
    assert gdiag["rms_residual_s"] == pytest.approx(
        wdiag["rms_residual_s"], rel=1e-9, abs=1e-30)


def test_fit_needs_two_usable_records_like_jax():
    """Compute-bound ring records are dropped, and a fit from fewer than
    two usable records raises on both sides."""
    jfm = jrp._fit_machine()
    ring = [p for p in _plans() if p.algorithm.name == "ring_c"][:1]
    recs = _records(ring, (1.0,))
    for mod, reg, m in ((tfm, api.REGISTRY, trl.H100_SXM),
                        (jfm, japi.REGISTRY, jax_machine(trl.H100_SXM))):
        with pytest.raises(ValueError, match=">= 2 usable records"):
            mod.fit([dict(r, alg=reg.get(r["name"])) for r in recs], m)


def test_fit_from_registry_reads_the_drift_series():
    plans = _plans()[:4]
    for plan in plans:
        tfi.record_straggler_drift(plan, factor=8.0, n=3)
    fitted, diag = tfm.fit_from_registry()
    assert diag["n_records"] == 12 and diag["n_used"] >= 2
    assert fitted.arith_peak == trl.H100_SXM.arith_peak \
        and fitted.name == "h100-sxm-fit"


# ---------------------------------------------------------------------------
# trips and choices
# ---------------------------------------------------------------------------
def _both_record(name, wire, overlap, pred, meas, cm=None):
    for o in (obs, jobs):
        o.record_drift(name, wire, overlap, predicted_s=pred, measured_s=meas,
                       cm=cm)


SCENARIOS = {
    "healthy": [("ring_c", 1.0, 5)],
    "slow": [("ring_c", 4.0, 5), ("summa_bcast", 1.1, 5)],
    "pessimistic": [("ring_a", 0.2, 4)],
    "warmup": [("ring_c", 9.0, 2)],
    "edge": [("summa_ag", 2.0, 3), ("ring_c_bidir", 0.5, 3)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("detector_events", [0, 2])
def test_should_replan_trips_like_jax(scenario, detector_events):
    dets = []
    for mod in (tfault, jfault):
        det = mod.StragglerDetector(alpha=0.5, threshold=2.0, warmup=3)
        for step in range(8):
            det.observe(step, 1.0 + 0.01 * (step % 2))
        for step in range(detector_events):
            det.observe(8 + step, 50.0)
        dets.append(det)
    for name, ratio, n in SCENARIOS[scenario]:
        for k in range(n):
            _both_record(name, "padded", "auto", 1e-3 * (k + 1),
                         1e-3 * (k + 1) * ratio)
    cfg_kw = dict(drift_ratio=2.0, min_records=3)
    got = trp.ElasticReplanner(config=trp.ReplanConfig(**cfg_kw),
                               detector=dets[0]).should_replan()
    want = jrp.ElasticReplanner(config=jrp.ReplanConfig(**cfg_kw),
                                detector=dets[1]).should_replan()
    assert got == want
    assert obs.registry().snapshot().get("replan.triggered") \
        == jobs.registry().snapshot().get("replan.triggered")


def _choice_operands(kind: str, g: int):
    """(port a, port b, JAX a, JAX b, a numpy, b numpy)."""
    rng = np.random.default_rng(3)
    if kind == "dense":       # the elastic selftest's part 1
        a = rng.standard_normal((64, 64)).astype(np.float32)
        b = rng.standard_normal((64, 32)).astype(np.float32)
        a_t = DistDense.from_global(a, g, device=CPU)
        a_j = japi.DistDense.from_global(jnp.asarray(a), g)
        return (a_t, DistDense.from_global(b, g, device=CPU), a_j,
                japi.DistDense.from_global(jnp.asarray(b), g), a, b)
    scale, bs, width = {"spmm": (7, 4, 16), "spmm_wide": (9, 16, 64)}[kind]
    a = rmat_matrix(scale, 8, seed=1)
    b = rng.standard_normal((a.shape[1], width)).astype(np.float32)
    a_t = DistBSR.from_dense(a, g=g, block_size=bs, device=CPU)
    a_j = japi.DistBSR.from_dense(a, g=g, block_size=bs)
    return (a_t, DistDense.for_rhs(b, a_t), a_j,
            japi.DistDense.for_rhs(jnp.asarray(b), a_j), a, b)


def _replan_against_jax(kind, series):
    """The drift flow with 8x straggler drift on the auto plan's series
    and on ``series``, both sides under the same Machine values; returns
    the port's ``ReplanResult``."""
    a_t, b_t, a_j, b_j, a_np, b_np = _choice_operands(kind, 2)
    # a cached plan keeps the scores of the auto_select that first built
    # it: start from empty caches, so each side's scores are this flow's
    api.clear_plan_cache()
    japi.clear_plan_cache()
    base = fast_net()
    jbase = jax_machine(base)
    api.set_drift_machine(base)
    obs.enable(clear=True)
    p0 = plan_matmul(a_t, b_t, algorithm="auto", machine=base)
    before = japi.auto_select(a_j, b_j, machine=jbase)
    assert (p0.algorithm.name, p0.auto_scores) == before
    plans = [p0] + [plan_matmul(a_t, b_t, algorithm=alg) for alg in series
                    if alg != p0.algorithm.name]
    for plan in plans:
        tfi.record_straggler_drift(plan, factor=8.0, n=4, machine=base)
    # the same records into the JAX series (its plans need a mesh at g = 2)
    for rec in obs.drift_records():
        jobs.record_drift(rec["algorithm"], rec["wire"], rec["overlap"],
                          rec["predicted_s"], rec["measured_s"],
                          cm=rec["cm"])
    rp = trp.ElasticReplanner(machine=base,
                              config=trp.ReplanConfig(drift_ratio=2.0))
    jrpl = jrp.ElasticReplanner(machine=jbase,
                                config=jrp.ReplanConfig(drift_ratio=2.0))
    trips = rp.should_replan()
    assert trips and trips == jrpl.should_replan()
    res = rp.replan(a_t, b_t, trips=trips)
    jfit, _, _ = jrpl.refit(trips)
    for key in ("net_bw", "hop_latency"):
        assert getattr(res.machine, key) == pytest.approx(getattr(jfit, key),
                                                          rel=REL)
    after = japi.auto_select(a_j, b_j, machine=jfit)
    assert (res.algorithm, res.plan.auto_scores) == after
    assert res.evicted > 0 and "fast" in res.plan._validated
    np.testing.assert_allclose(res.plan(a_t, b_t).numpy(), a_np @ b_np,
                               rtol=0, atol=1e-4)
    print(f"{kind}: {p0.algorithm.name} -> {res.algorithm} "
          f"(JAX: {before[0]} -> {after[0]})")
    snap = obs.registry().snapshot()
    for key in ("replan.triggered", "replan.refits", "replan.plans_evicted"):
        assert key in snap, key
    return res


@pytest.mark.parametrize("kind", ["dense", "spmm", "spmm_wide"])
def test_replan_choices_match_jax(kind):
    """The elastic selftest's drift flow (drift on the auto plan's series
    and summa_bcast's): the nominal choice, the trips, the fitted machine
    and the re-selected schedule equal the JAX package's."""
    _replan_against_jax(kind, ("summa_bcast",))


@pytest.mark.parametrize("kind", ["dense", "spmm", "spmm_wide"])
def test_replan_on_two_fitted_series_matches_jax(kind):
    """``chip_smoke.py``'s drift flow (drift on the auto plan's series,
    summa_bcast's and ring_a's): the fit's rows have rank 2, and every
    choice equals the JAX package's."""
    res = _replan_against_jax(kind, ("summa_bcast", "ring_a"))
    assert res.fit_diag["rank"] == 2


def test_fit_rank_tells_proportional_series():
    """summa_ag moves half of summa_bcast's bytes in half its messages: the
    two rows alone determine one direction of (1/net_bw, hop_latency)."""
    plans = {p.algorithm.name: p for p in _plans() if p.wire == "padded"}
    for series, rank in ((("summa_bcast", "summa_ag"), 1),
                         (("summa_bcast", "ring_a"), 2)):
        recs = _records([plans[n] for n in series], (8.0,))
        _, diag = tfm.fit([dict(r, alg=api.REGISTRY.get(r["name"]))
                           for r in recs], trl.H100_SXM)
        assert diag["rank"] == rank, series


def test_replan_refit_raise_is_not_caught():
    """One usable record cannot fit two parameters: the replan raises."""
    plan = _plans()[0]
    tfi.record_straggler_drift(plan, factor=8.0, n=1)
    rp = trp.ElasticReplanner(config=trp.ReplanConfig(min_records=1))
    with pytest.raises(ValueError, match="usable records"):
        rp.replan()


# ---------------------------------------------------------------------------
# recovery from device loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_recover_from_loss_matches_jax_assignment(wire):
    a_d = rmat_matrix(6, 8, seed=0)
    bx = np.random.default_rng(0).standard_normal((64, 48)).astype(
        np.float32)
    a3 = DistBSR.from_dense(a_d, g=3, block_size=4, device=CPU)
    b3 = DistDense.for_rhs(bx, a3)
    p3 = plan_matmul(a3, b3, algorithm="steal3d", validate="fast")
    np.testing.assert_allclose(p3(a3, b3).numpy(), a_d @ bx, rtol=0,
                               atol=1e-5)
    survivors = tfi.DeviceLoss(9, 5, seed=0).survivors()
    assert survivors == jfi.DeviceLoss(9, 5, seed=0).survivors() \
        == (0, 3, 4, 5)
    obs.enable(clear=True)
    rec = trp.ElasticReplanner().recover_from_loss(a3, b3, survivors,
                                                   wire=wire)
    obs.disable()
    assert rec.g == 2 and rec.evicted > 0 and rec.survivors == survivors
    assert "fast" in rec.plan._validated
    # JAX's LPT on the same cost grid (the real blocks of each (i, k) tile
    # of the JAX package's own 2 x 2 tiling of the matrix)
    j2 = japi.DistBSR.from_dense(a_d, g=2, block_size=4)
    cost_ik = np.asarray(j2.grid_structure().real.sum(axis=2),
                         dtype=np.float64)
    np.testing.assert_array_equal(
        cost_ik, rec.a.grid_structure().real.sum(axis=2))
    want = jsch.assign_3d_lpt(
        np.broadcast_to(cost_ik[:, :, None], (2, 2, 2)).copy(), 2,
        locality="locality", comm_penalty=1.0)
    for f in dataclasses.fields(want):
        got_v, want_v = getattr(rec.assignment, f.name), getattr(want, f.name)
        if isinstance(want_v, np.ndarray):
            assert got_v.dtype == want_v.dtype, f.name
            np.testing.assert_array_equal(got_v, want_v, err_msg=f.name)
        else:
            assert got_v == want_v, f.name
    np.testing.assert_allclose(rec.plan(rec.a, rec.b).numpy(), a_d @ bx,
                               rtol=0, atol=1e-5)
    names = {e["name"] for e in obs.events()}
    for span in ("replan.recover", "replan.evict", "replan.reshard",
                 "replan.lpt", "replan.coverage", "plan_build.validate"):
        assert span in names, span
    assert obs.registry().snapshot()["replan.recoveries"] == 1


def test_recover_refuses_a_grid_the_survivors_cannot_hold(monkeypatch):
    """The coverage gate: a 2 x 2 grid on 3 survivors is refused before
    any plan is built (``choose_grid_shape`` never picks one, so it is
    forced here)."""
    from repro_torch.analysis import PlanValidationError
    from repro_torch.runtime import elastic
    a_d = rmat_matrix(5, 8, seed=0)
    a3 = DistBSR.from_dense(a_d, g=3, block_size=4, device=CPU)
    b3 = DistDense.for_rhs(np.ones((32, 8), np.float32), a3)
    monkeypatch.setattr(elastic, "choose_grid_shape",
                        lambda survivors, max_g=None: 2)
    with pytest.raises(PlanValidationError, match="survivor-coverage"):
        trp.ElasticReplanner().recover_from_loss(a3, b3, (0, 1, 2))


# ---------------------------------------------------------------------------
# the real replanner in the serving engine
# ---------------------------------------------------------------------------
def test_serve_engine_with_the_real_replanner():
    """Straggler drift injected after the first prefill: the engine drains
    its in-flight requests, refits once, evicts the tripped schedules'
    plans, and every stream equals the run without a replanner."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeEngine

    cfg = configs.get_config("olmoe-1b-7b", smoke=True)
    params = tf.init_params(cfg, 0, CPU)
    prompts = [np.random.default_rng(k).integers(0, cfg.vocab_size, (n,))
               for k, n in enumerate((9, 16, 5))]

    def run(replanner=None):
        eng = ServeEngine(cfg, params=params, max_batch=2, max_len=32,
                          sparse=True, device=CPU, replanner=replanner)
        if replanner is not None:
            admit, done = eng._admit, []

            def admit_then_drift(req):
                admit(req)
                if not done:
                    plans = {p.algorithm.name: p
                             for p in api._PLAN_CACHE.values()}
                    for plan in plans.values():
                        tfi.record_straggler_drift(plan, factor=8.0, n=4)
                    done.append(sorted(plans))

            eng._admit = admit_then_drift
        for toks in prompts:
            eng.submit(toks, max_new_tokens=4)
        return eng, eng.run()

    base_eng, want = run()
    api.clear_plan_cache()
    rp = trp.ElasticReplanner()
    eng, got = run(rp)
    assert eng.replans == 1 and rp.replans == 0
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    snap = obs.registry().snapshot()
    assert snap["serve.replans"] == 1 and snap["replan.refits"] == 1
    assert snap.get("replan.plans_evicted", 0) > 0


# ---------------------------------------------------------------------------
# the selftest entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("checks", [("spmm", "analysis"), ("elastic",)])
def test_selftest_runs_on_the_cpu(checks):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for check in checks:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.selftest", "--device",
             "cpu", "--g", "2", "--check", check], env=env, cwd=str(ROOT),
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "SELFTEST PASSED" in proc.stdout and "[FAIL]" not in proc.stdout


def test_selftest_exits_non_zero_on_a_failure(monkeypatch, capsys):
    from repro_torch.launch import selftest
    real = api.matmul
    monkeypatch.setattr(api, "matmul",
                        lambda *a, **kw: real(*a, **kw) + 1.0)
    assert selftest.main(["--check", "dense", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "SELFTEST FAILED" in out and "[FAIL] dense/ring_c" in out
