"""The port's observability layer (``repro_torch.obs``) and its hooks in the
plan API, against the JAX package's (``repro.obs``).

The jax-free cases of ``test_obs.py`` run on the port's copy: disabled
tracing is one shared no-op, spans nest and are thread-safe, the Chrome
trace exports and validates, the registry's series, snapshots, resets and
callbacks, histogram percentiles, and drift's ratio (geometric mean of
measured/predicted) and RMSE.  The plan cases run the same sequence of
plans through both packages with tracing on and hold the span names (in
order; the port's own phase and launch spans aside) and the drift
records' keys equal; with tracing off a multiply records nothing, reads
no clock and waits for nothing.  The port's own: call scopes and launch
numbers, CUDA event pairs read only when the events are read, pending
drift timings read by the report, and the trace's clock against the
profiler's.
"""
import json
import math
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.core import api as japi
from repro.core import roofline as jrl
from repro_torch import obs
from repro_torch.core import api as tapi
from repro_torch.core import roofline as trl
from repro_torch.core.api import DistBSR, DistDense
from repro_torch.core.bsr import random_sparse

CPU = torch.device("cpu")
# the port's own spans, which the JAX package does not record: matmul's
# coercion, a multiply's host phases and each B1 launch
PORT_SPANS = {"matmul.coerce", "multiply.place", "multiply.body",
              "multiply.epilogue", "kernel.bsr_spmm"}


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Tracing and drift state are process-global: leave them as found."""
    for o in (obs, jobs):
        o.disable()
        o.clear_trace()
        o.reset_drift()
    yield
    for o in (obs, jobs):
        o.disable()
        o.clear_trace()
        o.reset_drift()


# ---------------------------------------------------------------------------
# tracing: disabled no-op, nesting, threads, export schema
# ---------------------------------------------------------------------------
def test_disabled_span_is_shared_noop():
    assert not obs.enabled()
    s1, s2 = obs.span("a", k=1), obs.span("b")
    assert s1 is s2
    with s1 as sp:
        sp.note(extra="ignored")
    assert obs.events() == []


def test_spans_nest_with_containment_and_depth():
    obs.enable(clear=True)
    with obs.span("outer", phase="build"):
        with obs.span("inner"):
            pass
        with obs.span("inner"):
            pass
    obs.disable()
    evs = obs.events()
    assert [e["name"] for e in evs] == ["inner", "inner", "outer"]
    outer = evs[-1]
    assert outer["args"]["depth"] == 0 and outer["args"]["phase"] == "build"
    for inner in evs[:2]:
        assert inner["args"]["depth"] == 1
        assert inner["ts"] >= outer["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_span_note_and_instant():
    obs.enable(clear=True)
    with obs.span("x", a=1) as sp:
        sp.note(b=2)
        obs.instant("marker", n=3)
    obs.disable()
    marker, ev = obs.events()
    assert ev["args"]["a"] == 1 and ev["args"]["b"] == 2
    assert marker["name"] == "marker" and marker["dur"] == 0.0
    assert marker["args"] == {"n": 3}


def test_tracing_is_thread_safe():
    obs.enable(clear=True)
    n_threads, per_thread = 8, 50

    def work(i):
        for j in range(per_thread):
            with obs.span(f"t{i}", j=j):
                pass

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    obs.disable()
    evs = obs.events()
    assert len(evs) == n_threads * per_thread
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], set()).add(e["tid"])
    assert len(by_name) == n_threads
    assert all(len(v) == 1 for v in by_name.values())


def test_export_trace_roundtrips_valid_chrome_json(tmp_path):
    obs.enable(clear=True)
    with obs.span("s", tag="v"):
        obs.instant("marker", n=3)
    obs.disable()
    path = tmp_path / "trace.json"
    obs.export_trace(str(path))
    trace = json.loads(path.read_text())
    assert obs.validate_trace(trace) == []
    assert trace["displayTimeUnit"] == "ms"
    assert trace["otherData"]["dropped_events"] == 0
    for ev in trace["traceEvents"]:
        for k in obs.REQUIRED_EVENT_KEYS:
            assert k in ev
    assert obs.REQUIRED_EVENT_KEYS == jobs.REQUIRED_EVENT_KEYS


def test_validate_trace_flags_schema_violations():
    assert obs.validate_trace({}) == ["traceEvents missing or not a list"]
    bad = {"traceEvents": [{"ph": "X", "ts": "zero", "dur": 1.0,
                            "name": "x", "pid": 0}]}
    problems = obs.validate_trace(bad)
    assert problems == jobs.validate_trace(bad)
    assert any("missing key 'tid'" in p for p in problems)
    assert any("ts not numeric" in p for p in problems)


def test_clear_trace_and_enable_clear():
    obs.enable(clear=True)
    with obs.span("a"):
        pass
    assert len(obs.events()) == 1
    obs.enable(clear=True)
    assert obs.events() == []
    obs.disable()


def test_sync_elapsed_and_timed_on_cpu_tensors():
    x = torch.ones(4)
    assert obs.sync_elapsed(0.0, {"a": [x, (x,)]}) > 0
    assert obs.timed(lambda: x + 1, repeats=3, warmup=1) >= 0


def test_disabled_call_and_launch_are_the_shared_noop():
    assert not obs.enabled()
    assert obs.call() is obs.launch("k", device=torch.zeros(1)) \
        is obs.span("s", device=torch.zeros(1))
    with obs.call():
        with obs.launch("k"):
            obs.instant("m")
    assert obs.events() == []


def test_call_scope_numbers_its_spans_and_launches():
    """Spans and markers inside a call carry its id; a nested scope joins
    the open one; launches count from 0 in each call; the next call takes
    the next id."""
    obs.enable(clear=True)
    with obs.span("outside"):
        pass
    with obs.call():
        with obs.call():
            with obs.launch("k"):
                pass
            with obs.launch("k"):
                pass
        obs.instant("mark")
    with obs.call():
        with obs.launch("k"):
            pass
    obs.disable()
    outside, k0, k1, mark, k2 = obs.events()
    assert "call" not in outside["args"]
    assert k0["args"]["call"] == k1["args"]["call"] == mark["args"]["call"]
    assert k2["args"]["call"] == k0["args"]["call"] + 1
    assert [k["args"]["launch"] for k in (k0, k1, k2)] == [0, 1, 0]


def test_device_pair_is_read_only_when_events_are_read(monkeypatch):
    """A span given a card's device times it with an event pair on the
    device's current stream, read into ``device_ms`` by ``events()`` (once)
    and not when the span closes; a CPU tensor gives no pair."""
    reads = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.stream = None

        def record(self, stream):
            self.stream = stream

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            reads.append((self.stream, end.stream))
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: f"stream of {dev}")
    obs.enable(clear=True)
    with obs.call():
        with obs.launch("kernel.k", device=torch.device("cuda", 0)) as sp:
            assert sp.pair is not None
        with obs.span("host", device=torch.zeros(1)) as host:
            assert host.pair is None
    obs.disable()
    assert reads == []
    kern, host = obs.events()
    assert reads == [("stream of cuda:0", "stream of cuda:0")]
    assert kern["args"]["device_ms"] == 2.5 and kern["args"]["launch"] == 0
    assert "device_ms" not in host["args"]
    trace = obs.export_trace()
    assert len(reads) == 1 and obs.validate_trace(trace) == []


def test_span_lands_on_the_profilers_clock(tmp_path):
    """A span opened inside a ``record_function`` range (after a warm-up
    range: the profiler stamps its first range early) lies within 200 us
    of that range in the profiler's Chrome export: both count ``ts`` from
    their ``baseTimeNanoseconds``, in Unix time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    obs.enable(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with record_function("range"):
            with obs.span("inside"):
                pass
    obs.disable()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    theirs = json.loads(path.read_text())
    (rng,) = [e for e in theirs["traceEvents"] if e.get("name") == "range"]
    ours = obs.export_trace()
    (ev,) = [e for e in ours["traceEvents"] if e["name"] == "inside"]
    # whole ns for the bases, so the difference keeps its precision
    base_ns = ours["baseTimeNanoseconds"] - int(theirs["baseTimeNanoseconds"])
    start_us = base_ns / 1e3 + ev["ts"] - float(rng["ts"])
    end_us = start_us + ev["dur"] - float(rng["dur"])
    assert abs(start_us) < 200 and abs(end_us) < 200, (start_us, end_us)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_registry_instrument_identity_and_labels():
    reg = obs.MetricsRegistry()
    c = reg.counter("hits", cache="plans")
    c.inc()
    c.inc(2.5)
    assert reg.counter("hits", cache="plans") is c
    other = reg.counter("hits", cache="symbolic")
    assert other is not c and other.value == 0.0
    assert c.value == 3.5
    assert len(reg.series("hits")) == 2


def test_registry_snapshot_rendering_matches_jax():
    snaps = []
    for o in (obs, jobs):
        reg = o.MetricsRegistry()
        reg.counter("n").inc(4)
        reg.gauge("level").set(0.5)
        h = reg.histogram("lat", path="decode")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        snaps.append(reg.snapshot())
    snap = snaps[0]
    assert snap == snaps[1]
    assert snap["n"] == 4 and snap["level"] == 0.5
    row = snap["lat"]["path=decode"]
    assert row["count"] == 4 and row["sum"] == 10.0
    assert row["mean"] == 2.5 and row["min"] == 1.0 and row["max"] == 4.0
    assert row["p50"] == 2.5


def test_registry_reset_keeps_registrations_and_callbacks():
    reg = obs.MetricsRegistry()
    c = reg.counter("n")
    c.inc(7)
    reg.register_callback("pull", lambda: {"x": 1})
    reg.reset()
    assert reg.counter("n") is c and c.value == 0.0
    assert reg.snapshot() == {"n": 0.0, "pull": {"x": 1}}


def test_registry_kind_conflict_raises():
    reg = obs.MetricsRegistry()
    reg.counter("m")
    with pytest.raises(TypeError, match="already registered as counter"):
        reg.gauge("m")


def test_histogram_percentiles_interpolate():
    h = obs.Histogram("h", {})
    for v in (10.0, 20.0, 30.0, 40.0):
        h.observe(v)
    assert (h.percentile(0), h.percentile(50), h.percentile(100)) == \
        (10.0, 25.0, 40.0)
    assert math.isnan(obs.Histogram("e", {}).percentile(50))
    xs = list(np.random.default_rng(0).random(17))
    for q in (0, 13, 50, 99, 100):
        assert obs.percentile(xs, q) == jobs.percentile(xs, q)


def test_default_registry_exposes_plan_caches_callback():
    snap = obs.registry().snapshot()
    assert set(snap["plan_caches"]) == {"plans", "symbolic", "density",
                                        "steal"}
    assert set(snap["plan_caches"]) == \
        set(jobs.registry().snapshot()["plan_caches"])


def test_steal3d_planning_feeds_registry():
    reg = obs.registry()
    moved = reg.counter("steal3d.moved_tile_bytes")
    built = reg.counter("steal3d.plans_built", wire="padded")
    m0, b0 = moved.value, built.value
    a_d, b, a_h, b_h = _handles(seed=13)
    plan = tapi.plan_matmul(a_h, b_h, algorithm="steal3d", cache=False)
    np.testing.assert_allclose(plan(a_h, b_h).numpy(), a_d @ b, rtol=0,
                               atol=1e-4)
    assert built.value >= b0 + 1
    assert moved.value >= m0


def test_cache_stats_reset_windows_counters():
    _, _, a_h, b_h = _handles()
    tapi.clear_plan_cache()
    tapi.cache_stats(reset=True)
    tapi.plan_matmul(a_h, b_h, algorithm="ring_c")
    tapi.plan_matmul(a_h, b_h, algorithm="ring_c")
    stats = tapi.cache_stats(reset=True)
    assert stats["plans"]["misses"] >= 1 and stats["plans"]["hits"] >= 1
    after = tapi.cache_stats()
    assert after["plans"]["hits"] == 0 and after["plans"]["misses"] == 0
    assert after["plans"]["size"] >= 1
    assert set(after) == set(japi.cache_stats())


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------
def test_drift_ratio_and_rmse_exact():
    for o in (obs, jobs):
        o.record_drift("algx", "padded", "off", predicted_s=1.0,
                       measured_s=2.0)
        o.record_drift("algx", "padded", "off", predicted_s=1.0,
                       measured_s=8.0)
    report = obs.drift_report()
    assert report == jobs.drift_report()
    d = report["algx/padded/off"]
    assert d["n"] == 2
    assert d["ratio"] == pytest.approx(4.0)
    assert d["rmse_s"] == pytest.approx(5.0)
    assert d["predicted_mean_s"] == pytest.approx(1.0)
    assert d["measured_mean_s"] == pytest.approx(5.0)


def test_drift_series_keyed_and_exported(tmp_path):
    obs.record_drift("a1", "padded", "off", 1.0, 1.0)
    obs.record_drift("a1", "packed", "off", 1.0, 1.0, cm={"steps": 2.0})
    obs.record_drift("a2", "padded", "auto", 1.0, 1.0)
    assert set(obs.drift_report()) == {"a1/padded/off", "a1/packed/off",
                                       "a2/padded/auto"}
    assert len(obs.drift_records()) == 3
    out = obs.export_drift(str(tmp_path / "drift.json"))
    assert json.loads((tmp_path / "drift.json").read_text()) == out
    obs.reset_all()
    assert obs.drift_report() == {} and obs.drift_records() == []


def test_pending_drift_timing_is_read_by_the_report_not_by_record():
    class Pending:
        reads = 0

        def seconds(self):
            Pending.reads += 1
            return 3.0

    obs.record_drift("algx", "padded", "off", predicted_s=1.0,
                     measured_s=Pending())
    assert Pending.reads == 0
    d = obs.drift_report()["algx/padded/off"]
    assert Pending.reads == 1
    assert d["measured_mean_s"] == 3.0 and d["ratio"] == pytest.approx(3.0)
    (rec,) = obs.drift_records()
    assert rec["measured_s"] == 3.0 and Pending.reads == 1


# ---------------------------------------------------------------------------
# the instrumented plan path, against the JAX package's
# ---------------------------------------------------------------------------
def _handles(m=32, seed=11):
    a_d = random_sparse(m, m, 0.2, seed=seed)
    b = np.random.default_rng(seed).standard_normal((m, 8)).astype(
        np.float32)
    a_h = DistBSR.from_dense(a_d, g=1, block_size=4, device=CPU)
    return a_d, b, a_h, DistDense.for_rhs(b, a_h)


def _run_sequence(api, o, handle, rhs, machine):
    """The same plans and multiplies through one package, tracing on: a
    fresh ring_c plan called three times, then the cached one, steal3d,
    sparse output over the packed wire, and algorithm="auto"."""
    a_d = random_sparse(32, 32, 0.2, seed=17)
    s_d = random_sparse(32, 32, 0.1, seed=18)
    b = np.random.default_rng(17).standard_normal((32, 8)).astype(np.float32)
    a_h, s_h = handle(a_d), handle(s_d)
    b_h = rhs(b, a_h)
    kw = {"impl": "ref"} if api is japi else {}
    o.enable(clear=True)
    o.reset_drift()
    plan = api.plan_matmul(a_h, b_h, algorithm="ring_c", cache=False, **kw)
    for _ in range(3):
        out = plan(a_h, b_h)
    api.plan_matmul(a_h, b_h, algorithm="ring_c", **kw)
    api.plan_matmul(a_h, b_h, algorithm="ring_c", **kw)(a_h, b_h)
    api.matmul(a_h, b_h, algorithm="steal3d", **kw)
    api.matmul(a_h, s_h, output="sparse", wire="packed", **kw)
    api.matmul(a_h, b_h, algorithm="auto", machine=machine, **kw)
    o.disable()
    return out, a_d @ b, [e["name"] for e in o.events()], \
        o.drift_records(), o.drift_report()


def test_traced_plan_emits_spans_and_drift_as_jax():
    """The same sequence of plans through both packages: the same span
    names in the same order, the same drift series and record keys (the
    cost-model dict's too); every multiply span carries its measured
    seconds, and drift predictions are on the H100 preset by default."""
    tapi.clear_plan_cache()
    japi.clear_plan_cache()
    got = _run_sequence(
        tapi, obs, lambda d: DistBSR.from_dense(d, g=1, block_size=4,
                                                device=CPU),
        lambda b, a_h: DistDense.for_rhs(b, a_h), trl.H100_SXM)
    want = _run_sequence(
        japi, jobs, lambda d: japi.DistBSR.from_dense(d, g=1, block_size=4),
        lambda b, a_h: japi.DistDense.for_rhs(jnp.asarray(b), a_h),
        jrl.Machine(**__import__("dataclasses").asdict(trl.H100_SXM)))
    out, oracle, names, records, report = got
    np.testing.assert_allclose(out.numpy(), oracle, rtol=0, atol=1e-4)
    assert [n for n in names if n not in PORT_SPANS] == want[2]
    assert names.count("multiply.ring_c") >= 5     # auto may add one
    assert {"plan_build", "plan_build.executable", "plan_build.steal",
            "plan_build.symbolic", "plan_build.wire",
            "plan_build.auto_select", "multiply.steal3d"} <= set(names)
    assert set(report) == set(want[4])
    assert len(records) == len(want[3])
    for rec, jrec in zip(records, want[3]):
        assert set(rec) == set(jrec)
        assert set(rec["cm"]) == set(jrec["cm"])
        assert rec["measured_s"] > 0 and rec["predicted_s"] > 0
        assert rec["machine"] == trl.H100_SXM.name
    mults = [e for e in obs.events() if e["name"].startswith("multiply.")
             and e["name"] not in PORT_SPANS]
    assert mults and all(e["args"]["measured_s"] > 0 for e in mults)
    d = report["ring_c/padded/auto"]
    assert d["n"] == sum(e["name"] == "multiply.ring_c"
                         and e["args"]["wire"] == "padded" for e in mults)
    assert d["ratio"] > 0


def test_drift_machine_is_settable():
    _, _, a_h, b_h = _handles(seed=21)
    m = trl.Machine("fitted", 1e12, 1e12, 1e11, 4)
    tapi.set_drift_machine(m)
    try:
        obs.enable(clear=True)
        tapi.matmul(a_h, b_h)
        obs.disable()
    finally:
        tapi.set_drift_machine(None)
    (rec,) = obs.drift_records()
    assert rec["machine"] == "fitted"


def test_untraced_plan_records_nothing_reads_no_clock_and_waits_for_nothing(
        monkeypatch):
    a_d, b, a_h, b_h = _handles(seed=19)
    plan = tapi.plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)

    def forbidden(*args, **kw):
        raise AssertionError("an untraced multiply read the clock or "
                             "synchronised")

    monkeypatch.setattr(tapi.time, "perf_counter", forbidden)
    monkeypatch.setattr(tapi._obs, "sync_elapsed", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    for alg in ("ring_c", "steal3d"):
        plan = tapi.plan_matmul(a_h, b_h, algorithm=alg, cache=False)
        out = plan(a_h, b_h)
        np.testing.assert_allclose(out.numpy(), a_d @ b, rtol=0, atol=1e-4)
    assert obs.events() == [] and obs.drift_records() == []


def test_trace_hooks_fire_once_per_plan_build():
    _, _, a_h, b_h = _handles(seed=23)
    tapi.clear_plan_cache()
    seen = []
    hook = tapi.add_trace_hook(seen.append)
    try:
        plan = tapi.plan_matmul(a_h, b_h, algorithm="ring_c")
        for _ in range(5):
            plan(a_h, b_h)
        assert tapi.plan_matmul(a_h, b_h, algorithm="ring_c") is plan
        for _ in range(3):
            tapi.plan_matmul(a_h, b_h, algorithm="ring_c",
                             cache=False)(a_h, b_h)
    finally:
        tapi.remove_trace_hook(hook)
    assert plan.traces == 1 and seen[0] is plan and len(seen) == 4
    tapi.plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    assert len(seen) == 4                   # removed: fires no more
