"""The traced run's plumbing on the CPU (spans, host ranges, the metric
readers), and the trace arithmetic on made-up intervals."""
import time
from types import SimpleNamespace

import pytest

from bench import devtrace, harness, manifest
from bench.tests.conftest import SMALL


@pytest.mark.parametrize("traced_s", [0.1, harness.TRACE_SECONDS])
def test_traced_run_reports_the_span_metrics(monkeypatch, traced_s):
    """The traced part the whole window, or its first part only."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", traced_s)
    cell = "spmm-rmat16-f32-w512"
    result, _ = harness.run_cell(cell, 5, 0.4, True,
                                 t_start=time.perf_counter(), device="cpu",
                                 overrides=SMALL[cell], log=lambda *a: None)
    m = result["metrics"]
    assert m["plan_cold_s"]["value"] > 0 and m["plan_lookup_us"]["value"] > 0
    assert m["host_ms"]["value"] > 0 and m["multiply_mfu"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["device"]["window_s"] <= min(traced_s, 0.4) + 0.2
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: no device time, so no roofline
    assert "kernel_roofline" not in m
    assert all(v["unit"] == e["unit"] for e in manifest.load()["per_layer"]
               for k, v in m.items() if k == e["name"])


def test_busy_and_gaps():
    dev = [("a", 10, 20), ("b", 15, 30), ("c", 40, 50), ("d", 95, 120)]
    busy, gaps = devtrace.busy_and_gaps(dev, 0, 100)
    assert busy == 20 + 10 + 5
    assert gaps == [(0, 10), (30, 40), (50, 95)]


def test_host_time_per_call():
    calls = [(0, 10), (20, 30), (40, 50)]
    waits = [(4, 9), (45, 49), (60, 61)]
    assert devtrace.host_time_per_call(calls, waits) == [4, 10, 5]


def test_breakdown():
    dev = [("k1", 0, 4e6), ("k2", 5e6, 6e6), ("k1", 6e6, 7e6)]
    gaps = [(4e6, 5e6), (7e6, 10e6)]
    ranges = [("bench.multiply", 3e6, 8e6), ("plan_build", 4.2e6, 4.8e6)]
    got = devtrace.breakdown(dev, gaps, ranges)
    assert got["device_ops"] == [["k1", 5.0], ["k2", 1.0]]
    assert got["idle_gaps"] == [["bench.between_calls", 3.0],
                                ["plan_build", 1.0]]


def test_lost_kernels_by_name():
    dev = [("spmm_elem_kernel", 10, 20), ("copy", 21, 22),
           ("spmm_elem_kernel", 30, 40), ("spmm_kernel", 50, 60),
           ("spmm_elem_kernel", 150, 160)]
    launched = {"spmm_kernel": 1, "spmm_elem_kernel": 2}
    assert devtrace.lost(dev, launched, 0, 100) == {}
    assert devtrace.lost(dev[1:], launched, 0, 100) == {
        "spmm_elem_kernel": (1, 2)}
    # the element launches counted under the block kernel's name
    assert devtrace.lost(dev, {"spmm_kernel": 3}, 0, 100) == {
        "spmm_kernel": (1, 3)}


@pytest.mark.parametrize("lost, busy, want", [
    # one of 2,000 launches of 1 us dropped, 20 ms busy: read
    ({"spmm_elem_kernel": (1999, 2000)}, 20_000, False),
    # the same launch against 0.5 ms of busy time: more than its share
    ({"spmm_elem_kernel": (1999, 2000)}, 500, True),
    # more events than launches, or a kernel with no event at all
    ({"spmm_elem_kernel": (2001, 2000)}, 20_000, True),
    ({"spmm_elem_kernel": (1999, 2000), "spmm_kernel": (0, 3)}, 20_000,
     True)])
def test_too_lost(lost, busy, want):
    dev = [("spmm_elem_kernel", 10 * i, 10 * i + 1) for i in range(1999)]
    assert devtrace.too_lost(dev, lost, 0, 20_000, busy) is want


def _event(name, start, end, cuda=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("dropped, other_us, lost", [
    (0, 100, {}), (1, 100, {"spmm_elem_kernel": (1, 2)}), (1, 400_000, {})])
def test_read_trace_counts_b1_launches_by_path(monkeypatch, dropped,
                                               other_us, lost):
    """Two multiplies of one element-path launch each: a trace holding one
    ``spmm_elem_kernel`` event a launch is whole and the device metrics
    read; one that dropped a launch's event is lost and they stay silent,
    unless the dropped launch could move the busy time by no more than
    ``devtrace.DROP_SHARE`` (a long other kernel)."""
    from repro_torch import obs
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    monkeypatch.setattr(bsr_spmm_cuda, "paths", {"elements": 5, "blocks": 7})
    before = harness._launches()
    bsr_spmm_cuda.paths["elements"] += 2
    after = harness._launches()
    launched = {k: after[k] - before[k] for k in after}
    assert launched == {"spmm_kernel": 0, "spmm_elem_kernel": 2}
    obs.enable(clear=True)
    for mark in (devtrace.ANCHOR, "bench.window_start", "bench.window_end"):
        obs.instant(mark)
    obs.disable()
    hi = 1010 + other_us
    events = [_event(devtrace.ANCHOR, 0, 1),
              _event(devtrace.WINDOW, 10, hi),
              _event(devtrace.MULTIPLY, 20, 90),
              _event(devtrace.MULTIPLY, 520, 590),
              _event("cudaStreamSynchronize", 95, 400),
              _event("spmm_elem_kernel", 100, 300, cuda=True),
              _event("index_elementwise_kernel", 600, 600 + other_us,
                     cuda=True)]
    if not dropped:
        events.append(_event("spmm_elem_kernel", 700 + other_us,
                             900 + other_us, cuda=True))
    tracer = SimpleNamespace(prof=SimpleNamespace(events=lambda: events),
                             completed=2, launched=launched)
    run = harness.Run(setup_s=1.0, window_s=1.0, times_ms=[1.0, 1.0],
                      host_ms=[], attempted=2, failed=0, peak_bytes=1,
                      raw_peak=1, work={"flops": 2e6, "bytes": 1e6,
                                        "dtype": "float32"})
    harness._read_trace(run, tracer, lambda *a: None)
    assert run.trace_lost == lost
    got = {m: manifest.reader(m).read(run)
           for m in ("idle_share", "kernel_roofline")}
    if lost:
        assert got == {"idle_share": None, "kernel_roofline": None}
    else:
        busy = 200 + other_us + 200 * (not dropped)
        assert got["idle_share"] == pytest.approx(
            100 * (1 - busy / (hi - 10)))
        assert 0 < got["kernel_roofline"] < 100


@pytest.mark.parametrize("traced, want", [(0, 9.0), (6, 1.9), (8, None)])
def test_call_p95_reads_the_untraced_rest(traced, want):
    """``call_p95_ms``: the tail of the multiplies after the traced part,
    as ``multiply_p95_ms`` reads the whole window; nothing to read
    without two of them."""
    times = [9.0] * 6 + [1.0, 2.0, 1.0]
    run = harness.Run(setup_s=1.0, window_s=1.0, times_ms=times,
                      host_ms=[], attempted=9, failed=0, peak_bytes=1,
                      raw_peak=1, work={}, traced_completed=traced)
    got = manifest.reader("call_p95_ms").read(run)
    assert got == (want if want is None else pytest.approx(want))
    if not traced:
        assert got == manifest.reader("multiply_p95_ms").read(run)


def test_kernel_name():
    assert devtrace.kernel_name(
        "void at::native::(anonymous namespace)::roll_kernel<float>(int)") \
        == "at::native::roll_kernel"


@pytest.mark.parametrize("k", [1, 3])
def test_reservoir_is_drawn_from_the_seed(k):
    def draw(seed):
        r = harness._Reservoir(k, seed)
        for i in range(500):
            r.offer(i)
        return r.kept
    assert draw(7) == draw(7) and len(draw(7)) == k
    assert len({tuple(draw(s)) for s in range(20)}) > 1


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_keep_leaves_the_spmm_sample_as_drawn(seed):
    """A SpMM cell holds the answers themselves: the reservoir that calls
    the operation's ``keep`` for a drawn answer only keeps the same keys
    and tensors, and the same bytes, as one that holds every answer
    offered."""
    cell = "spmm-rmat16-f32-w512"
    _, cfg, mix = harness.cell_files(cell, SMALL[cell])
    op = manifest.operation(mix["op"]).setup(cfg, mix, 3, "cpu",
                                             lambda *a: None)
    calls = []
    keep = op.keep
    op.keep = lambda out, key: calls.append(key) or keep(out, key)
    plain, held = harness._Reservoir(3, seed), harness._Reservoir(3, seed)
    for _ in range(40):
        out, key = op.call()
        plain.offer((key, out))
        assert held.offer((key, out), harness._held(op))
    assert [k for k, _ in held.kept] == [k for k, _ in plain.kept]
    assert all(a is b for (_, a), (_, b) in zip(held.kept, plain.kept))
    assert harness._held_bytes(held.kept) == harness._held_bytes(plain.kept)
    # drawn only: the first three, and those that replaced one
    assert 3 <= len(calls) < 40


def test_refused_answer_leaves_the_sample():
    r = harness._Reservoir(2, 1)
    assert not r.offer((0, "x"), lambda item: None)
    assert r.kept == [] and r.offer((1, "y"), lambda item: item)
    assert r.kept == [(1, "y")]
