"""The traced run's plumbing on the CPU (spans, host ranges, the metric
readers), and the trace arithmetic on made-up intervals."""
import time

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
