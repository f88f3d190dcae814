"""The readers of the program's call-grouped spans (``bench/calls.py``:
``launch_lead_us``, ``b1_device_ms``, ``epilogue_device_ms``) on made-up
spans, and a traced run on the CPU."""
import time

import pytest

from bench import harness, manifest
from bench.tests.conftest import SMALL


def _span(name, ts, call=None, **args):
    if call is not None:
        args["call"] = call
    return {"name": name, "ts": ts, "dur": 5.0, "args": args}


def _run(spans):
    return harness.Run(setup_s=0.0, window_s=1.0, times_ms=[], host_ms=[],
                       attempted=0, failed=0, peak_bytes=0, raw_peak=0,
                       work={}, spans=spans, window_us=(100.0, 1000.0))


# the traced part is [100, 1000] us; calls 1, 2 and 4 begin in it (4 ends
# after it), 0 before and 3 after; call 2 launched no B1
SPANS = [
    _span("matmul.coerce", 50, 0), _span("kernel.bsr_spmm", 60, 0,
                                         device_ms=100.0),
    _span("multiply.epilogue", 70, 0, device_ms=9.0),
    _span("matmul.coerce", 110, 1), _span("plan_build", 130, 1),
    _span("kernel.bsr_spmm", 160, 1, launch=0, device_ms=2.0),
    _span("kernel.bsr_spmm", 200, 1, launch=1, device_ms=3.0),
    _span("multiply.epilogue", 260, 1, device_ms=0.5),
    _span("matmul.coerce", 400, 2),
    _span("multiply.epilogue", 450, 2, device_ms=0.7),
    _span("plan_build", 500),
    _span("matmul.coerce", 990, 4),
    _span("kernel.bsr_spmm", 1005, 4, launch=0, device_ms=1.0),
    _span("matmul.coerce", 1100, 3),
    _span("kernel.bsr_spmm", 1110, 3, launch=0, device_ms=100.0),
]


@pytest.mark.parametrize("name, want", [("launch_lead_us", (50 + 15) / 2),
                                        ("b1_device_ms", (2 + 3 + 1) / 3),
                                        ("epilogue_device_ms", 0.6)])
def test_span_readers_on_made_up_calls(name, want):
    assert manifest.reader(name).read(_run(SPANS)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["launch_lead_us", "b1_device_ms",
                                  "epilogue_device_ms"])
def test_span_readers_find_nothing_without_call_ids(name):
    """A program whose spans carry no call id (or no device time) gives
    no reading, and raises nothing."""
    bare = [dict(e, args={k: v for k, v in e["args"].items()
                          if k != "call"}) for e in SPANS]
    assert manifest.reader(name).read(_run(bare)) is None
    assert manifest.reader(name).read(_run([])) is None


def test_traced_cpu_run_reports_the_lead_and_no_device_time():
    """On the CPU the calls' spans are there, the device event pairs are
    not: the lead is reported, the two device times left out."""
    cell = "spmm-rmat16-f32-w512"
    result, _ = harness.run_cell(cell, 5, 0.4, True,
                                 t_start=time.perf_counter(), device="cpu",
                                 overrides=SMALL[cell], log=lambda *a: None)
    m = result["metrics"]
    assert m["launch_lead_us"]["value"] > 0
    assert m["launch_lead_us"]["unit"] == "us"
    assert "b1_device_ms" not in m and "epilogue_device_ms" not in m
