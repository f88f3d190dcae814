"""``tools/trace_view.py`` (unchanged) reads the port's traces: a trace
written by ``repro_torch.obs.export_trace`` around a traced multiply on
the CPU is summarized by ``summarize`` / ``render`` and by the CLI, the
way ``tests/test_obs.py`` loads the tool."""
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core.api import DistBSR, DistDense, matmul
from repro_torch.core.bsr import rmat_matrix

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_tool(name):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    a = rmat_matrix(scale=6, edgefactor=4, seed=0)
    b = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    a_h = DistBSR.from_dense(a, g=2, block_size=8, device="cpu")
    b_h = DistDense.for_rhs(b, a_h)
    obs.enable(clear=True)
    try:
        for _ in range(2):
            matmul(a_h, b_h, algorithm="ring_c", device="cpu")
        with obs.span("custom.step", step=3):
            pass
        path = tmp_path_factory.mktemp("trace") / "port_trace.json"
        obs.export_trace(str(path))
    finally:
        obs.disable()
        obs.clear_trace()
    return path


def test_summarize_reads_a_port_trace(trace_path):
    tv = _load_tool("trace_view")
    trace = json.load(open(trace_path))
    assert trace["otherData"]["source"] == "repro_torch.obs"
    events = trace["traceEvents"]
    rows = tv.summarize(events)
    by_name = {r["name"]: r for r in rows}
    names = [e["name"] for e in events if e["ph"] == "X"]
    assert set(by_name) == set(names)
    for name, row in by_name.items():
        assert row["count"] == names.count(name)
        durs = [e["dur"] / 1e3 for e in events if e["name"] == name]
        assert row["total_ms"] == pytest.approx(sum(durs))
        assert row["max_ms"] == pytest.approx(max(durs))
    assert by_name["plan_build"]["count"] == 2
    assert by_name["custom.step"]["count"] == 1
    assert [r["total_ms"] for r in rows] == sorted(
        (r["total_ms"] for r in rows), reverse=True)
    text = tv.render(trace)
    assert f"{len(events)} events, {len(rows)} span names" in text
    assert "step=3" in text or "custom.step" in text


def test_the_cli_reads_a_port_trace(trace_path, capsys):
    tv = _load_tool("trace_view")
    assert tv.main([str(trace_path), "--top", "3", "--slowest", "2"]) == 0
    out = capsys.readouterr().out
    assert "slowest 2 spans:" in out
    proc = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "trace_view.py"),
                           str(trace_path)], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "plan_build" in proc.stdout
