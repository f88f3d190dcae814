"""On the card: one short run of each cell, correct, with every metric the
cell reports (the look for a card made inside each test)."""
import json
import subprocess
import sys

import pytest

from bench import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    want = {m["name"] for m in manifest.cell_metrics(manifest.load(), cell,
                                                     bool(trace))}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
