"""The port's five examples (``examples/torch_*.py``), each run in a child
with ``--device cpu``: each exits 0 and prints its own correctness line.
Each runs at its default size but the training example, which runs 30
steps of 4 x 32 tokens (``ARGS``) instead of JAX's 300 of 8 x 64; on the
card ``chip_smoke.py`` runs it at its defaults."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

EXAMPLES = {
    "torch_quickstart": "every result within 0.0001 of the dense product",
    "torch_graph_square": "sparse-output SpGEMM chains without densifying",
    "torch_spgemm_graph": "distributed SpGEMM is exact on this graph: MATCH",
    "torch_serve_decode": "engine decode == unbatched greedy reference",
    "torch_train_lm": "(LEARNING)",
}
OK_WORDS = ("OK", "MATCH", "LEARNING")
ARGS = {"torch_train_lm": ["--steps", "30", "--batch", "4", "--seq", "32"]}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"),
         "--device", "cpu", *ARGS.get(name, [])], capture_output=True, text=True, env=env,
        timeout=240, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert EXAMPLES[name] in last and any(w in last for w in OK_WORDS), last
    assert "cpu" in proc.stdout
