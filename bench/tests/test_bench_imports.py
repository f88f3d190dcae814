"""Nothing the benchmark runs imports JAX or the JAX package, and
``run.py`` prints no result without a card."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import manifest

BENCH = manifest.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = _imported(f) & FORBIDDEN
        assert not bad, f"{f} imports {bad}"


def test_a_run_loads_no_jax():
    """A whole run (on the CPU, at a small size) leaves no JAX module, no
    module of the JAX package and none of its benchmarks loaded."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from bench import harness, run\n"
        "from bench.tests.conftest import SMALL\n"
        "from bench import inputs; inputs.POOL_BYTES = 40000\n"
        "c = 'spmm-rmat16-f32-w512'\n"
        "harness.run_cell(c, 1, 0.2, True, t_start=time.perf_counter(), "
        "device='cpu', overrides=SMALL[c], log=lambda *a: None)\n"
        "c = 'spmm-rmat17-bf16-w512'\n"
        "harness.run_cell(c, 1, 0.2, False, t_start=time.perf_counter(), "
        "device='cpu', overrides=SMALL[c], log=lambda *a: None)\n"
        "print(run.forbidden_modules())\n") % (str(manifest.ROOT),
                                               str(manifest.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_result(out) -> bool:
    last = (out.stdout.strip().splitlines() or [""])[-1]
    try:
        json.loads(last)
    except ValueError:
        return True
    return False


def test_run_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "spmm-rmat16-f32-w512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=manifest.ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA card" in out.stderr


def test_run_exits_nonzero_with_the_benchmark_alone(tmp_path):
    """A directory with BENCHMARK.json and bench/ only: no program."""
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "spmm-rmat16-f32-w512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0 and _no_result(out)
