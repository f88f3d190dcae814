"""The port stands on its own: no JAX and nothing of the JAX package.

Importing ``repro_torch.core.api`` in a fresh interpreter must leave ``jax``
and ``repro`` out of ``sys.modules``, and no source file of the port (nor
``chip_smoke.py``) may import either.  Nothing may build or load a kernel
at import time either: this checks that no ``triton`` or compiled library
is pulled in.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_fresh_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.core.api, repro_torch.core.interop\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.loader\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(repr(bad))\n"
        "from repro_torch.kernels import loader\n"
        "print(len(loader._LIBS))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bad, libs = proc.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert libs == "0"          # no kernel is built or loaded on import


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_chip_smoke_refuses_to_run_without_a_card():
    """Where there is no card the script exits non-zero and prints no
    result line."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
