import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each cell at a size a CPU test holds: the cell's own traffic and layout
# kinds, a small graph and block size
SMALL = {
    "spmm-rmat16-f32-w512": {"config": {"scale": 8, "block_size": 8},
                             "traffic": {"width": 16}},
    "spmm-rmat17-bf16-w512": {"config": {"scale": 8, "block_size": 8},
                              "traffic": {"width": 16}},
    "spmm-rmat16-f32-w128": {"config": {"scale": 8, "block_size": 8},
                             "traffic": {"width": 8}},
    "spmm-rmat16-f32-w512-bs16": {"config": {"scale": 8},
                                  "traffic": {"width": 16}},
    "spgemm-rmat16-dense": {"config": {"scale": 9, "block_size": 8}},
}


@pytest.fixture(autouse=True)
def small_run(monkeypatch):
    """A pool of a few operands at the small sizes, and one host thread for
    the CPU's math, as ``run.py`` takes (pool threads of parallel test
    processes spinning on shared cores stretch a multiply a hundredfold)."""
    import torch
    from bench import inputs
    monkeypatch.setattr(inputs, "POOL_BYTES", 40000)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA card, decided here and not at import: skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
