"""The needed-work counts: from the inputs' nonzeros, by hand, and the same
whatever block size tiles the matrix."""
import numpy as np
import pytest
import torch

from bench import inputs, work

# a 4 x 4 matrix: rows 0: cols 0, 2; row 1: col 2; row 2: cols 1, 3; row 3
ROWS = np.array([0, 0, 1, 2, 2])
COLS = np.array([0, 2, 2, 1, 3])


def test_spmm_by_hand():
    w = work.spmm_work(ROWS, (4, 4), 3, "float32")
    assert w["flops"] == 2 * 5 * 3
    # CSR of A (5 values, 5 indices, 5 row pointers), B 4 x 3, C 4 x 3
    assert w["bytes"] == 5 * 8 + 5 * 4 + 4 * 3 * 4 + 4 * 3 * 4


def test_least_time():
    lt = work.least_time({"flops": 67e12, "bytes": 1.0, "dtype": "float32"})
    assert lt["seconds"] == pytest.approx(1.0) and lt["bound_by"] == "flops"
    lt = work.least_time({"flops": 1.0, "bytes": 3.35e12,
                          "dtype": "bfloat16"})
    assert lt["seconds"] == pytest.approx(1.0) and lt["bound_by"] == "bytes"


@pytest.mark.parametrize("width", [8, 32])
def test_count_is_the_same_at_every_block_size(width):
    """The same matrix tiled at block sizes 4 and 16: the format's work
    (every slot of a real block) differs by far, the needed work read back
    from each tiling is the same, and equal to the count from the edges."""
    from repro_torch.core.api import DistBSR
    cfg = {"scale": 7, "edgefactor": 4, "a": 0.6, "b": 0.4 / 3,
           "c": 0.4 / 3, "d": 0.4 / 3, "graph_seed": 3, "g": 2}
    mat = inputs.matrix(cfg, inputs.generator(7, "cpu"), torch.float32,
                        "cpu")
    counts, formats = [], []
    dense = torch.zeros((mat.n, mat.n))
    dense[mat.rows, mat.cols] = mat.vals
    for bs in (4, 16):
        h = DistBSR.from_dense(dense, g=2, block_size=bs, device="cpu")
        r, _ = np.nonzero(h.tiled.to_dense().numpy())  # row-major: sorted
        counts.append(work.spmm_work(r, (mat.n, mat.n), width, "float32"))
        formats.append(int(h.counts.sum()) * bs * bs)
    want = work.spmm_work(mat.host_rows, (mat.n, mat.n), width, "float32")
    assert counts[0] == counts[1] == want
    assert formats[0] != formats[1]
