"""Graph squaring with sparse-output SpGEMM, in the PyTorch port: A @ A and
chained A @ A @ A.

Run:  PYTHONPATH=src python examples/torch_graph_square.py [--device cpu]

The port of ``examples/graph_square.py``.  Squares a sparse R-MAT graph on
a 2x2 grid stacked on one device with ``matmul(..., output="sparse")``: the
symbolic phase predicts C's block structure on the host, the numeric phase
accumulates straight into packed blocks (the hand-written B2 kernel,
``kernels/csrc/bsr_pair.cu``, on the card), and the result is a
``DistBSR`` handle, so the cube chains through a second multiply without a
dense intermediate.  The dense-output product (B1 on the card) must agree.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import api  # noqa: E402
from repro_torch.core.api import DistBSR  # noqa: E402
from repro_torch.core.bsr import rmat_matrix  # noqa: E402
from repro_torch.runtime.device import strict_fp32  # noqa: E402

TOL = 1e-3


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default) or cpu")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    strict_fp32()

    a = rmat_matrix(scale=8, edgefactor=1, seed=11)   # sparse digraph
    g = 2
    a_h = DistBSR.from_dense(a, g=g, block_size=8, device=dev)

    # A^2 with a sparse DistBSR output (the epilogue packs, not densifies)
    a2 = api.matmul(a_h, a_h, algorithm="ring_c", output="sparse")
    if not isinstance(a2, DistBSR):
        raise TypeError(f"output='sparse' gave {type(a2).__name__}")
    sym = api.symbolic_spgemm(a_h.tiled, a_h.tiled)
    dense_bytes = a.size * 4
    print(f"A^2 predicted block density: {sym.density():.3f}")
    print(f"A^2 packed footprint: {a2.footprint_bytes():,} B "
          f"(dense output: {dense_bytes:,} B, "
          f"{dense_bytes / a2.footprint_bytes():.1f}x larger)")

    # chained cube: the sparse handle is the next left operand, no densify
    a3 = api.matmul(a2, a_h, algorithm="ring_c", output="sparse")
    print(f"A^3 packed footprint: {a3.footprint_bytes():,} B "
          f"(capacity {a3.capacity} blocks/tile)")

    want2, want3 = a @ a, a @ a @ a
    got2 = a2.densify().cpu().numpy()
    err2 = float(np.abs(got2 - want2).max())
    err3 = float(np.abs(a3.densify().cpu().numpy() - want3).max())
    print(f"max|A^2 err| = {err2:.2e}   max|A^3 err| = {err3:.2e}")

    # the dense-output path agrees on the logical values
    a2_dense = api.matmul(a_h, a_h, algorithm="ring_c").cpu().numpy()
    agree = float(np.abs(a2_dense - got2).max())
    print(f"dense-output agreement: max|diff| = {agree:.2e}")
    ok = max(err2, err3, agree) < TOL
    print(f"graph_square on {dev}: sparse-output SpGEMM chains without "
          f"densifying, within {TOL:g} of numpy: "
          f"{'MATCH' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
