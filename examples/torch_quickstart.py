"""Quickstart for the PyTorch port: the paper's distributed sparse matmul
engine in 5 minutes.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``.  Builds an R-MAT sparse matrix,
wraps it in a persistent :class:`DistBSR` handle (placement and skew
decided once, reused), plans every schedule of the registry (the
bulk-synchronous SUMMA baselines, the asynchronous RDMA-style rings and
steal3d) on a 2x2 grid stacked on one device, and checks each against a
dense reference.  On the card (the default) the local multiplies run the
hand-written B1 kernel (``kernels/csrc/bsr_spmm.cu``); ``--device cpu``
runs its plain version.  The second call of a plan reuses it: no re-pad,
no re-skew, no re-plan (``plan.traces`` stays at 1).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import api  # noqa: E402
from repro_torch.core.api import DistBSR, DistDense  # noqa: E402
from repro_torch.core.bsr import BSR, rmat_matrix  # noqa: E402
from repro_torch.core.roofline import H100_SXM, SUMMIT_V100, spmm_model  # noqa: E402
from repro_torch.core.schedule import stage_imbalance  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime.device import strict_fp32  # noqa: E402

TOL = 1e-4


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default) or cpu")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    strict_fp32()

    # --- 1. a skewed sparse matrix (R-MAT scale 8, like the paper's Fig 1) --
    a_dense = rmat_matrix(scale=8, edgefactor=8, seed=0)   # 256 x 256
    n_cols = 32
    b = np.random.default_rng(0).standard_normal((256, n_cols)).astype(
        np.float32)
    want = a_dense @ b
    worst = 0.0

    # --- 2. local kernel: B1 (or its plain version) against the reference --
    a_local = BSR.from_dense(a_dense, block_size=8, device=dev)
    b_t = torch.from_numpy(b).to(dev)
    with torch.no_grad():
        y_ref = ops.bsr_spmm(a_local, b_t, impl="ref")
        y_dev = ops.bsr_spmm(a_local, b_t)
    err = float((y_dev - y_ref).abs().max())
    worst = max(worst, err)
    print(f"local kernel ({ops.default_impl(b_t)}): nnz blocks="
          f"{a_local.nnzb}, fill={a_local.block_fill_ratio():.2f}, "
          f"kernel-vs-plain max err={err:.2e}")

    # --- 3. every schedule on a 2x2 grid, stacked on one device -----------
    g = 2
    a_h = DistBSR.from_dense(a_dense, g=g, block_size=8, device=dev)
    b_h = DistDense.for_rhs(b, a_h)
    print(f"\ndistributed SpMM on {g}x{g} grid (tile load imbalance = "
          f"{a_h.tiled.load_imbalance():.2f}):")
    for alg in api.algorithms():
        plan = api.plan_matmul(a_h, b_h, algorithm=alg)
        plan(a_h, b_h)
        got = plan(a_h, b_h)          # second call: the cached plan
        err = float(np.abs(got.cpu().numpy() - want).max())
        worst = max(worst, err)
        style = api.REGISTRY.get(alg).style.upper().ljust(4)
        print(f"  [{style}] {alg:12s} max err {err:.2e} "
              f"(traces={plan.traces})")

    # --- 3b. balanced tiling + auto-scheduling ------------------------------
    a_bal = DistBSR.from_dense(a_dense, g=g, block_size=8, balance="rows",
                               device=dev)
    b_bal = DistDense.for_rhs(b, a_bal)
    plan_auto = api.plan_matmul(a_bal, b_bal, algorithm="auto",
                                machine=H100_SXM)
    err = float(np.abs(plan_auto(a_bal, b_bal).cpu().numpy() - want).max())
    worst = max(worst, err)
    print(f"\nbalanced tiling: capacity {a_h.capacity} -> {a_bal.capacity}, "
          f"padded-flop waste {a_h.tiled.padded_flop_waste():.2f} -> "
          f"{a_bal.tiled.padded_flop_waste():.2f}; "
          f"auto chose {plan_auto.algorithm.name!r} (max err {err:.2e})")

    # --- 4. the paper's Fig-1 story: sync amplifies imbalance ---------------
    counts = a_h.counts.cpu().numpy().astype(np.float64)
    per_stage, end_to_end = stage_imbalance(counts)
    print(f"\nload imbalance (flops max/avg): per-stage (BSP) "
          f"{per_stage:.2f}x vs end-to-end (async) {end_to_end:.2f}x")

    # --- 5. the paper's SS4 inter-node roofline ------------------------------
    d = float(a_dense.mean())
    for mach in (SUMMIT_V100, H100_SXM):
        m = spmm_model(256, 256, n_cols, g * g, d, mach)
        print(f"roofline[{mach.name}]: AI_net={m['ai_net']:.2f} fl/B, "
              f"predicted {m['perf'] / 1e9:.1f} GF/s/chip "
              f"({'network' if m['net_bound'] else 'compute'}-bound)")
    plan = api.plan_matmul(a_h, b_h, algorithm="ring_c")
    cm = plan.cost_model(a_h)
    pp = plan.predicted_perf(H100_SXM)
    print(f"plan cost model[ring_c]: {cm['net_bytes_per_step']:.0f} B/step, "
          f"AI_net={cm['ai_net']:.2f} fl/B, predicted "
          f"{pp['perf'] / 1e9:.1f} GF/s/chip on {H100_SXM.name}")

    ok = worst <= TOL
    print(f"\nquickstart on {dev}: every result within {TOL:g} of the dense "
          f"product (worst {worst:.2e}): {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
