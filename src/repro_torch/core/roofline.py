"""The paper's SS4 inter-node roofline model, with machine presets.

Port of ``repro/core/roofline.py``.  The model characterizes one iteration
of the distributed multiply by its *inter-node arithmetic intensity* —
flops per byte moved over the network — and caps achievable throughput by
the *local* roofline peak of the on-chip kernel (not the raw arithmetic
peak).

    perf(AI_net) = min(local_peak, AI_net * net_bw)
    local_peak   = min(arith_peak, AI_local * mem_bw)

Formulas follow the paper exactly (stationary-C, square sqrt(p) grids,
density d, word size w).  The presets are the paper's systems (Summit,
DGX-2, both V100) and the port's card, :data:`H100_SXM`, from NVIDIA's
data sheet.  Pure Python: plans score schedules with it on the host
(``repro_torch.core.api.auto_select``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict

__all__ = [
    "Machine", "SUMMIT_V100", "DGX2_V100", "HOST_CPU", "H100_SXM",
    "H100_SXM_PEAK_OPS", "H100_SXM_HBM_BYTES",
    "save_machine", "load_machine",
    "spmm_local_ai", "spmm_internode_ai", "spgemm_local_ai",
    "spgemm_internode_ai", "local_peak", "internode_roofline",
    "spmm_model", "spgemm_model",
    "steal3d_internode_ai", "steal3d_model",
]


@dataclasses.dataclass(frozen=True)
class Machine:
    """Per-accelerator constants (SI bytes/s, flop/s).

    ``overlap_eff`` is the overlap term of the cost model: the fraction
    of a schedule's compute time its communication can hide under when
    the schedule's dependence structure permits prefetch (the paper's
    SS3.3 asynchronous-transfer claim).  Per-step exposed comm becomes
    ``max(0, comm - overlap_eff * comp)`` — 1.0 is perfect hiding
    (exposed = comm beyond compute, the classic ``max(comp, comm)``),
    0.0 is fully serialized (``comp + comm``).
    """
    name: str
    arith_peak: float       # flop/s (float32 for the V100s and the H100)
    mem_bw: float           # HBM bytes/s
    net_bw: float           # per-chip share of injection bandwidth, bytes/s
    word_bytes: int = 4
    hop_latency: float = 1e-6   # per-message latency (the alpha term), s
    overlap_eff: float = 1.0    # comm-hiding fraction (see docstring)


# Paper SS4/SS6: V100 16 TF fp32; Summit dual-rail EDR = 23 GB/s per node,
# /6 GPUs = 3.83 GB/s per GPU.  DGX-2: NVLink 3.0, 50 GB/s per GPU link.
SUMMIT_V100 = Machine("summit-v100", 16e12, 900e9, 3.83e9, 4)
DGX2_V100 = Machine("dgx2-v100", 16e12, 900e9, 50e9, 4)
# The reference's CI harness: 16 fake CPU devices sharing one host process,
# ~50 GFLOP/s of einsum throughput per fake device, the "network" a host
# memcpy, the per-message alpha the dispatch floor.  A compute-bound
# machine: the regime where a work-stealing schedule's flop saving decides.
# The JAX package's values (repro/core/roofline.py), for the host tests.
HOST_CPU = Machine("host-cpu", 5e10, 2e10, 2e10, 4, hop_latency=2e-5)
# H100 80GB HBM3, 700 W (data sheet), SXM part, dense rates:
# * arith_peak 67 TFLOP/s: float32 FMA on the CUDA cores (H100 80GB HBM3,
#   700 W, data sheet)
# * mem_bw 3.35 TB/s of HBM3 (H100 80GB HBM3, 700 W, data sheet)
# * net_bw 450 GB/s: NVLink 4's 900 GB/s per GPU, one direction's share
#   (H100 80GB HBM3, 700 W, data sheet)
# * word_bytes 4: float32 (H100 80GB HBM3, 700 W, data sheet)
# * hop_latency and overlap_eff: the dataclass defaults, not fitted to the
#   card yet
H100_SXM = Machine("h100-sxm", 67e12, 3.35e12, 450e9, 4)
# Peak operations by operand type (H100 80GB HBM3, 700 W, data sheet):
# float32 on the CUDA cores, bf16 on the tensor cores (dense)
H100_SXM_PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
# Device memory of one card: 80 GB of HBM3 (H100 80GB HBM3, 700 W, data
# sheet)
H100_SXM_HBM_BYTES = 80e9


def save_machine(m: Machine, path: str) -> None:
    """Persist a Machine preset as JSON."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(m), f, indent=1)
        f.write("\n")


def load_machine(path: str) -> Machine:
    """Load a Machine preset saved by :func:`save_machine`.

    Feed the result to ``plan_matmul(machine=...)`` / ``auto_select`` so
    auto-scheduling tracks a fitted machine instead of nominal constants.
    """
    with open(path) as f:
        return Machine(**json.load(f))


# ---------------------------------------------------------------------------
# SpMM (paper SS4) — C (m x n) = A (m x k, density d) @ B (k x n dense)
# ---------------------------------------------------------------------------
def _spmm_terms(m: int, k: int, n: int, p: int, d: float, w: int):
    sp = math.sqrt(p)
    flops = 2.0 * (d * m * k / p) * (n / sp)
    a_bytes = w * (2.0 * d * m * k / p + m / sp + 1.0)   # CSR: vals+cols+rowptr
    b_bytes = w * (k * n / p)
    c_bytes = w * (m * n / p)
    return flops, a_bytes, b_bytes, c_bytes


def spmm_local_ai(m: int, k: int, n: int, p: int, d: float,
                  w: int = 4) -> float:
    """Paper's local SpMM arithmetic intensity (flops / bytes of A,B,C)."""
    flops, a_b, b_b, c_b = _spmm_terms(m, k, n, p, d, w)
    return flops / (a_b + b_b + c_b)


def spmm_internode_ai(m: int, k: int, n: int, p: int, d: float,
                      w: int = 4) -> float:
    """Paper's inter-node SpMM AI (flops / network bytes of A and B tiles)."""
    flops, a_b, b_b, _ = _spmm_terms(m, k, n, p, d, w)
    return flops / (a_b + b_b)


# ---------------------------------------------------------------------------
# SpGEMM (paper SS4) — C = A @ B, both sparse with density d
# ---------------------------------------------------------------------------
def spgemm_local_ai(cf: float, b: int) -> float:
    """Gu et al. bound: AI = cf / ((3 + 2 cf) * b).

    cf = compression factor (flops per nonzero of C); b = bytes per nonzero.
    """
    return cf / ((3.0 + 2.0 * cf) * b)


def spgemm_internode_ai(flops: float, m: int, k: int, n: int, p: int,
                        d: float, w: int = 4) -> float:
    """Paper's inter-node SpGEMM AI with measured FLOPS(A, B)."""
    sp = math.sqrt(p)
    a_bytes = w * (2.0 * d * m * k / p + m / sp + 1.0)
    b_bytes = w * (2.0 * d * k * n / p + k / sp + 1.0)
    return flops / (a_bytes + b_bytes)


# ---------------------------------------------------------------------------
# Rooflines
# ---------------------------------------------------------------------------
def local_peak(local_ai: float, mach: Machine) -> float:
    """Flat 'roof' of the inter-node model = the local kernel's peak."""
    return min(mach.arith_peak, local_ai * mach.mem_bw)


def internode_roofline(ai_net: float, local_ai: float,
                       mach: Machine) -> float:
    """Predicted flop/s per accelerator for one distributed iteration."""
    return min(local_peak(local_ai, mach), ai_net * mach.net_bw)


def spmm_model(m: int, k: int, n: int, p: int, d: float,
               mach: Machine) -> Dict[str, float]:
    """Everything Fig. 2 needs for one SpMM point."""
    w = mach.word_bytes
    ai_local = spmm_local_ai(m, k, n, p, d, w)
    ai_net = spmm_internode_ai(m, k, n, p, d, w)
    return {
        "ai_local": ai_local,
        "ai_net": ai_net,
        "local_peak": local_peak(ai_local, mach),
        "perf": internode_roofline(ai_net, ai_local, mach),
        "net_bound": ai_net * mach.net_bw < local_peak(ai_local, mach),
    }


def steal3d_internode_ai(flops: float, gather_bytes: float,
                         moved_bytes: float, reduce_bytes: float) -> float:
    """Inter-node AI of the static steal3d dispatch (per device).

    Unlike the owner-computes schedules, steal3d's wire traffic has three
    distinct components that all must be charged: the up-front operand
    panel gathers, the *moved tiles* of off-owner work items (the paper's
    "one moving tile" locality cost), and the partial-C tiles reduced back
    to their owners.
    """
    total = gather_bytes + moved_bytes + reduce_bytes
    return flops / total if total else float("inf")


def steal3d_model(flops: float, gather_bytes: float, moved_bytes: float,
                  reduce_bytes: float, ai_local: float,
                  mach: Machine) -> Dict[str, float]:
    """Roofline prediction for one steal3d dispatch (Fig. 2 style)."""
    ai_net = steal3d_internode_ai(flops, gather_bytes, moved_bytes,
                                  reduce_bytes)
    return {
        "ai_local": ai_local,
        "ai_net": ai_net,
        "local_peak": local_peak(ai_local, mach),
        "perf": internode_roofline(ai_net, ai_local, mach),
        "net_bound": ai_net * mach.net_bw < local_peak(ai_local, mach),
        "moved_tile_fraction": moved_bytes / (gather_bytes + moved_bytes
                                              + reduce_bytes)
        if (gather_bytes + moved_bytes + reduce_bytes) else 0.0,
    }


def spgemm_model(flops: float, cf: float, m: int, k: int, n: int, p: int,
                 d: float, mach: Machine) -> Dict[str, float]:
    """Everything Fig. 2 needs for one SpGEMM point (measured flops & cf)."""
    w = mach.word_bytes
    ai_local = spgemm_local_ai(cf, w)
    ai_net = spgemm_internode_ai(flops, m, k, n, p, d, w)
    return {
        "ai_local": ai_local,
        "ai_net": ai_net,
        "local_peak": local_peak(ai_local, mach),
        "perf": internode_roofline(ai_net, ai_local, mach),
        "net_bound": ai_net * mach.net_bw < local_peak(ai_local, mach),
    }
