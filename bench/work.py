"""The work a multiply needs, counted from its inputs' nonzeros, and the
least time one H100 could take for it.

The counts read the matrix as the benchmark made it (its distinct edges),
never the program's tiles, blocks or tables: the same inputs need the same
work whatever layout or kernel multiplies them, so a change of the local
format shows as time saved against a fixed yardstick.

* SpMM ``A @ B`` (A sparse, B dense ``k x n``) needs ``2 nnz(A) n`` flops
  and reads A's nonzeros once, B once, and writes C once.

A sparse matrix's bytes are those of CSR: each nonzero's value and int32
column index, and an int32 row pointer per row and one more.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
# limit: HBM bytes/s and peak operations by operand type (float32 on the
# CUDA cores, TF32 off; bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}
INDEX_BYTES = 4


def csr_bytes(nnz: int, n_rows: int, value_bytes: int) -> int:
    return nnz * (value_bytes + INDEX_BYTES) + (n_rows + 1) * INDEX_BYTES


def spmm_work(rows: np.ndarray, shape, width: int, dtype: str) -> dict:
    """Flops and bytes of ``A @ B`` for A with nonzeros at ``rows`` (one
    entry a nonzero) of ``shape``, B ``shape[1] x width``, A, B and C all
    of ``dtype``."""
    m, k = shape
    nnz = len(rows)
    item = ITEMSIZE[dtype]
    return {"flops": 2 * nnz * width,
            "bytes": csr_bytes(nnz, m, item) + k * width * item
            + m * width * item,
            "dtype": dtype}


def least_time(work: dict) -> dict:
    """The least seconds one H100 needs for ``work``: the larger of its
    flops at the dtype's peak and its bytes at the HBM's rate."""
    t_ops = work["flops"] / PEAK_FLOPS[work["dtype"]]
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "flops",
            "flops_s": t_ops, "bytes_s": t_bytes}
