"""The plain reference: the sparse product from the benchmark's own inputs
(the nonzeros it made, and B), in plain PyTorch, and the comparison that
decides ``correct``.

It imports nothing of the program.  ``precision="float64"`` is the
reference; a lower one (``"tf32"``, ``"fp8"``) is the control: the same
product from inputs rounded to that precision, summed in float32, the
step below what a configuration states (TF32 for float32 with TF32 off,
fp8 for bfloat16).

The number compared is the largest elementwise *error share*
``|got - want| / (|A| @ |B|)``: an element's error against the sum of
its terms' magnitudes, which bounds its rounding whatever the sign of
the terms.  Where ``|A| @ |B|`` is 0 the element is a structural zero and
any error there (or a NaN anywhere) reads infinite.
"""
from __future__ import annotations

import math

import torch

# nonzeros a chunk (a [chunk, n] gathered slab of B)
CHUNK = 1 << 16
PRECISIONS = ("float64", "tf32", "fp8")


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision``, held in float32 (TF32: 10 explicit
    mantissa bits, nearest even; fp8: float8_e4m3fn)."""
    x = x.float()
    if precision == "tf32":
        mant, exp = torch.frexp(x)
        return torch.ldexp(torch.round(mant * 2048.0) / 2048.0, exp)
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {precision!r}")


def _operands(vals, b, precision):
    if precision == "float64":
        return vals.double(), b.double()
    return rounded(vals, precision), rounded(b, precision)


def spmm(rows, cols, vals, b, m: int, precision: str = "float64",
         magnitudes: bool = False) -> torch.Tensor:
    """``A @ b`` for the m-row A with nonzeros ``vals`` at (rows, cols):
    float64 for the reference, float32 from rounded inputs for a control;
    ``magnitudes`` gives ``|A| @ |b|`` (float64) instead."""
    v, bb = _operands(vals, b, precision)
    if magnitudes:
        v, bb = v.abs(), bb.abs()
    out = torch.zeros((m, b.shape[1]), dtype=v.dtype, device=b.device)
    for s in range(0, len(vals), CHUNK):
        e = min(s + CHUNK, len(vals))
        out.index_add_(0, rows[s:e], v[s:e, None] * bb[cols[s:e]])
    return out


def share(got: torch.Tensor, want: torch.Tensor,
          scale: torch.Tensor) -> float:
    """The largest elementwise ``|got - want| / scale`` (see the module's
    docstring); 0 for no elements."""
    if not want.numel():
        return 0.0
    err = (got.double() - want.double()).abs()
    s = torch.where(err == 0, torch.zeros_like(err), err / scale)
    return float(torch.nan_to_num(s, nan=math.inf, posinf=math.inf).max())
