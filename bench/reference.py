"""The plain reference: the sparse product from the benchmark's own inputs
(the nonzeros it made, and B), in plain PyTorch, and the comparison that
decides ``correct``.

The square ``A @ A`` is made one block of rows at a time
(:func:`spgemm_rows`), each term a pair of A's nonzeros that meet, so that
no dense operand and no whole dense product is ever built.

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

# nonzeros a chunk (a [chunk, n] gathered slab of B), and terms a chunk
# of the square's pairs
CHUNK = 1 << 16
TERMS = 1 << 24
# elements of a block of rows of the square's answer
SLAB = 1 << 26
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


def row_pointer(rows: torch.Tensor, n: int) -> torch.Tensor:
    """CSR's row pointer (n + 1 entries) of the nonzeros at sorted
    ``rows``."""
    return torch.searchsorted(rows.contiguous(),
                              torch.arange(n + 1, device=rows.device))


def row_blocks(n: int) -> list:
    """The blocks of rows ``(lo, hi)`` of an n x n answer that the square's
    reference and its record take at a time (``SLAB`` elements each)."""
    step = max(1, SLAB // n)
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def _terms(cols, ptr, lo: int, hi: int):
    """The terms of rows lo:hi of ``A @ A``, in chunks of about ``TERMS``:
    index tensors (s, t) of A's nonzeros, s = (i, k) in those rows and t =
    (k, j) in row k, one pair a term."""
    s0, s1 = int(ptr[lo]), int(ptr[hi])
    ks = cols[s0:s1]
    deg = ptr[ks + 1] - ptr[ks]
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1]) if len(cum) else 0
    cuts = torch.searchsorted(cum, torch.arange(
        TERMS, max(total, TERMS), TERMS, device=cum.device),
        right=True).tolist()
    bounds = sorted({0, len(deg), *cuts})
    for a, b in zip(bounds, bounds[1:]):
        d = deg[a:b]
        first = torch.cumsum(d, 0) - d
        s = torch.repeat_interleave(
            torch.arange(s0 + a, s0 + b, device=d.device), d)
        t = torch.repeat_interleave(ptr[ks[a:b]] - first, d) \
            + torch.arange(len(s), device=d.device)
        yield s, t


def spgemm_rows(rows, cols, vals, ptr, n: int, lo: int, hi: int,
                precision: str = "float64",
                magnitudes: bool = False) -> torch.Tensor:
    """Rows lo:hi of ``A @ A`` for the n x n A with nonzeros ``vals`` at
    sorted (rows, cols) and row pointer ``ptr``, a dense ``[hi - lo, n]``
    slab: float64 for the reference, float32 from rounded inputs for a
    control; ``magnitudes`` gives ``|A| @ |A|`` (float64) instead."""
    v = vals.double() if precision == "float64" else rounded(vals, precision)
    if magnitudes:
        v = v.abs()
    out = torch.zeros((hi - lo) * n, dtype=v.dtype, device=vals.device)
    for s, t in _terms(cols, ptr, lo, hi):
        out.index_add_(0, (rows[s] - lo) * n + cols[t], v[s] * v[t])
    return out.view(hi - lo, n)


def spgemm_hits(rows, cols, ptr, n: int, lo: int, hi: int) -> torch.Tensor:
    """Rows lo:hi of ``A @ A``'s structure, a bool ``[hi - lo, n]`` slab:
    the positions that some term reaches, whatever the values."""
    hit = torch.zeros((hi - lo) * n, dtype=torch.bool, device=rows.device)
    for s, t in _terms(cols, ptr, lo, hi):
        hit[(rows[s] - lo) * n + cols[t]] = True
    return hit.view(hi - lo, n)


class Watched:
    """``watch`` and ``nonfinite`` of an operation whose answers are
    tensors; the operation makes ``self._nonfinite``, an int64 zero on its
    device."""

    def watch(self, out) -> None:
        """Count ``out`` if it holds a NaN or an inf: queued on the card,
        with no wait (``nonfinite`` reads the count)."""
        self._nonfinite += ~torch.isfinite(out).all()

    def nonfinite(self) -> int:
        """The answers watched since the last call that held a NaN or an
        inf (a wait for the card)."""
        count = int(self._nonfinite.item())
        self._nonfinite.zero_()
        return count


def share(got: torch.Tensor, want: torch.Tensor,
          scale: torch.Tensor) -> float:
    """The largest elementwise ``|got - want| / scale`` (see the module's
    docstring); 0 for no elements."""
    if not want.numel():
        return 0.0
    err = (got.double() - want.double()).abs()
    s = torch.where(err == 0, torch.zeros_like(err), err / scale)
    return float(torch.nan_to_num(s, nan=math.inf, posinf=math.inf).max())
