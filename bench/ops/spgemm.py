"""The square ``C = A @ A`` into a dense C: a user's call ``matmul(A_h,
A_h)`` with one placed ``DistBSR`` handle as both operands, as the repo's
``benchmarks/fig5_spgemm_scaling.py`` squares its graph; every multiply is
the same product.

Traffic keys: ``dtype`` (A's blocks and C), ``matmul`` (keyword arguments
of ``matmul``), ``limits``, ``control`` (the precision below ``dtype``).

The harness holds a sampled answer as a lossless record of its nonzeros
(:meth:`SpGEMM.keep`): a dense C at scale 16 takes 17.2 GB in float32,
and three answers held whole would leave the program no room on the card.
An answer whose nonzeros all lie on the product's structure (counted at
set-up from the benchmark's own nonzeros) is held as its values there,
beside the structure, which every such record shares.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from bench import inputs, reference, work


class Held(NamedTuple):
    """An n x n answer's nonzeros in CSR: the row pointer (int64, n + 1),
    each nonzero's column (int32) and value.  Every element outside them is
    exactly 0, so the record gives back the whole answer."""
    ptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor


def record(slabs, n: int, device) -> Held:
    """The record of the n x n answer whose blocks of rows ``slabs`` yields
    in order."""
    counts, cols, vals = [], [], []
    for slab in slabs:
        at = slab.nonzero()
        counts.append(torch.bincount(at[:, 0], minlength=slab.shape[0]))
        cols.append(at[:, 1].to(torch.int32))
        vals.append(slab[at[:, 0], at[:, 1]])
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.cat(counts), 0, out=ptr[1:])
    return Held(ptr, torch.cat(cols), torch.cat(vals))


def rebuild(held: Held, lo: int, hi: int, n: int) -> torch.Tensor:
    """Rows lo:hi of the answer ``held`` records, dense."""
    s0, s1 = int(held.ptr[lo]), int(held.ptr[hi])
    out = torch.zeros((hi - lo) * n, dtype=held.vals.dtype,
                      device=held.vals.device)
    row = torch.repeat_interleave(
        torch.arange(hi - lo, device=out.device),
        held.ptr[lo + 1:hi + 1] - held.ptr[lo:hi])
    out[row * n + held.cols[s0:s1]] = held.vals[s0:s1]
    return out.view(hi - lo, n)


class SpGEMM(reference.Watched):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from repro_torch.core.api import matmul
        self._matmul = matmul
        self.cfg, self.mix, self.device = cfg, mix, device
        self.dtype = getattr(torch, mix["dtype"])
        m = self.mat = inputs.matrix(cfg, inputs.generator(seed, device),
                                     self.dtype, device)
        t0 = time.perf_counter()
        self.ptr = reference.row_pointer(m.rows, m.n)
        # C's structure, as a record's row pointer and columns
        c = record((reference.spgemm_hits(m.rows, m.cols, self.ptr, m.n,
                                          lo, hi)
                    for lo, hi in reference.row_blocks(m.n)), m.n, device)
        self.c_ptr, self.c_cols, self.c_nnz = c.ptr, c.cols, c.cols.numel()
        del c
        log(f"C = A @ A: {self.c_nnz} structural nonzeros "
            f"({100 * self.c_nnz / m.n ** 2:.4f} % of {m.n} x {m.n}), "
            f"counted in {time.perf_counter() - t0:.2f} s")
        self.a_h = inputs.handle(m, cfg, device, log)
        self.kw = dict(mix["matmul"])
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def call(self):
        """One multiply, as a user calls it; (its answer, 0: every multiply
        squares the same handle)."""
        return self._matmul(self.a_h, self.a_h, **self.kw), 0

    def valid(self, out) -> bool:
        """The answer's kind and shape (host only: no read of the card)."""
        return isinstance(out, torch.Tensor) and out.layout == torch.strided \
            and out.dtype == self.dtype \
            and tuple(out.shape) == (self.mat.n, self.mat.n)

    def keep(self, out, key):
        """What the harness holds of a drawn answer: the :class:`Held`
        record of its nonzeros, or None for an answer with more nonzeros
        than ``A @ A`` has positions (a failed one, never recorded, so that
        a garbage answer cannot fill the card)."""
        n = self.mat.n
        blocks = reference.row_blocks(n)
        row = torch.repeat_interleave(torch.arange(n, device=out.device),
                                      self.c_ptr.diff())
        on = out[row, self.c_cols.long()]
        del row
        count = sum(torch.count_nonzero(out[lo:hi]) for lo, hi in blocks)
        count, inside = torch.stack([count, torch.count_nonzero(on)]).tolist()
        if count > self.c_nnz:
            return None
        if inside == count:
            # every nonzero lies on the structure: its values there, one
            # gather in place of a pass of nonzero() over the whole answer
            return Held(self.c_ptr, self.c_cols, on)
        del on
        return record((out[lo:hi] for lo, hi in blocks), n, out.device)

    def diagnose(self, log) -> None:
        """One multiply: B1's launches by path, beside the plan and A's real
        blocks."""
        from repro_torch.core.api import plan_matmul
        from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
        plan = plan_matmul(self.a_h, self.a_h, **self.kw)
        before = dict(bsr_spmm_cuda.paths)
        out, _ = self.call()
        torch.cuda.synchronize()
        del out
        launched = {k: v - before[k] for k, v in bsr_spmm_cuda.paths.items()}
        counts = self.a_h.tiled.counts
        log(f"plan: {plan.algorithm.name}, wire {plan.wire}, overlap "
            f"{plan.overlap}, output {plan.output}; A's real blocks "
            f"{int(counts.sum())} ({counts.flatten().tolist()} a tile); B1's "
            f"launches in one multiply by path {launched}")

    def work(self) -> dict:
        m = self.mat
        return work.spgemm_work(m.host_rows, m.host_cols, (m.n, m.n),
                                self.mix["dtype"])

    def free_program(self) -> None:
        from repro_torch.core import api
        self.a_h = None
        api.clear_plan_cache()

    def control(self, sample: list, precision: str) -> list:
        """The reference in ``precision``, put in the program's place, held
        as the program's answers are."""
        m = self.mat
        held = record((reference.spgemm_rows(
            m.rows, m.cols, m.vals, self.ptr, m.n, lo, hi,
            precision).to(self.dtype)
            for lo, hi in reference.row_blocks(m.n)), m.n, m.vals.device)
        return [(key, held) for key, _ in sample]

    def judge(self, sample: list, log) -> dict:
        """The largest error share of every element of the held answers
        against the reference, one block of rows at a time."""
        m, worst = self.mat, 0.0
        held = list({id(h): h for _, h in sample}.values())
        blocks = reference.row_blocks(m.n) if held else []
        for lo, hi in blocks:
            args = (m.rows, m.cols, m.vals, self.ptr, m.n, lo, hi)
            want = reference.spgemm_rows(*args)
            scale = reference.spgemm_rows(*args, magnitudes=True)
            for h in held:
                worst = max(worst, reference.share(rebuild(h, lo, hi, m.n),
                                                   want, scale))
            del want, scale
        log(f"checked {len(sample)} answers ({len(held)} records), every "
            f"element, against the float64 reference in {len(blocks)} "
            f"blocks of rows")
        return {"err_share": worst}


def setup(cfg: dict, mix: dict, seed: int, device, log) -> SpGEMM:
    return SpGEMM(cfg, mix, seed, device, log)
