"""SpMM, ``C = A @ B``: a user's call ``matmul(A, B)`` with a plain
device tensor B, drawn in turn from a pool of at least
``inputs.POOL_BYTES``, A the configuration's placed handle.

Traffic keys: ``dtype`` (A's blocks and B), ``width`` (B's columns),
``matmul`` (keyword arguments of ``matmul``), ``limits``, ``control``
(the precision below ``dtype``).
"""
from __future__ import annotations

import math

import torch

from bench import inputs, reference, work


class SpMM(reference.Watched):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from repro_torch.core.api import matmul
        self._matmul = matmul
        self.cfg, self.mix, self.device = cfg, mix, device
        self.dtype = getattr(torch, mix["dtype"])
        gen = inputs.generator(seed, device)
        self.mat = inputs.matrix(cfg, gen, self.dtype, device)
        width = mix["width"]
        one = self.mat.n * width * self.dtype.itemsize
        count = max(1, math.ceil(inputs.POOL_BYTES / one))
        self.pool = inputs.dense_pool(gen, count, self.mat.n, width,
                                      self.dtype, device)
        log(f"B: {count} operands of {self.mat.n} x {width} "
            f"{mix['dtype']}, {count * one / 1e6:.1f} MB in all")
        self.a_h = inputs.handle(self.mat, cfg, device, log)
        self.kw = dict(mix["matmul"])
        self.turn = 0
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def call(self):
        """One multiply, as a user calls it; (its answer, B's index)."""
        i = self.turn
        self.turn = (i + 1) % len(self.pool)
        return self._matmul(self.a_h, self.pool[i], **self.kw), i

    def valid(self, out) -> bool:
        """The answer's kind and shape (host only: no read of the card)."""
        return isinstance(out, torch.Tensor) and out.dtype == self.dtype \
            and tuple(out.shape) == (self.mat.n, self.mix["width"])

    def keep(self, out, key):
        """What the harness holds of a drawn answer: the answer itself."""
        return out

    def diagnose(self, log) -> None:
        """One multiply with B1's block counter on: the blocks it multiplied
        and its launches, beside the work the format implies (every slot
        of a real block multiplied) and that work's bound."""
        from repro_torch.core.api import plan_matmul
        from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
        plan = plan_matmul(self.a_h, self.pool[0], **self.kw)
        counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        before = bsr_spmm_cuda.launches
        bsr_spmm_cuda.block_counter = counter
        try:
            out, _ = self.call()
            torch.cuda.synchronize()
        finally:
            bsr_spmm_cuda.block_counter = None
        del out
        blocks = int(counter.item())
        bs, g = self.cfg["block_size"], self.cfg["g"]
        tn = self.mix["width"] // g
        flops = 2 * blocks * bs * bs * tn
        name = self.mix["dtype"]
        log(f"plan: {plan.algorithm.name}, wire {plan.wire}, overlap "
            f"{plan.overlap}, output {plan.output}; B1 multiplied {blocks} "
            f"blocks in {bsr_spmm_cuda.launches - before} launches "
            f"(format work {flops} flops, bound "
            f"{flops / work.PEAK_FLOPS[name] * 1e3:.4f} ms at the "
            f"{name} peak; needed {self.work()['flops']} flops)")

    def work(self) -> dict:
        return work.spmm_work(self.mat.host_rows, (self.mat.n, self.mat.n),
                              self.mix["width"], self.mix["dtype"])

    def free_program(self) -> None:
        from repro_torch.core import api
        self.a_h = None
        api.clear_plan_cache()

    def control(self, sample: list, precision: str) -> list:
        """The reference in ``precision``, put in the program's place."""
        m = self.mat
        return [(i, reference.spmm(m.rows, m.cols, m.vals, self.pool[i],
                                   m.n, precision).to(self.dtype))
                for i, _ in sample]

    def judge(self, sample: list, log) -> dict:
        """The largest error share of the kept answers (of the kind and
        shape :meth:`valid` asks) against the reference."""
        m, worst, refs = self.mat, 0.0, {}
        for i, out in sample:
            if i not in refs:
                b = self.pool[i]
                refs[i] = (reference.spmm(m.rows, m.cols, m.vals, b, m.n),
                           reference.spmm(m.rows, m.cols, m.vals, b, m.n,
                                          magnitudes=True))
            want, scale = refs[i]
            worst = max(worst, reference.share(out, want, scale))
        log(f"checked {len(sample)} answers (B operands "
            f"{sorted(i for i, _ in sample)}) against the float64 reference")
        return {"err_share": worst}


def setup(cfg: dict, mix: dict, seed: int, device, log) -> SpMM:
    return SpMM(cfg, mix, seed, device, log)
