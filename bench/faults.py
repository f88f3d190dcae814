"""Faults planted underneath the timed path, for the checks that the
comparison catches them (``bench/tests/test_bench_faults.py`` on the CPU,
``bench/control.py --faults`` on the card).  Each is a context manager
that patches the program at run time and restores it; no file of the
program changes.

* ``stale_step``: a ring step returns its carry unchanged (every step
  after the first adds nothing);
* ``half_batch``: each local multiply leaves out half of its operand (the
  second half of B's columns) and doubles the rest, the mean taken over
  what is left;
* ``no_exchange``: the ring's shift between grid positions is left out;
* ``altered_answer``: one element of the answer is changed where the
  epilogue produces it (the answer's last element, in R-MAT's emptiest
  row), by 1.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextlib.contextmanager
def stale_step():
    from repro_torch.kernels import ops

    def spmm(old):
        def f(*a, out=None, **kw):
            return out if out is not None else old(*a, **kw)
        return f

    with _patched(ops, "bsr_spmm_raw", spmm):
        yield


def _halved(x, dim: int):
    x = x.clone()
    half = x.shape[dim] // 2
    x.narrow(dim, half, x.shape[dim] - half).zero_()
    x.narrow(dim, 0, half).mul_(2)
    return x


@contextlib.contextmanager
def half_batch():
    from repro_torch.kernels import ops

    def spmm(old):
        def f(blocks, rows, cols, dense, **kw):
            return old(blocks, rows, cols, _halved(dense, -1), **kw)
        return f

    with _patched(ops, "bsr_spmm_raw", spmm):
        yield


@contextlib.contextmanager
def no_exchange():
    """Both forms of the shift: of the tiles and of the host tile maps
    (the dense-output bodies read the placed stacks through them)."""
    from repro_torch.core.executor import StackedExecutor

    def shift(old):
        def f(self, tree, axis, sign=1):
            return dict(tree)
        return f

    def shift_map(old):
        def f(self, tile_map, axis, sign=1):
            return tile_map.copy()
        return f
    with _patched(StackedExecutor, "shift", shift), \
            _patched(StackedExecutor, "shift_map", shift_map):
        yield


@contextlib.contextmanager
def altered_answer():
    from repro_torch.core.api import MatmulPlan

    def dense(old):
        def f(self, *a, **kw):
            out = old(self, *a, **kw)
            out.view(-1)[-1] += 1.0
            return out
        return f

    with _patched(MatmulPlan, "_epilogue", dense):
        yield


FAULTS = {"stale_step": stale_step, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_answer": altered_answer}
