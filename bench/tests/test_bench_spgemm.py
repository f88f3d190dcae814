"""The square's operation on the CPU at a small size: the held record of
an answer, the row-block reference against a dense float64 product, the
refusal of an answer with too many nonzeros, and the control's record."""
import math
import time

import pytest
import torch

from bench import harness, manifest, reference
from bench.tests.conftest import SMALL

CELL = "spgemm-rmat16-dense"
SPGEMM = manifest.operation("spgemm")


@pytest.fixture
def op():
    _, cfg, mix = harness.cell_files(CELL, SMALL[CELL])
    return SPGEMM.setup(cfg, mix, 2 ** 31 + 3, "cpu", lambda *a: None)


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of 40 rows and chunks of 1,000 terms, so that a small answer
    spans many of each."""
    monkeypatch.setattr(reference, "SLAB", 40 * 512)
    monkeypatch.setattr(reference, "TERMS", 1000)


def _dense(mat):
    d = torch.zeros((mat.n, mat.n), dtype=torch.float64)
    d[mat.rows, mat.cols] = mat.vals.double()
    return d


def _answer(op):
    out, key = op.call()
    assert key == 0 and op.valid(out)
    return out


def _rebuilt(op, held):
    n = op.mat.n
    return torch.cat([SPGEMM.rebuild(held, lo, hi, n)
                      for lo, hi in reference.row_blocks(n)])


def _off_structure(op, out):
    """``out`` with one element planted where ``|A| @ |A|`` is 0, and one
    structural element zeroed to keep the count of nonzeros."""
    m = op.mat
    mags = reference.spgemm_rows(m.rows, m.cols, m.vals, op.ptr, m.n, 0, m.n,
                                 magnitudes=True)
    off = (mags == 0).nonzero()[0]
    on = (out != 0).nonzero()[0]
    out = out.clone()
    out[on[0], on[1]] = 0.0
    out[off[0], off[1]] = 1e-3
    return out


@pytest.mark.usefixtures("small_blocks")
@pytest.mark.parametrize("planted", [False, True])
def test_record_rebuilds_the_answer_bit_for_bit(op, planted):
    """An answer on the product's structure is held as its values there,
    beside the shared structure; one with an element off it by its own
    nonzeros.  Either gives the answer back."""
    out = _answer(op)
    if planted:
        out = _off_structure(op, out)
    assert len(reference.row_blocks(op.mat.n)) > 5
    held = op.keep(out, 0)
    assert isinstance(held, SPGEMM.Held)
    assert (held.ptr is op.c_ptr) == (not planted)
    if planted:
        assert held.vals.numel() == int(torch.count_nonzero(out))
    else:
        assert held.vals.numel() == op.c_nnz
    back = _rebuilt(op, held)
    assert back.dtype == out.dtype
    assert torch.equal(back, out)
    assert torch.equal(torch.signbit(back), torch.signbit(out))


@pytest.mark.usefixtures("small_blocks")
def test_reference_rows_are_the_dense_product(op):
    m = op.mat
    a = _dense(m)
    want, mags = a @ a, a.abs() @ a.abs()
    for name, got in (("ref", False), ("mag", True)):
        rows = torch.cat([reference.spgemm_rows(
            m.rows, m.cols, m.vals, op.ptr, m.n, lo, hi, magnitudes=got)
            for lo, hi in reference.row_blocks(m.n)])
        assert rows.dtype == torch.float64
        torch.testing.assert_close(rows, mags if got else want, rtol=1e-12,
                                   atol=1e-12, msg=name)
    assert op.c_nnz == int(torch.count_nonzero(
        (a != 0).double() @ (a != 0).double()))


@pytest.mark.usefixtures("small_blocks")
def test_judge_agrees_with_a_dense_product(op):
    """The judge's reading is the error share against a dense float64
    ``A @ A`` made by plain torch, over every element."""
    m = op.mat
    out = _answer(op)
    a = _dense(m)
    direct = reference.share(out, a @ a, a.abs() @ a.abs())
    got = op.judge([(0, op.keep(out, 0))], lambda *x: None)["err_share"]
    assert 0 < got == pytest.approx(direct, rel=1e-9, abs=0)
    assert got < 1e-6


def test_element_off_the_structure_reads_inf(op):
    """An answer with one element where ``|A| @ |A|`` is 0 (and one
    structural element zeroed, so that it is not refused): recorded, and
    inf."""
    held = op.keep(_off_structure(op, _answer(op)), 0)
    assert held is not None
    assert math.isinf(op.judge([(0, held)], lambda *x: None)["err_share"])


def test_answer_with_too_many_nonzeros_fails(op, monkeypatch):
    """``keep`` refuses an answer with more nonzeros than the product has
    positions; in a run, every such answer counts as failed and none is
    held."""
    out = _answer(op)
    assert op.keep(out, 0) is not None
    out[out == 0] = 0.5
    assert op.keep(out, 0) is None
    from repro_torch.core.api import MatmulPlan
    old = MatmulPlan._epilogue

    def filled(self, *a, **kw):
        c = old(self, *a, **kw)
        c[c == 0] = 0.5
        return c
    monkeypatch.setattr(MatmulPlan, "_epilogue", filled)
    result, compared = harness.run_cell(
        CELL, 5, 0.3, False, t_start=time.perf_counter(), device="cpu",
        overrides=SMALL[CELL], log=lambda *a: None)
    assert not result["correct"]
    assert compared["failed"][0] == result["attempted"] > 0
    assert compared["err_share"][0] == 0.0


def test_control_is_held_as_the_program_is(op):
    sample = [(0, op.keep(_answer(op), 0))] * 3
    ctrl = op.control(sample, "tf32")
    assert [k for k, _ in ctrl] == [0, 0, 0]
    assert ctrl[0][1] is ctrl[2][1]
    assert isinstance(ctrl[0][1], SPGEMM.Held)
    assert ctrl[0][1].vals.dtype == torch.float32

