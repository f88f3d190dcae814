"""The plain reference against a float64 dense product, the error share,
and the controls' rounding."""
import math

import pytest
import torch

from bench import inputs, reference

CFG = {"scale": 7, "edgefactor": 8, "a": 0.6, "b": 0.4 / 3, "c": 0.4 / 3,
       "d": 0.4 / 3, "graph_seed": 4}


def _dense(mat):
    d = torch.zeros((mat.n, mat.n), dtype=torch.float64)
    d[mat.rows, mat.cols] = mat.vals.double()
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_against_dense(dtype):
    gen = inputs.generator(11, "cpu")
    mat = inputs.matrix(CFG, gen, dtype, "cpu")
    b = inputs.dense_pool(gen, 1, mat.n, 24, dtype, "cpu")[0]
    a = _dense(mat)
    got = reference.spmm(mat.rows, mat.cols, mat.vals, b, mat.n)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, a @ b.double(), rtol=1e-12, atol=1e-12)
    mag = reference.spmm(mat.rows, mat.cols, mat.vals, b, mat.n,
                         magnitudes=True)
    torch.testing.assert_close(mag, a.abs() @ b.double().abs(), rtol=1e-12,
                               atol=1e-12)


def test_share():
    want = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    scale = torch.tensor([2.0, 0.0, 4.0], dtype=torch.float64)
    assert reference.share(want.float(), want, scale) == 0.0
    got = torch.tensor([1.5, 0.0, 2.0])
    assert reference.share(got, want, scale) == pytest.approx(0.25)
    # an error where |A| @ |B| is 0 (a structural zero), and a NaN
    assert math.isinf(reference.share(torch.tensor([1.0, 1e-30, 2.0]), want,
                                      scale))
    assert math.isinf(reference.share(torch.tensor([1.0, 0.0, float("nan")]),
                                      want, scale))


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 1.0 + 3 * 2.0 ** -11,
                      -3.0, 0.0])
    got = reference.rounded(x, "tf32")
    # ties to even at the 10th mantissa bit
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -3.0, 0.0]
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert float(((reference.rounded(r, "tf32") - r) / r).abs().max()) \
        <= 2.0 ** -11


def test_fp8_rounding():
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    err = (reference.rounded(r, "fp8") - r).abs()
    assert float(err.max()) > 2.0 ** -8
    assert float((err / r.abs())[r.abs() > 0.02].max()) <= 2.0 ** -4


def test_unknown_precision():
    with pytest.raises(ValueError):
        reference.rounded(torch.ones(1), "int4")
