"""The port's CUDA kernel and its main path on the card.

Every test here carries the ``cuda`` marker and skips where there is no
card; none imports JAX, so the file runs on a machine with PyTorch alone::

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same inputs,
element by element against the scale that bounds rounding, |A| @ |B|:
``|got - want| <= 1e-5 * (|A| @ |B|) + step * |want|``.  1e-5 is the
reference's float32 tolerance for sums taken in another order; ``step`` is
one bf16 step (2^-7 of the value) for each bf16 rounding that may land on
the neighbouring value, 0 for a float32 output.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import DistBSR, DistDense, matmul
from repro_torch.core.bsr import TiledBSR, random_sparse
from repro_torch.core.grid import ProcessGrid
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_spmm import CHUNK, bsr_spmm_cuda

TOL = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_close(got: torch.Tensor, want: torch.Tensor,
                 scale: torch.Tensor, step: float = 0.0,
                 tol: float = TOL) -> None:
    """|got - want| <= tol * scale + step * |want|, elementwise."""
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float().cpu() - want.float().cpu()).abs()
    allowed = tol * scale.float().cpu() + step * want.float().cpu().abs()
    assert bool((err <= allowed).all()), (
        f"max error {err.max().item():.3e}, "
        f"{(err / allowed.clamp_min(1e-30)).max().item():.3g} of allowed")


def abs_product(blocks, rows, cols, dense, nbr: int) -> torch.Tensor:
    return ref.bsr_spmm_raw_ref(blocks.abs(), rows, cols, dense.abs(), nbr,
                                out_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n,dtype,capacity", [
    (4, 37, torch.float32, "bucket"), (8, 70, torch.float32, "bucket"),
    (16, 129, torch.float32, "bucket"), (64, 37, torch.float32, "bucket"),
    (128, 64, torch.float32, "bucket"), (192, 70, torch.float32, "bucket"),
    (8, 37, torch.bfloat16, "bucket"), (64, 129, torch.bfloat16, "bucket"),
    (128, 256, torch.bfloat16, "bucket"),
    # capacity padding several chunks long in one block-row
    (8, 33, torch.float32, 5 * CHUNK), (16, 64, torch.bfloat16, 3 * CHUNK),
])
def test_kernel_matches_plain_version(card, bs, n, dtype, capacity):
    m, k = 6 * bs + bs // 2, 3 * 4 * bs
    a = random_sparse(m, k, 0.3, seed=bs)
    a[:, k // 3:2 * k // 3] = 0                 # one empty tile
    t = TiledBSR.from_dense(a, ProcessGrid(1, 3), bs, capacity=capacity,
                            dtype=dtype, device=card)
    s, nbr = t.store_capacity, t.tile_shape[0] // bs
    dense = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, k // 3, n)).astype(np.float32)).to(card, dtype)
    args = (t.blocks.reshape(3, s, bs, bs), t.rows.reshape(3, s),
            t.cols.reshape(3, s), dense)
    before = bsr_spmm_cuda.launches
    got = ops.bsr_spmm_raw(*args, n_block_rows=nbr, augment=False)
    assert bsr_spmm_cuda.launches == before + 1
    want = ref.bsr_spmm_raw_ref(*args, nbr)
    torch.cuda.synchronize()
    assert_close(got, want, abs_product(*args, nbr),
                 BF16_STEP if dtype == torch.bfloat16 else 0.0)


@pytest.mark.cuda
def test_kernel_augments_unsorted_lists_and_mixed_types(card):
    rng = np.random.default_rng(5)
    bs, nbr, nbc, n = 16, 5, 3, 21
    blocks = torch.from_numpy(rng.standard_normal((9, bs, bs)).astype(
        np.float32)).to(card, torch.bfloat16)
    rows = torch.tensor([4, 0, 2, 2, 0, 4, 1, 0, 2], dtype=torch.int32,
                        device=card)                 # row 3 absent, unsorted
    cols = torch.tensor([1, 0, 2, 2, 0, 1, 1, 2, 0], dtype=torch.int32,
                        device=card)
    dense = torch.randn(nbc * bs, n, device=card)
    got = ops.bsr_spmm_raw(blocks, rows, cols, dense, n_block_rows=nbr,
                           impl="cuda")
    assert got.dtype == torch.float32
    assert_close(got, ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr),
                 abs_product(blocks, rows, cols, dense, nbr))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    blocks = torch.zeros((1, 2, 4, 4), device=card, dtype=torch.float16)
    rows = torch.zeros((1, 2), dtype=torch.int32, device=card)
    dense = torch.zeros((1, 8, 3), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bsr_spmm_cuda(blocks, rows, rows, dense, n_block_rows=1)
    with pytest.raises(ValueError, match="int32"):
        bsr_spmm_cuda(blocks.float(), rows.long(), rows, dense.float(),
                      n_block_rows=1)
    with pytest.raises(ValueError, match="K a multiple"):
        bsr_spmm_cuda(blocks.float(), rows, rows, dense[:, :6].float(),
                      n_block_rows=1)
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm_cuda(blocks.float(), rows, rows,
                      torch.zeros((1, 3, 8), device=card).transpose(1, 2),
                      n_block_rows=1)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_main_path_on_the_card_matches_the_cpu(card, g, overlap):
    a_d = random_sparse(50, 44, 0.2, seed=g)
    s_d = random_sparse(44, 44, 0.15, seed=10 + g)
    b = np.random.default_rng(g).standard_normal((44, 13)).astype(np.float32)
    results = {}
    for dev in (card, torch.device("cpu")):
        a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=dev)
        s_h = DistBSR.from_dense(s_d, g=g, block_size=8, device=dev)
        results[dev.type] = (matmul(a_h, b, overlap=overlap),
                             matmul(a_h, s_h, overlap=overlap))
    before = bsr_spmm_cuda.launches
    a_h = DistBSR.from_dense(a_d, g=g, block_size=8)     # the card by default
    assert a_h.device.type == "cuda"
    matmul(a_h, b, overlap=overlap)
    assert bsr_spmm_cuda.launches == before + g          # one per ring step
    scales = (torch.from_numpy(np.abs(a_d) @ np.abs(b)),
              torch.from_numpy(np.abs(a_d) @ np.abs(s_d)))
    for got, want, scale in zip(results["cuda"], results["cpu"], scales):
        assert got.is_cuda
        assert_close(got, want, scale)
    assert_close(results["cuda"][0].cpu(), torch.from_numpy(a_d @ b),
                 scales[0])


@pytest.mark.cuda
def test_bf16_main_path_on_the_card(card):
    a_d = random_sparse(64, 64, 0.2, seed=3)
    b = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=2, block_size=16, dtype=torch.bfloat16,
                             device=card)
    b_h = DistDense.for_rhs(torch.from_numpy(b).bfloat16(), a_h)
    got = matmul(a_h, b_h)
    want = matmul(DistBSR.from_dense(a_d, g=2, block_size=16,
                                     dtype=torch.bfloat16, device="cpu"),
                  torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    # each of the g partials and g - 1 running sums is rounded to bf16 on
    # both sides, and each rounding may land one bf16 step apart: at most
    # 2^-7 of a magnitude below |A| @ |B| each
    b16 = torch.from_numpy(b).bfloat16().float().numpy()
    scale = torch.from_numpy(np.abs(a_d) @ np.abs(b16))
    assert_close(got, want, scale, tol=TOL + (2 * a_h.g - 1) * BF16_STEP)
