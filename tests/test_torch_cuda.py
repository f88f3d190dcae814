"""The port's CUDA kernels and their paths on the card.

Every test here carries the ``cuda`` marker and skips where there is no
card; none imports JAX, so the file runs on a machine with PyTorch alone::

    python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs,
element by element against the scale that bounds rounding, |A| @ |B|:
``|got - want| <= 1e-5 * (|A| @ |B|) + step * |want|``.  1e-5 is the
reference's float32 tolerance for sums taken in another order; ``step`` is
one bf16 step (2^-7 of the value) for each bf16 rounding that may land on
the neighbouring value, 0 for a float32 output.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import DistBSR, DistDense, matmul, plan_matmul
from repro_torch.core.bsr import BSR, TiledBSR, random_sparse
from repro_torch.core.grid import ProcessGrid
from repro_torch.core.symbolic import symbolic_spgemm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_pair import (bsr_pair_accumulate_cuda,
                                          bsr_pair_matmul_cuda, kernel_path,
                                          pair_table)
from repro_torch.kernels.bsr_spmm import CHUNK, bsr_spmm_cuda, spmm_table
from repro_torch.kernels.bsr_spmm import kernel_path as kernel_path_b1

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


def _b1_case(bs: int, n: int, dtype, capacity, device):
    """Three tiles (one empty) of a TiledBSR, stacked as B1's pool, their
    stored lists and a B pool of ragged width."""
    m, k = 6 * bs + bs // 2, 3 * 4 * bs
    a = random_sparse(m, k, 0.3, seed=bs)
    a[:, k // 3:2 * k // 3] = 0                 # one empty tile
    t = TiledBSR.from_dense(a, ProcessGrid(1, 3), bs, capacity=capacity,
                            dtype=dtype, device=device)
    s, nbr = t.store_capacity, t.tile_shape[0] // bs
    dense = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, k // 3, n)).astype(np.float32)).to(device, dtype)
    return (t, (t.blocks.reshape(3, s, bs, bs), t.rows.reshape(3, s),
                t.cols.reshape(3, s), dense), nbr)


def _counted(fn):
    """``fn()`` with B1's block counter on: (its result, the blocks its
    launches multiplied, counted on the card)."""
    counter = torch.zeros(1, dtype=torch.int64, device="cuda")
    bsr_spmm_cuda.block_counter = counter
    try:
        out = fn()
    finally:
        bsr_spmm_cuda.block_counter = None
    torch.cuda.synchronize()
    return out, int(counter.item())


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n,dtype,capacity", [
    (4, 37, torch.float32, "bucket"), (8, 70, torch.float32, "bucket"),
    (16, 129, torch.float32, "bucket"), (24, 45, torch.float32, "bucket"),
    (64, 37, torch.float32, "bucket"), (128, 64, torch.float32, "bucket"),
    (192, 70, torch.float32, "bucket"),
    (8, 37, torch.bfloat16, "bucket"), (16, 45, torch.bfloat16, "bucket"),
    (24, 70, torch.bfloat16, "bucket"), (64, 129, torch.bfloat16, "bucket"),
    (128, 256, torch.bfloat16, "bucket"), (192, 70, torch.bfloat16, "bucket"),
    # capacity padding several chunks long in one block-row: listed as real
    # (a raw call), that segment takes partials and the reduce pass
    (8, 33, torch.float32, 5 * CHUNK), (16, 64, torch.bfloat16, 3 * CHUNK),
])
def test_kernel_matches_plain_version(card, bs, n, dtype, capacity):
    t, args, nbr = _b1_case(bs, n, dtype, capacity, card)
    before = bsr_spmm_cuda.launches
    got, multiplied = _counted(lambda: ops.bsr_spmm_raw(
        *args, n_block_rows=nbr, augment=False))
    assert bsr_spmm_cuda.launches == before + 1
    assert multiplied == args[0].shape[0] * args[0].shape[1]   # all listed
    want = ref.bsr_spmm_raw_ref(*args, nbr)
    torch.cuda.synchronize()
    assert_close(got, want, abs_product(*args, nbr),
                 BF16_STEP if dtype == torch.bfloat16 else 0.0)
    assert kernel_path_b1(bs, dtype) == _expected_path(bs, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,dtype", [(8, torch.float32), (64, torch.float32),
                                      (24, torch.bfloat16),
                                      (64, torch.bfloat16),
                                      (128, torch.bfloat16)])
def test_kernel_multiplies_the_real_blocks_fresh_and_into_c(card, bs, dtype):
    """With the storage layout's real mask the kernel multiplies the real
    blocks alone (counted on the card), writes a fresh C equal to the plain
    version, zero-fills the block-rows no real block visits, and adds a
    second launch into C in place: C + the sum rounded to C's type first,
    block-rows no real block visits bit-identical."""
    t, (blocks, rows, cols, dense), nbr = _b1_case(bs, 45, dtype, "bucket",
                                                   card)
    s = blocks.shape[1]
    real = t.real_slots().reshape(3, s)
    table = spmm_table(torch.arange(3)[:, None] * s + torch.arange(s), rows,
                       cols, nbr, real=real, device=card)
    assert table.real_blocks == int(t.counts.sum()) and table.fill.shape[1]
    got, multiplied = _counted(lambda: bsr_spmm_cuda(blocks, dense, table))
    assert multiplied == table.real_blocks
    want = ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr)
    scale = abs_product(blocks, rows, cols, dense, nbr)
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    assert_close(got, want, scale, step)
    for tile, row in table.fill.T.tolist():
        assert not got[tile, row * bs:(row + 1) * bs].any()
    carry = got.clone()
    again = bsr_spmm_cuda(blocks, dense, table, out=got)
    assert again is got
    torch.cuda.synchronize()
    want_c = (carry.float() + want.float()).to(dtype)
    assert_close(got, want_c, 2 * scale, 2 * step)
    for tile, row in table.fill.T.tolist():
        assert torch.equal(got[tile, row * bs:(row + 1) * bs],
                           carry[tile, row * bs:(row + 1) * bs])


@pytest.mark.cuda
def test_kernel_reads_pools_through_the_maps(card):
    """Output tile t multiplies pool tile a_map[t] by B tile b_map[t], read
    in place: a permuted ring step equals the plain version on gathered
    copies."""
    _, (blocks, rows, cols, dense), nbr = _b1_case(16, 40, torch.float32,
                                                   "bucket", card)
    a_map, b_map = np.array([2, 0, 1]), np.array([1, 2, 0])
    got = ops.bsr_spmm_raw(blocks, rows, cols, dense, n_block_rows=nbr,
                           a_map=a_map, b_map=b_map)
    ai, bi = torch.as_tensor(a_map, device=card), torch.as_tensor(b_map,
                                                                  device=card)
    args = (blocks[ai], rows[ai], cols[ai], dense[bi])
    assert_close(got, ref.bsr_spmm_raw_ref(*args, nbr),
                 abs_product(*args, nbr))


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
    assert not got[3 * bs:4 * bs].any()
    assert_close(got, ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr),
                 abs_product(blocks, rows, cols, dense, nbr))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    blocks = torch.zeros((1, 2, 4, 4), device=card, dtype=torch.float16)
    rows = torch.zeros((1, 2), dtype=torch.int32)
    dense = torch.zeros((1, 8, 3), device=card, dtype=torch.float16)
    table = spmm_table(torch.arange(2)[None], rows, rows, 1, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bsr_spmm_cuda(blocks, dense, table)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bsr_spmm_cuda(blocks.float(), dense.float(),
                      spmm_table(torch.arange(2)[None], rows, rows, 1))
    with pytest.raises(ValueError, match="K a multiple"):
        bsr_spmm_cuda(blocks.float(), dense[:, :6].float(), table)
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm_cuda(blocks.float(),
                      torch.zeros((1, 3, 8), device=card).transpose(1, 2),
                      table)
    with pytest.raises(ValueError, match="reaches past"):
        bsr_spmm_cuda(blocks[:, :1].float(), dense.float(), table)
    with pytest.raises(ValueError, match="adds into"):
        bsr_spmm_cuda(blocks.float(), dense.float(), table,
                      out=torch.zeros((1, 4, 3), device=card,
                                      dtype=torch.bfloat16))
    bsr_spmm_cuda.block_counter = torch.zeros(1, dtype=torch.int32,
                                              device=card)
    try:
        with pytest.raises(ValueError, match="block counter"):
            bsr_spmm_cuda(blocks.float(), dense.float(), table)
    finally:
        bsr_spmm_cuda.block_counter = None


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
    _, multiplied = _counted(lambda: matmul(a_h, b, overlap=overlap))
    assert bsr_spmm_cuda.launches == before + g          # one per ring step
    # each step multiplies every tile's real blocks, and nothing else
    assert multiplied == g * int(a_h.counts.sum())
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


# ---------------------------------------------------------------------------
# the pair kernels (bsr_pair_accumulate, bsr_pair_matmul) and sparse outputs
# ---------------------------------------------------------------------------
def _pair_case(bs: int, dtype, device, seed: int = 0):
    """A @ A on a 2 x 2 grid: step 0's stacked tiles, [4, P] pair lists
    and the plan-time real mask, as the sparse-output ring feeds them (a hub
    row makes long segments; the symbolic phase's inert padding a longer
    one)."""
    a = random_sparse(12 * bs, 12 * bs, 0.04, seed=seed)
    a[:bs] += random_sparse(bs, 12 * bs, 0.6, seed=seed + 1)
    t = TiledBSR.from_dense(a, ProcessGrid(2, 2), bs, dtype=dtype,
                            device=device)
    sym = symbolic_spgemm(t, t)
    sched = sym.scheduled_pairs(lambda i, j, s, g: (i + j + s) % g)
    k = (np.arange(2)[:, None] + np.arange(2)[None, :]) % 2
    ii, jj = np.arange(2)[:, None], np.arange(2)[None, :]
    s = t.store_capacity
    blocks_a = t.blocks[ii, k].reshape(4, s, bs, bs)
    blocks_b = t.blocks[k, jj].reshape(4, s, bs, bs)
    lists = [torch.from_numpy(np.ascontiguousarray(
        sched[x][:, :, 0].reshape(4, -1))).to(device) for x in ("pa", "pb",
                                                             "ps")]
    return (blocks_a, blocks_b, lists, sym.store_capacity,
            sched["real"][:, :, 0].reshape(4, -1))


def _expected_path(bs: int, dtype) -> str:
    return "mma.sync bf16 tensor cores" \
        if dtype == torch.bfloat16 and bs % 16 == 0 else "SIMT float32 FMA"


PAIR_BS = [(bs, dtype) for bs in (4, 8, 16, 24, 32, 64)
           for dtype in (torch.float32, torch.bfloat16)] + [(96, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,dtype", PAIR_BS)
def test_pair_accumulate_kernel_matches_plain_version(card, bs, dtype):
    a, b, (pa, pb, ps), n_slots, real = _pair_case(bs, dtype, card)
    assert kernel_path(bs, dtype) == _expected_path(bs, dtype)
    want = ref.bsr_pair_accumulate_raw_ref(a, b, pa, pb, ps, n_slots)
    scale = ref.bsr_pair_accumulate_raw_ref(a.abs(), b.abs(), pa, pb, ps,
                                            n_slots)
    # the plan's table: real pairs only, short chunks so that the hub
    # segments store partials
    table = pair_table(ps, n_slots, real=real, chunk=2, device=card)
    assert table.n_parts > 0
    counter = torch.zeros(1, dtype=torch.int64, device=card)
    bsr_pair_accumulate_cuda.pair_counter = counter
    try:
        got = bsr_pair_accumulate_cuda(a, b, pa, pb, table)
    finally:
        bsr_pair_accumulate_cuda.pair_counter = None
    torch.cuda.synchronize()
    assert int(counter.item()) == int(real.sum()) == table.real_pairs
    assert_close(got, want, scale)
    # slots that only inert pairs visit come out exactly 0
    visited = torch.zeros((4, n_slots), dtype=torch.bool)
    for n in range(4):
        visited[n, ps[n].cpu()[torch.from_numpy(real[n])].long()] = True
    assert bool((~visited).any())
    assert bool((got.cpu()[~visited] == 0).all())
    # into a carry: carry + the step's sums on the visited slots, every
    # other slot bit-identical
    carry = torch.randn_like(want)
    before = carry.clone()
    bsr_pair_accumulate_cuda(a, b, pa, pb, table, out=carry)
    torch.cuda.synchronize()
    assert torch.equal(carry.cpu()[~visited], before.cpu()[~visited])
    expect = before + want
    assert_close(carry, expect, scale + expect.abs())
    # the bare op (no mask: every pair real) gives the same sums
    launches = bsr_pair_accumulate_cuda.launches
    bare = ops.bsr_pair_accumulate(a, b, pa, pb, ps, n_slots=n_slots,
                                   out_dtype=torch.float32)
    assert bsr_pair_accumulate_cuda.launches == launches + 1
    assert_close(bare, want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,dtype", PAIR_BS[:-1] + [(128, torch.float32),
                                                    (128, torch.bfloat16)])
def test_pair_matmul_kernel_matches_plain_version(card, bs, dtype):
    a_d = random_sparse(6 * bs, 6 * bs, 0.03, seed=bs)
    a_d[:, :bs] += random_sparse(6 * bs, bs, 0.5, seed=bs + 1)
    a = BSR.from_dense(a_d, bs, dtype=dtype, device=card)
    lists = [torch.from_numpy(x).to(card) for x in ops.build_pair_lists(
        a.rows, a.cols, a.nnzb, a.rows, a.cols, a.nnzb, 6, 6)[:4]]
    real = int(((lists[0] != a.nnzb) | (lists[1] != a.nnzb)).sum())
    before = bsr_pair_matmul_cuda.launches
    counter = torch.zeros(1, dtype=torch.int64, device=card)
    bsr_pair_matmul_cuda.pair_counter = counter
    try:
        got = ops.bsr_pair_matmul(a.blocks, a.blocks, *lists,
                                  n_block_rows=6, n_block_cols=6)
    finally:
        bsr_pair_matmul_cuda.pair_counter = None
    assert bsr_pair_matmul_cuda.launches == before + 1
    assert int(counter.item()) == real
    assert got.dtype == dtype
    ext = torch.cat([a.blocks, a.blocks.new_zeros((1, bs, bs))])
    want = ref.bsr_pair_matmul_raw_ref(ext, ext, *lists, 6, 6)
    scale = ref.bsr_pair_matmul_raw_ref(ext.abs(), ext.abs(), *lists, 6, 6,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert_close(got, want, scale,
                 BF16_STEP if dtype == torch.bfloat16 else 0.0)
    # the blocks that only the coverage dummies visit are exactly 0
    blocks = got.reshape(6, bs, 6, bs).permute(0, 2, 1, 3).cpu()
    dummy = scale.reshape(6, bs, 6, bs).permute(0, 2, 1, 3).cpu() \
        .flatten(2).amax(dim=2) == 0
    assert bool((blocks[dummy] == 0).all())


@pytest.mark.cuda
def test_pair_kernels_refuse_what_they_do_not_take(card):
    a, b, (pa, pb, ps), n_slots, real = _pair_case(4, torch.float32, card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.bsr_pair_accumulate(a.half(), b.half(), pa, pb, ps,
                                n_slots=n_slots)
    table = ops.pair_table(ps, n_slots, real=real, device=card)
    with pytest.raises(ValueError, match="int32"):
        bsr_pair_accumulate_cuda(a, b, pa.long(), pb, table)
    with pytest.raises(ValueError, match="do not match the pair table"):
        bsr_pair_accumulate_cuda(a, b, pa[:, :-1].contiguous(),
                                 pb[:, :-1].contiguous(), table)
    with pytest.raises(ValueError, match="real must be"):
        ops.pair_table(ps, n_slots, real=real[:, :-1], device=card)
    with pytest.raises(ValueError, match="writes float32"):
        bsr_pair_accumulate_cuda(a, b, pa, pb, table,
                                 out=torch.zeros(3, device=card))
    bsr_pair_accumulate_cuda.pair_counter = torch.zeros(
        1, dtype=torch.int32, device=card)
    try:
        with pytest.raises(ValueError, match="pair counter"):
            bsr_pair_accumulate_cuda(a, b, pa, pb, table)
    finally:
        bsr_pair_accumulate_cuda.pair_counter = None


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire,overlap", [("padded", "off"),
                                          ("packed", "on"),
                                          ("packed", "off")])
def test_sparse_output_on_the_card_matches_the_cpu(card, g, wire, overlap):
    a_d = random_sparse(50, 44, 0.06, seed=g)
    s_d = random_sparse(44, 44, 0.06, seed=10 + g)
    results = {}
    for dev in (card, torch.device("cpu")):
        a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
        s_h = DistBSR.from_dense(s_d, g=g, block_size=4, device=dev)
        before = bsr_pair_accumulate_cuda.launches
        out = matmul(a_h, s_h, output="sparse", wire=wire, overlap=overlap)
        launched = bsr_pair_accumulate_cuda.launches - before
        assert launched == (g if dev.type == "cuda" else 0)   # one a step
        results[dev.type] = out
        # the chained cube runs on the result as it is
        results[dev.type + "-chain"] = matmul(out, s_h, output="sparse",
                                              wire=wire)
    for key, scale in (("", np.abs(a_d) @ np.abs(s_d)),
                       ("-chain", np.abs(a_d) @ np.abs(s_d) @ np.abs(s_d))):
        got, want = results["cuda" + key], results["cpu" + key]
        for f in ("rows", "cols", "counts"):
            assert torch.equal(getattr(got.tiled, f).cpu(),
                               getattr(want.tiled, f))
        assert got.capacity == want.capacity
        assert_close(got.densify().cpu(), want.densify(),
                     torch.from_numpy(scale))
    plan = plan_matmul(DistBSR.from_dense(a_d, g=g, block_size=4,
                                          device=card),
                       DistBSR.from_dense(s_d, g=g, block_size=4,
                                          device=card), output="sparse",
                       wire=wire, overlap=overlap)
    assert all("table" in step for step in plan._pairs)
    # the plan's tables hold the real pairs alone
    assert sum(step["table"].real_pairs for step in plan._pairs) == \
        plan.symbolic.total_real_pairs()


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3])
def test_packed_dense_body_on_the_card_matches_the_cpu(card, g):
    a_d = random_sparse(50, 44, 0.2, seed=g)
    s_d = random_sparse(44, 44, 0.05, seed=20 + g)
    b = np.random.default_rng(g).standard_normal((44, 13)).astype(np.float32)
    got, want = [], []
    for dev, out in ((card, got), (torch.device("cpu"), want)):
        a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
        s_h = DistBSR.from_dense(s_d, g=g, block_size=4, device=dev)
        out.append(matmul(a_h, b, wire="packed"))
        out.append(matmul(a_h, s_h, wire="packed"))
    for x, y, scale in zip(got, want, (np.abs(a_d) @ np.abs(b),
                                       np.abs(a_d) @ np.abs(s_d))):
        assert_close(x.cpu(), y, torch.from_numpy(scale))


OTHER_SCHEDULES = ("summa_bcast", "summa_ag", "ring_a", "ring_c_bidir")


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("algorithm", OTHER_SCHEDULES)
def test_other_schedules_on_the_card_match_the_cpu(card, algorithm, g):
    """SpMM and dense-output SpGEMM through each other schedule, padded and
    packed wire, on the card against the CPU's plain path; B1 launches
    once per step (twice for ring_c_bidir's half-panels) and multiplies
    every tile's real blocks at each launch, nothing else."""
    a_d = random_sparse(50, 44, 0.2, seed=g)
    s_d = random_sparse(44, 44, 0.1, seed=10 + g)
    b = np.random.default_rng(g).standard_normal((44, 13)).astype(np.float32)
    results = {}
    for dev in (card, torch.device("cpu")):
        a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=dev)
        s_h = DistBSR.from_dense(s_d, g=g, block_size=8, device=dev)
        results[dev.type] = [matmul(a_h, rhs, algorithm=algorithm, wire=wire)
                             for rhs in (b, s_h)
                             for wire in ("padded", "packed")]
    per_step = 2 if algorithm == "ring_c_bidir" else 1
    a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=card)
    before = bsr_spmm_cuda.launches
    _, multiplied = _counted(lambda: matmul(a_h, b, algorithm=algorithm))
    assert bsr_spmm_cuda.launches == before + per_step * g
    assert multiplied == per_step * g * int(a_h.counts.sum())
    scales = [np.abs(a_d) @ np.abs(b)] * 2 + [np.abs(a_d) @ np.abs(s_d)] * 2
    for got, want, scale in zip(results["cuda"], results["cpu"], scales):
        assert got.is_cuda
        assert_close(got.cpu(), want, torch.from_numpy(scale))


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", OTHER_SCHEDULES)
def test_other_schedules_bf16_on_the_card(card, algorithm):
    """bf16 SpMM on the tensor-core path (bs 16) against the CPU's plain
    path: each of the g partials and g - 1 running sums rounds to bf16."""
    a_d = random_sparse(64, 64, 0.2, seed=3)
    b = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    got, want = (matmul(DistBSR.from_dense(a_d, g=2, block_size=16,
                                           dtype=torch.bfloat16, device=dev),
                        torch.from_numpy(b).bfloat16(), algorithm=algorithm)
                 for dev in (card, torch.device("cpu")))
    assert got.dtype == torch.bfloat16
    # as in test_bf16_main_path_on_the_card: 2g - 1 roundings, each at most
    # one bf16 step apart on the two sides
    b16 = torch.from_numpy(b).bfloat16().float().numpy()
    scale = torch.from_numpy(np.abs(a_d) @ np.abs(b16))
    assert_close(got.cpu(), want, scale, tol=TOL + 3 * BF16_STEP)


@pytest.mark.cuda
def test_bidir_with_unit_width_tiles_on_the_card(card):
    """tn == 1: ring_c_bidir's left half-panel is zero wide; only the right
    half launches B1."""
    a_d = random_sparse(16, 16, 0.3, seed=0)
    b = np.random.default_rng(11).standard_normal((16, 1)).astype(np.float32)
    a_h = DistBSR.from_dense(a_d, g=1, block_size=4, device=card)
    before = bsr_spmm_cuda.launches
    got = matmul(a_h, b, algorithm="ring_c_bidir")
    assert bsr_spmm_cuda.launches == before + 1
    assert_close(got.cpu(), torch.from_numpy(a_d @ b),
                 torch.from_numpy(np.abs(a_d) @ np.abs(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("algorithm", ["summa_bcast", "summa_ag"])
def test_summa_sparse_output_on_the_card_matches_the_cpu(card, algorithm, g):
    a_d = random_sparse(50, 44, 0.06, seed=g)
    s_d = random_sparse(44, 44, 0.06, seed=10 + g)
    results = {}
    for dev in (card, torch.device("cpu")):
        a_h = DistBSR.from_dense(a_d, g=g, block_size=4, device=dev)
        s_h = DistBSR.from_dense(s_d, g=g, block_size=4, device=dev)
        before = bsr_pair_accumulate_cuda.launches
        results[dev.type] = matmul(a_h, s_h, algorithm=algorithm,
                                   output="sparse")
        launched = bsr_pair_accumulate_cuda.launches - before
        assert launched == (g if dev.type == "cuda" else 0)   # one a step
    got, want = results["cuda"], results["cpu"]
    for f in ("rows", "cols", "counts"):
        assert torch.equal(getattr(got.tiled, f).cpu(),
                           getattr(want.tiled, f))
    assert_close(got.densify().cpu(), want.densify(),
                 torch.from_numpy(np.abs(a_d) @ np.abs(s_d)))


# ---------------------------------------------------------------------------
# B1 on non-finite B, and steal3d through B1
# ---------------------------------------------------------------------------
def _assert_same_nan_mask(got, want, scale, step=0.0):
    nan = torch.isnan(want.float().cpu())
    assert torch.equal(torch.isnan(got.float().cpu()), nan)
    assert bool(nan.any())
    keep = ~nan & torch.isfinite(want.float().cpu())
    assert_close(got.float().cpu()[keep], want.float().cpu()[keep],
                 scale.float().cpu()[keep], step)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,dtype", [(8, torch.float32), (64, torch.float32),
                                      (24, torch.bfloat16),
                                      (64, torch.bfloat16)])
def test_kernel_nan_mask_on_nonfinite_b(card, bs, dtype):
    """With an inf, a NaN and a -inf planted in B, the kernel over the real
    blocks alone gives the plain version's NaN mask (which multiplies every
    listed block, 0 * inf included), fresh and into C; on finite B its NaN
    pass writes nothing."""
    t, (blocks, rows, cols, dense), nbr = _b1_case(bs, 45, dtype, "bucket",
                                                   card)
    s = blocks.shape[1]
    table = spmm_table(torch.arange(3)[:, None] * s + torch.arange(s), rows,
                       cols, nbr, real=t.real_slots().reshape(3, s),
                       device=card)
    assert table.skip.shape[1] > 0
    bad = dense.clone()
    bad[0, 1, 3] = float("inf")
    bad[0, 2 * bs + 1, 0] = float("nan")
    bad[2, bs + 3, 7] = float("-inf")
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    want = ref.bsr_spmm_raw_ref(blocks, rows, cols, bad, nbr)
    scale = abs_product(blocks, rows, cols, bad.nan_to_num(0, 0, 0), nbr)
    got = bsr_spmm_cuda(blocks, bad, table)
    _assert_same_nan_mask(got, want, scale, step)
    carry = torch.ones_like(got)
    bsr_spmm_cuda(blocks, bad, table, out=carry)
    _assert_same_nan_mask(carry, want.float() + 1,
                          scale + 1, 2 * step)
    fine = bsr_spmm_cuda(blocks, dense, table)
    assert bool(torch.isfinite(fine).all())


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("wire,overlap", [("padded", "off"),
                                          ("packed", "on")])
def test_steal3d_on_the_card_matches_the_cpu(card, g, wire, overlap):
    """steal3d SpMM and dense-output SpGEMM on a skewed operand (items
    move at g 2 and 3) on the card against the CPU's plain path: one B1
    launch per multiply (two with overlap), multiplying the plan's real
    pairs, g x A's real blocks; the NaN mask of B with an inf equals the
    plain version's."""
    a_d = random_sparse(96, 96, 0.004, seed=g)
    a_d[:16, :16] += random_sparse(16, 16, 0.9, seed=g + 1)
    s_d = random_sparse(96, 96, 0.05, seed=10 + g)
    b = np.random.default_rng(g).standard_normal((96, 13)).astype(np.float32)
    b_bad = b.copy()
    b_bad[2, 5] = np.inf
    results = {}
    for dev in (card, torch.device("cpu")):
        a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=dev)
        s_h = DistBSR.from_dense(s_d, g=g, block_size=8, device=dev)
        results[dev.type] = [matmul(a_h, rhs, algorithm="steal3d", wire=wire,
                                    overlap=overlap)
                             for rhs in (b, s_h, b_bad)]
    a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=card)
    plan = plan_matmul(a_h, b, algorithm="steal3d", wire=wire,
                       overlap=overlap)
    before = bsr_spmm_cuda.launches
    _, multiplied = _counted(lambda: plan(a_h, b))
    assert bsr_spmm_cuda.launches == before + (2 if overlap == "on" else 1)
    assert multiplied == plan._steal.real_pairs == g * int(a_h.counts.sum())
    scales = [np.abs(a_d) @ np.abs(b), np.abs(a_d) @ np.abs(s_d)]
    for got, want, scale in zip(results["cuda"], results["cpu"], scales):
        assert got.is_cuda
        assert_close(got.cpu(), want, torch.from_numpy(scale))
    _assert_same_nan_mask(results["cuda"][2], results["cpu"][2],
                          torch.from_numpy(scales[0]))


# ---------------------------------------------------------------------------
# the serving path: B1 and B2 at block size 8 on the serving operators
# ---------------------------------------------------------------------------
def _serving_operands(seed: int = 0):
    """Scaled-down serving operands on the CPU: an olmoe MoE layer's
    dispatch and combine operators (64 experts, top 8, 32 tokens, d 256)
    with their bf16 activations, and the attention panels of 4 heads x
    32 positions x head_dim 16 (Q_bd, K_bd^T, a block-causal P_bd, V)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe
    from repro_torch.serving import sparse as ss
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), d_model=256)
    gen = torch.Generator().manual_seed(seed)
    n, d = 32, cfg.d_model
    x = torch.randn((n, d), generator=gen)
    router = torch.randn((d, cfg.moe.n_experts), generator=gen) * d ** -0.5
    r = tmoe.route_tokens(router, x, cfg)
    disp, comb = ss.routing_operators(r, n, cfg, torch.bfloat16)
    ye = torch.randn((disp.shape[0], d), generator=gen).bfloat16()
    bh, t, hd = 4, 32, 16
    q = torch.randn((bh, t, hd), generator=gen)
    k = torch.randn((bh, t, hd), generator=gen)
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool))
    p = torch.softmax(torch.randn((bh, t, t), generator=gen).masked_fill(
        ~causal, float("-inf")), dim=-1)
    v = torch.randn((bh * t, hd), generator=gen)
    return {"moe": (disp, x.bfloat16(), comb, ye, n, disp.shape[0], cfg),
            "attn": (torch.block_diag(*q), torch.block_diag(
                *k.transpose(1, 2)), torch.block_diag(*p), v)}


@pytest.mark.cuda
def test_serving_operators_on_the_card_match_the_cpu(card):
    """D @ X and W @ Y (bf16, B1's SIMT path at bs 8), Q_bd @ K_bd^T with a
    sparse output (float32, B2) and P_bd @ V (float32, B1) through the
    engine's SparseOps on the card, against the same through the plain
    versions on the CPU; B1 and B2 multiply their tables' real blocks and
    pairs, counted on the card."""
    from repro_torch.serving import sparse as ss
    ops = _serving_operands()
    disp, x, comb, ye, n, lines, cfg = ops["moe"]
    q_bd, kt_bd, p_bd, v = ops["attn"]
    cap = ss.routing_capacity(n, lines, cfg.moe.top_k, 1, 8)
    got, want = {}, {}
    for dev, out in ((card, got), (torch.device("cpu"), want)):
        so = ss.SparseOps(device=dev)
        out["d"] = so.spmm(disp.to(dev), x.to(dev), capacity=cap)
        out["w"] = so.spmm(comb.to(dev), ye.to(dev), capacity=cap)
        out["s"] = so.spgemm_sparse(q_bd.to(dev), kt_bd.to(dev)).densify()
        out["o"] = so.spmm(p_bd.to(dev), v.to(dev))
    assert ss.SparseOps(device=card).tile(disp.to(card)).dtype \
        == torch.bfloat16
    assert kernel_path_b1(8, torch.bfloat16) == "SIMT float32 FMA"
    scales = {"d": disp.float().abs() @ x.float().abs(),
              "w": comb.float().abs() @ ye.float().abs(),
              "s": q_bd.abs() @ kt_bd.abs(), "o": p_bd.abs() @ v.abs()}
    for key in "dwso":
        assert got[key].is_cuda and got[key].dtype == want[key].dtype
        step = BF16_STEP if want[key].dtype == torch.bfloat16 else 0.0
        assert_close(got[key].cpu(), want[key], scales[key], step=step)
    # launches and the blocks / pairs each multiplied, against the tables
    so = ss.SparseOps(device=card)
    b1, b2 = bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches
    counter = torch.zeros(1, dtype=torch.int64, device=card)
    pairs = torch.zeros(1, dtype=torch.int64, device=card)
    bsr_spmm_cuda.block_counter, bsr_spmm_cuda.table_blocks = counter, 0
    bsr_pair_accumulate_cuda.pair_counter = pairs
    bsr_pair_accumulate_cuda.table_pairs = 0
    bsr_spmm_cuda.by_shape = {}
    try:
        so.spmm(disp.to(card), x.to(card), capacity=cap)
        so.spgemm_sparse(q_bd.to(card), kt_bd.to(card))
        so.spmm(p_bd.to(card), v.to(card))
        by_shape = bsr_spmm_cuda.by_shape
    finally:
        bsr_spmm_cuda.block_counter = None
        bsr_pair_accumulate_cuda.pair_counter = None
        bsr_spmm_cuda.by_shape = None
    assert bsr_spmm_cuda.launches == b1 + 2
    # one launch a product, tallied by (m, k, n): D @ X, then P_bd @ V
    assert by_shape == {(lines, n, x.shape[1]): 1,
                        (p_bd.shape[0], v.shape[0], v.shape[1]): 1}
    assert bsr_pair_accumulate_cuda.launches == b2 + 1
    assert int(counter.item()) == bsr_spmm_cuda.table_blocks > 0
    # the scores' real pairs: 4 heads x 4 x 4 output blocks x 2 inner blocks
    assert int(pairs.item()) == bsr_pair_accumulate_cuda.table_pairs \
        == 4 * 4 * 4 * 2


@pytest.mark.cuda
def test_sparse_engine_on_the_card_gives_the_cpu_tokens(card):
    """The smoke olmoe sparse engine (MoE dispatch and combine, prefill
    attention through B1 and B2) on the card decodes the CPU port's
    tokens, with slots recycled mid-run."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeEngine
    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (m,)) for m in (12, 9, 16)]
    results = {}
    b1, b2 = bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches
    for dev in (card, torch.device("cpu")):
        eng = ServeEngine(cfg, params=copy.deepcopy(model).to(dev),
                          max_batch=2, max_len=32, sparse=True, device=dev)
        for toks in prompts:
            eng.submit(toks, max_new_tokens=4)
        results[dev.type] = eng.run()
        assert eng.summary()["dropped_max"] == 0.0
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(results["cuda"][rid],
                                      results["cpu"][rid])
    assert bsr_spmm_cuda.launches > b1
    assert bsr_pair_accumulate_cuda.launches == b2 + 3 * cfg.n_layers


# ---------------------------------------------------------------------------
# the training path: no kernel of its own, and none of B1-B3
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_recurrent_engine_on_the_card_gives_the_cpu_tokens(card):
    """The smoke recurrentgemma-2b sparse engine (RG-LRU layers, the local
    attention layer's scores and P @ V through B2 and B1) on the card
    decodes the CPU port's tokens at exact prompt lengths past its window
    of 16; B2 and B1 launch once a prefill each, none in a decode step."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeEngine
    cfg = get_config("recurrentgemma-2b", smoke=True)
    model = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (m,)) for m in (27, 20, 27)]
    results = {}
    b1, b2 = bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches
    for dev in (card, torch.device("cpu")):
        eng = ServeEngine(cfg, params=copy.deepcopy(model).to(dev),
                          max_batch=2, max_len=48, sparse=True, device=dev)
        for toks in prompts:
            eng.submit(toks, max_new_tokens=4)
        results[dev.type] = eng.run()
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(results["cuda"][rid],
                                      results["cpu"][rid])
    n_local = cfg.pattern.count("l")
    assert bsr_spmm_cuda.launches == b1 + n_local * len(prompts)
    assert bsr_pair_accumulate_cuda.launches == b2 + n_local * len(prompts)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_recurrent_layers_on_the_card_match_the_cpu(card, arch):
    """The full forward (the RG-LRU's log-depth scan, the SSD's chunked
    form with a padded last chunk), prefill and decode steps on the card
    against the CPU, float32 with TF32 off, on the same parameters."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm, transformer as tf
    cfg = get_config(arch, smoke=True)
    model = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32))
    out = {}
    for dev in (card, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        t = toks.to(dev)
        full, _, _ = tf.forward(m, {"tokens": t}, cfg)
        last, caches, pos = lm.prefill(m, {"tokens": t[:, :30]}, cfg, 48,
                                       torch.float32)
        step = lm.make_decode_step(cfg)
        steps = [last]
        for i in range(30, 37):
            logits, caches = step(m, t[:, i:i + 1], caches, pos)
            steps.append(logits)
            pos = pos + 1
        out[dev.type] = (full.cpu(), torch.stack(steps).cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b", "mamba2-130m",
                                  "recurrentgemma-2b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_train_steps_on_the_card_match_the_cpu(card, arch):
    """Three ``make_train_step`` steps on the card from the CPU's model and
    state, float32 with TF32 off (olmoe at the published capacity factor,
    so tokens drop): losses, gradient norms and dropped shares within
    1e-5, the moments within 1e-5, the parameters within 1e-5 plus what
    Adam may make of the two runs' gradient differences
    (``AdamW.rounding_allowance``); no kernel of B1-B3 launches."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm, transformer as tf
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    opt = AdamW(lr=cosine_schedule(3e-3, 1, 3))
    cpu_model = tf.init_params(cfg, seed=0, device="cpu")
    runs = {}
    launches = (bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches,
                bsr_pair_matmul_cuda.launches)
    for dev in (card, torch.device("cpu")):
        model = copy.deepcopy(cpu_model).to(dev)
        state = opt.init(model)
        step = lm.make_train_step(cfg, opt)
        metrics, mus, nus = [], [], []
        for t in range(3):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     SyntheticLM(cfg, 2, 16, seed=3)(t).items()}
            model, state, m = step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            mus.append({n: v.cpu().numpy().copy()
                        for n, v in state["mu"].items()})
            nus.append({n: v.cpu().numpy().copy()
                        for n, v in state["nu"].items()})
        runs[dev.type] = (model, state, metrics, mus, nus)
    assert (bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches,
            bsr_pair_matmul_cuda.launches) == launches
    (gm, gs, gmet, gmus, _), (wm, ws, wmet, wmus, wnus) = runs["cuda"], \
        runs["cpu"]
    for got, want in zip(gmet, wmet):
        for k in ("loss", "grad_norm", "dropped", "aux"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    if cfg.moe is not None:
        assert max(m["dropped"] for m in wmet) > 0
    for name, p in wm.named_parameters():
        for key in ("mu", "nu"):
            np.testing.assert_allclose(gs[key][name].cpu().numpy(),
                                       ws[key][name].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=f"{key}/{name}")
        want = p.detach().numpy()
        err = np.abs(dict(gm.named_parameters())[name].detach().cpu()
                     .numpy() - want)
        allowed = TOL + TOL * np.abs(want) + opt.rounding_allowance(
            [x[name] for x in wnus], [x[name] for x in gmus],
            [x[name] for x in wmus], TOL)
        assert (err <= allowed).all(), (name, err.max())


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_need_a_gradient(card):
    """B1-B3 have no backward: on the card too, a wrapper given an input
    that requires grad raises while grad mode is on, before it launches;
    under ``no_grad`` it launches."""
    _, (blocks, rows, cols, dense), nbr = _b1_case(8, 24, torch.float32,
                                                   "bucket", card)
    n_tiles, s = blocks.shape[:2]
    b1_table = spmm_table(
        np.arange(n_tiles)[:, None] * s + np.arange(s), rows.cpu().numpy(),
        cols.cpu().numpy(), nbr, device=card)
    a, b, (pa, pb, ps), n_slots, real = _pair_case(8, torch.float32, card)
    table = pair_table(ps, n_slots, real=real, device=card)
    before = (bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches,
              bsr_pair_matmul_cuda.launches)
    blocks_g = blocks.detach().clone().requires_grad_(True)
    a_g = a.detach().clone().requires_grad_(True)
    calls = [
        lambda x: bsr_spmm_cuda(x, dense, b1_table),
        lambda x: ops.bsr_spmm_raw(x, rows, cols, dense, n_block_rows=nbr),
        lambda x: bsr_pair_accumulate_cuda(a_g if x is None else x, b, pa,
                                           pb, table),
        lambda x: ops.bsr_pair_accumulate(a_g if x is None else x, b, pa, pb,
                                          ps, n_slots=n_slots),
    ]
    for i, call in enumerate(calls):
        with pytest.raises(RuntimeError, match="no backward"):
            call(blocks_g if i < 2 else None)
    with pytest.raises(RuntimeError, match="no backward"):
        bsr_pair_matmul_cuda(a_g, b, pa, pb, table, n_block_rows=1,
                             n_block_cols=n_slots)
    assert (bsr_spmm_cuda.launches, bsr_pair_accumulate_cuda.launches,
            bsr_pair_matmul_cuda.launches) == before
    with torch.no_grad():
        got = bsr_spmm_cuda(blocks_g, dense, b1_table)
        acc = bsr_pair_accumulate_cuda(a_g, b, pa, pb, table)
    assert bsr_spmm_cuda.launches == before[0] + 1
    assert bsr_pair_accumulate_cuda.launches == before[1] + 1
    assert not got.requires_grad and not acc.requires_grad


# ---------------------------------------------------------------------------
# the static verifier and the elastic runtime on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 3])
def test_validate_full_on_the_card(card, g):
    """Every schedule (and a sparse output) proves clean on the card with
    the kernels launched: the op-trace lint's hot-loop rule binds there."""
    from repro_torch import analysis
    from repro_torch.analysis import op_lint
    from repro_torch.core import api
    from repro_torch.core.bsr import rmat_matrix
    a_d = rmat_matrix(7, 8, seed=0)
    b = np.random.default_rng(0).standard_normal((128, 16)).astype(
        np.float32)
    a_h = DistBSR.from_dense(a_d, g=g, block_size=8, device=card)
    b_h = DistDense.for_rhs(b, a_h)
    for alg in api.algorithms():
        for wire in ("padded", "packed"):
            plan = plan_matmul(a_h, b_h, algorithm=alg, wire=wire,
                               cache=False, validate="full")
            assert {"fast", "full"} <= plan._validated
            rec = op_lint.record_multiply(plan, a_h, b_h)
            assert op_lint.check_hot_loop(rec, plan=plan) == []
            assert any(e.kind == "call" for e in rec.events)
    s_h = DistBSR.from_dense(random_sparse(128, 128, 0.05, seed=1), g=g,
                             block_size=8, device=card)
    before = bsr_pair_accumulate_cuda.launches
    plan = plan_matmul(a_h, s_h, output="sparse", cache=False,
                       validate="full")
    assert bsr_pair_accumulate_cuda.launches - before == g
    assert not analysis.check_plan(plan, a_h, s_h)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["padded", "packed"])
def test_recovery_on_the_card_matches_the_cpu(card, wire):
    """recover_from_loss from g 3 to g 2: the card's assignment equals the
    CPU's, its multiply matches the CPU's, B1 multiplies the recovered
    plan's real pairs, and no floating-point data goes to the host."""
    from repro_torch.analysis.op_lint import host_transfers
    from repro_torch.core.bsr import rmat_matrix
    from repro_torch.runtime.faultinject import DeviceLoss
    from repro_torch.runtime.replan import ElasticReplanner
    a_d = rmat_matrix(7, 8, seed=0)
    b = np.random.default_rng(2).standard_normal((128, 40)).astype(
        np.float32)
    survivors = DeviceLoss(9, 5, seed=0).survivors()
    recs = {}
    for dev in ("cpu", card):
        a3 = DistBSR.from_dense(a_d, g=3, block_size=8, device=dev)
        b3 = DistDense.for_rhs(b, a3)
        plan_matmul(a3, b3, algorithm="steal3d", validate="fast")
        recs[str(dev)], moved = host_transfers(
            lambda: ElasticReplanner().recover_from_loss(a3, b3, survivors,
                                                         wire=wire))
        if dev != "cpu":
            assert moved == []
    cpu, gpu = recs["cpu"], recs[str(card)]
    assert cpu.g == gpu.g == 2
    np.testing.assert_array_equal(cpu.assignment.dev, gpu.assignment.dev)
    want = cpu.plan(cpu.a, cpu.b)
    got, multiplied = _counted(lambda: gpu.plan(gpu.a, gpu.b))
    assert multiplied == gpu.plan._steal.real_pairs \
        == 2 * int(gpu.a.counts.sum())
    scale = torch.from_numpy(np.abs(a_d) @ np.abs(b))
    assert_close(got, want, scale)


@pytest.mark.cuda
def test_ranks_on_the_card_match_the_stacked_executor(card):
    """4 ranks (g = 2) share the card over gloo, each staging its tiles
    through pinned host memory: every schedule's SpMM (padded and packed
    wire) and every sparse output on the grid equal the stacked
    executor's on the card within 1e-5 (the kernels and tables are the
    same)."""
    import torch_grid_ranks
    from repro_torch.launch.grid import run_grid
    for rank in run_grid(2, torch_grid_ranks.card_cases, backend="gloo",
                         timeout_s=300):
        assert rank["transport"] == "gloo (host-staged)"
        assert rank["device"].startswith("cuda")
        assert rank["staged_bytes"] > 0
        for case, err in rank["err"].items():
            assert err <= TOL, (case, err)
