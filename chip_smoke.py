"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
non-zero and prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc/Triton
   versions;
2. build: every CUDA kernel of the path, compiled from ``src/`` with nvcc;
3. kernel: each kernel against its plain PyTorch version on the card, at
   the main path's per-step shapes and at small block sizes with a ragged
   width;
4. end to end: ``repro_torch.core.api.matmul`` — ``ring_c`` SpMM on R-MAT
   scale 15 (bs 128, B 512 wide) at g 2 in float32 and bf16 (overlap
   ``auto``, which resolves to the bulk body of ``off``: checked on the
   plans) and at g 3 in float32 with overlap ``on`` and ``off``, where the
   two bodies issue their launches in another order, and dense-output
   SpGEMM ``A @ A`` on R-MAT scale 14 (bs 64), each against a dense
   ``torch.matmul`` oracle in float32 (TF32 off), with the kernels' launch
   counts read around that run; then the time of one ring shift, and a
   ``torch.profiler`` breakdown of one float32 multiply of each kind
   (device time by kernel, idle share);
5. yardstick: one PyTorch call computing the kernel's function
   (``torch.sparse_bsr_tensor(...) @ dense``, cuSPARSE), timed only.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from importlib import metadata, util
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 FMA on the
# CUDA cores, bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Tolerances.  Each output element is held against the scale that bounds
# its rounding, |A| @ |B| (the sum of its terms' magnitudes, computed on
# |A| and |B| by the plain version or by torch.matmul):
#
#     |got - want| <= tol * (|A| @ |B|) + step * |want|      elementwise
#
# * tol, float32 sums taken in another order: the reference's 1e-5 at test
#   sizes (tests/test_kernels.py); 1e-4 at the main path's depth, where an
#   output sums up to 32,768 products (at most d*u = 2e-3 of |A| @ |B|,
#   about sqrt(d)*u = 1e-5 for rounding errors of random sign)
# * step = 2^-7, one bf16 step of the value: two bf16 results that each
#   round a float32 sum once (kernel vs plain version) may land on
#   neighbouring bf16 values; 0 for a float32 output
# * bf16 end to end against a float32 oracle: the ring rounds each of its
#   g partials and g - 1 running sums to bf16, each by at most 2^-8 of a
#   magnitude below |A| @ |B|, so tol gains g * 2^-8
TOL_F32_SMALL = 1e-5
TOL_F32_DEEP = 1e-4
BF16_STEP = 2.0 ** -7
BF16_ROUND = 2.0 ** -8

DEVICE = "cuda"
PROFILED = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
SPMM = dict(scale=15, seed=1, block_size=128, g=2, width=512)
SPMM_G3 = 3          # the overlap bodies differ from g = 3 on
SPGEMM = dict(scale=14, seed=2, block_size=64, g=2)


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor,
            tol: float, step: float = 0.0):
    """Elementwise |got - want| <= tol * scale + step * |want|.

    Returns (max |got - want|, the largest share of its allowance that an
    element's error takes, whether every element is within it)."""
    if not want.numel():
        return 0.0, 0.0, True
    want = want.float()
    err = (got.float() - want).abs()
    allowed = tol * scale.float() + step * want.abs()
    share = (err / allowed.clamp_min(torch.finfo(torch.float32).tiny)).max()
    return err.max().item(), share.item(), bool((err <= allowed).all())


def abs_product(blocks, rows, cols, dense, nbr: int) -> torch.Tensor:
    """|A| @ |B| in float32, by the plain version."""
    from repro_torch.kernels import ref
    return ref.bsr_spmm_raw_ref(blocks.abs(), rows, cols, dense.abs(), nbr,
                                out_dtype=torch.float32)


def environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    from repro_torch.kernels import loader
    nvcc = subprocess.run([loader.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    triton = metadata.version("triton") if util.find_spec("triton") \
        else "not installed"
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}  triton {triton}")
    log(f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card


def build_kernels() -> float:
    from repro_torch.kernels import loader
    t0 = time.perf_counter()
    logs = loader.build()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"build: {secs:.1f} s ({', '.join(logs) or 'already built'})")
    return secs


def bound_ms(blocks, dense, out) -> dict:
    """Least time for one kernel call: each input read once, the output
    written once, and the flops of the blocks that hold data."""
    t, s, bs, _ = blocks.shape
    n = dense.shape[-1]
    nbytes = sum(x.numel() * x.element_size() for x in (blocks, dense, out)) \
        + 2 * t * s * 4                              # rows + cols, int32
    real = int((blocks.reshape(t * s, -1) != 0).any(dim=1).sum().item())
    flops = 2 * real * bs * bs * n
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_OPS[blocks.dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "real_blocks": real, "real_flops": flops,
            "stored_flops": 2 * t * s * bs * bs * n}


def kernel_case(blocks, rows, cols, dense, nbr: int, tol: float, label: str,
                reps: int = 0) -> dict:
    """Kernel vs its plain version on the same inputs (``tol`` for the
    float32 sums, one bf16 step more for a bf16 output); timed when reps."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    got = bsr_spmm_cuda(blocks, rows, cols, dense, n_block_rows=nbr)
    want = ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    step = BF16_STEP if got.dtype == torch.bfloat16 else 0.0
    err, share, ok = compare(got, want, abs_product(blocks, rows, cols, dense,
                                                    nbr), tol, step)
    log(f"  kernel {label}: max_abs_err {err:.3e}, {share:.3g} of its "
        f"allowance (tol {tol:g} x |A||B| + {step:g} x |want|) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"kernel {label} disagrees with its plain version")
    res = {"max_abs_err": err, "share_of_tolerance": share}
    if reps:
        res["ms"] = time_ms(lambda: bsr_spmm_cuda(
            blocks, rows, cols, dense, n_block_rows=nbr), reps)
        res["plain_ms"] = time_ms(lambda: ref.bsr_spmm_raw_ref(
            blocks, rows, cols, dense, nbr), max(1, reps // 4))
        res.update(bound_ms(blocks, dense, got))
        log(f"  kernel {label}: {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.3f} ms ({res['bound_by']})")
    return res


def small_kernel_cases(device) -> None:
    """Block sizes 4..192 (192 takes two row parts) with ragged widths, in
    float32 and bf16 for each of the kernel's three tile shapes (bs <= 32,
    <= 64, > 64), and capacity padding several chunks long in one
    block-row."""
    from repro_torch.core.bsr import TiledBSR, random_sparse
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.kernels.bsr_spmm import CHUNK
    rng = np.random.default_rng(0)
    cases = [(4, 37, torch.float32, "bucket"), (8, 70, torch.float32, "bucket"),
             (16, 129, torch.float32, "bucket"),
             (64, 37, torch.float32, "bucket"),
             (192, 70, torch.float32, "bucket"),
             (8, 37, torch.bfloat16, "bucket"),
             (64, 129, torch.bfloat16, "bucket"),
             (128, 45, torch.bfloat16, "bucket"),
             (192, 129, torch.bfloat16, "bucket"),
             (8, 45, torch.float32, 5 * CHUNK),
             (16, 64, torch.bfloat16, 3 * CHUNK)]
    for bs, n, dtype, capacity in cases:
        m, k = 8 * bs + bs // 2, 3 * 5 * bs
        a = random_sparse(m, k, 0.3, seed=bs)
        a[:, k // 3:2 * k // 3] = 0          # one empty tile
        t = TiledBSR.from_dense(a, ProcessGrid(1, 3), bs, capacity=capacity,
                                dtype=dtype, device=device)
        s = t.store_capacity
        dense = torch.from_numpy(
            rng.standard_normal((3, k // 3, n)).astype(np.float32)).to(
            device, dtype)
        kernel_case(t.blocks.reshape(3, s, bs, bs), t.rows.reshape(3, s),
                    t.cols.reshape(3, s), dense, t.tile_shape[0] // bs,
                    TOL_F32_SMALL,
                    f"bs={bs} n={n} {str(dtype)[6:]} capacity {t.capacity}")
    # mixed types: the wrapper widens the bf16 operand
    blocks = torch.randn(2, 5, 16, 16, device=device).bfloat16()
    rows = torch.tensor([[0, 0, 1, 2, 3]] * 2, dtype=torch.int32,
                        device=device)
    cols = torch.tensor([[1, 0, 2, 2, 0]] * 2, dtype=torch.int32,
                        device=device)
    dense = torch.randn(2, 48, 21, device=device)
    kernel_case(blocks, rows, cols, dense, 4, TOL_F32_SMALL,
                "bs=16 n=21 bf16 x float32")


def main_path_operands(device):
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import rmat_matrix
    t0 = time.perf_counter()
    a_np = rmat_matrix(SPMM["scale"], 8, seed=SPMM["seed"])
    a32 = DistBSR.from_dense(a_np, g=SPMM["g"],
                             block_size=SPMM["block_size"], device=device)
    t = a32.tiled
    # R-MAT values are 1.0, exact in bf16: the bf16 handle shares the
    # structure and casts the blocks
    a16 = DistBSR(dataclasses.replace(t, blocks=t.blocks.to(torch.bfloat16)))
    b_np = np.random.default_rng(SPMM["seed"]).standard_normal(
        (a_np.shape[1], SPMM["width"])).astype(np.float32)
    b32 = DistDense.for_rhs(b_np, a32)
    b16 = DistDense.for_rhs(torch.from_numpy(b_np).bfloat16(), a16)
    torch.cuda.synchronize()
    counts = t.counts.cpu().numpy()
    log(f"SpMM operands: R-MAT scale {SPMM['scale']} {a_np.shape}, "
        f"bs {SPMM['block_size']}, g {SPMM['g']}: real blocks per tile "
        f"{counts.ravel().tolist()}, capacity {t.capacity}, store capacity "
        f"{t.store_capacity}, stored A {t.blocks.numel() * 4 / 1e9:.2f} GB "
        f"(float32), built in {time.perf_counter() - t0:.1f} s")
    return a_np, a32, a16, b_np, b32, b16


def main_path_kernel_cases(a32, a16, b32, b16) -> dict:
    """The kernel at the per-step shapes of the main path (step 0's tiles)."""
    from repro_torch.core.api import SKEW_COLS, SKEW_ROWS
    g, bs = a32.g, a32.block_size
    nbr = a32.tile_shape[0] // bs
    res = {}
    for dtype, a_h, b_h in ((torch.float32, a32, b32),
                            (torch.bfloat16, a16, b16)):
        pa, pb = a_h.placed(SKEW_ROWS), b_h.placed(SKEW_COLS)
        blocks = pa["blocks"].reshape(g * g, -1, bs, bs)
        rows = pa["rows"].reshape(g * g, -1)
        cols = pa["cols"].reshape(g * g, -1)
        dense = pb["dense"].reshape(g * g, *pb["dense"].shape[2:])
        seg = torch.stack([torch.bincount(r.long(), minlength=nbr)
                           for r in rows])
        log(f"  main-path step: T={g * g} tiles, S={blocks.shape[1]} stored "
            f"blocks, bs={bs}, n={dense.shape[-1]}; blocks per block-row "
            f"segment: mean {seg.float().mean().item():.1f}, max "
            f"{seg.max().item()}")
        res[dtype] = kernel_case(blocks, rows, cols, dense, nbr,
                                 TOL_F32_DEEP, f"main-path {str(dtype)[6:]}",
                                 reps=10)
        res[dtype]["inputs"] = (blocks, rows, cols, dense, nbr)
    return res


def e2e_case(label, a_h, b_h, oracle, scale, tol, overlap, reps=3) -> float:
    """Time ``matmul`` (median after one warm-up) and hold its result
    against the oracle within ``tol * scale`` elementwise."""
    from repro_torch.core.api import matmul
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    from repro_torch.runtime.device import sync_elapsed
    before = bsr_spmm_cuda.launches
    out = matmul(a_h, b_h, overlap=overlap)             # warm-up
    per_multiply = bsr_spmm_cuda.launches - before
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = matmul(a_h, b_h, overlap=overlap)
        times.append(sync_elapsed(t0) * 1e3)
    check(tuple(out.shape) == tuple(oracle.shape),
          f"{label}: shape {tuple(out.shape)} vs {tuple(oracle.shape)}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err, share, ok = compare(out, oracle, scale, tol)
    med = statistics.median(times)
    log(f"  e2e {label} overlap={overlap}: median {med:.2f} ms of "
        f"{[round(x, 2) for x in times]}, {per_multiply} bsr_spmm launches "
        f"a multiply, max_abs_err {err:.3e}, {share:.3g} of its allowance "
        f"(tol {tol:g} x |A||B|) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{label} overlap={overlap} disagrees with the dense oracle")
    return med


def workspace_gb(a_h, n: int) -> float:
    """GB of the kernel's float32 partial workspace for one ring step of
    ``a_h`` times an ``n``-wide tile (sized from the shapes alone)."""
    from repro_torch.kernels.bsr_spmm import CHUNK
    nbr = a_h.tile_shape[0] // a_h.block_size
    max_chunks = nbr + -(-a_h.tiled.store_capacity // CHUNK)
    return a_h.g ** 2 * max_chunks * a_h.block_size * n * 4 / 1e9


def ring_shift_ms(a_h, b_h) -> dict:
    """One ring shift of each operand's placed tile grid (float32 SpMM):
    the copies that a ring step makes besides its kernel launch."""
    from repro_torch.core.api import SKEW_COLS, SKEW_ROWS
    from repro_torch.core.executor import StackedExecutor
    ex = StackedExecutor(a_h.g, a_h.device)
    pa, pb = a_h.placed(SKEW_ROWS), b_h.placed(SKEW_COLS)
    res = {"a": time_ms(lambda: ex.shift(pa, "col"), 5),
           "b": time_ms(lambda: ex.shift(pb, "row"), 5)}
    log(f"  ring shift of the placed tiles: A {res['a']:.3f} ms, B "
        f"{res['b']:.3f} ms (float32 SpMM, one of each per ring step)")
    return res


def device_breakdown(a_h, b_h, label: str) -> dict:
    """Device time by kernel over one multiply (``torch.profiler``), beside
    the multiply's wall time: where the time goes, and the share of the
    wall time in which no kernel or copy ran on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.api import matmul
    from repro_torch.runtime.device import sync_elapsed
    matmul(a_h, b_h)
    torch.cuda.synchronize()
    with profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        matmul(a_h, b_h)
        wall_ms = sync_elapsed(t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        # "void at::native::(anonymous namespace)::roll_kernel<...>(...)"
        # -> "at::native::roll_kernel"
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("<")[0].split("(")[0].strip()
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    busy_ms, last = 0.0, None
    for start, end in sorted(spans):        # union of the device intervals
        if last is None or start > last:
            busy_ms += (end - start) / 1e3
            last = end
        elif end > last:
            busy_ms += (end - last) / 1e3
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms if spans else None,
           "by_kernel_ms": {k: round(v[0], 3) for k, v in top},
           "launches_by_kernel": {k: v[1] for k, v in top}}
    if spans:
        log(f"  {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
            f"(idle share {res['idle_share']:.3f})")
        for k, (ms, n) in top:
            log(f"    {ms:9.3f} ms  {n:4d}x  {k}")
    else:
        log(f"  {label}: wall {wall_ms:.2f} ms; the profiler recorded no "
            "device time (idle share not measured)")
    return res


def library_yardstick(blocks, rows, cols, dense, nbr, tol: float) -> float:
    """cuSPARSE BSR @ dense on the same inputs, as one block-diagonal BSR
    matrix over the T tiles (timed only; the port never calls it)."""
    from repro_torch.kernels import ref
    dtype = blocks.dtype
    t, s, bs, _ = blocks.shape
    k, n = dense.shape[1], dense.shape[2]
    row_ptr = torch.searchsorted(
        rows, torch.arange(nbr + 1, dtype=torch.int32, device=rows.device)
        .expand(t, -1).contiguous(), out_int32=True)
    offs = torch.arange(t, device=rows.device, dtype=torch.int32)[:, None]
    crow = torch.cat([(row_ptr[:, :-1] + offs * s).reshape(-1),
                      torch.tensor([t * s], dtype=torch.int32,
                                   device=rows.device)])
    col = (cols + offs * (k // bs)).reshape(-1)
    a = torch.sparse_bsr_tensor(crow, col, blocks.reshape(t * s, bs, bs),
                                size=(t * nbr * bs, t * k))
    d = dense.reshape(t * k, n)
    got = (a @ d).reshape(t, nbr * bs, n)
    err, _, ok = compare(
        got, ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr),
        abs_product(blocks, rows, cols, dense, nbr), tol,
        BF16_STEP if dtype == torch.bfloat16 else 0.0)
    check(ok, "the yardstick computes another function")
    ms = time_ms(lambda: a @ d, 10)
    log(f"  yardstick torch.sparse_bsr_tensor @ dense, {str(dtype)[6:]}: "
        f"{ms:.3f} ms, max_abs_err {err:.3e} vs the plain version")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.api import DistBSR, DistDense, plan_matmul
    from repro_torch.core.bsr import rmat_matrix
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    from repro_torch.runtime.device import strict_fp32

    strict_fp32()
    device = torch.device(DEVICE)
    t_start = time.perf_counter()
    log("== environment")
    card = environment()
    log("== build")
    build_s = build_kernels()

    log("== kernel vs plain version")
    small_kernel_cases(device)
    a_np, a32, a16, b_np, b32, b16 = main_path_operands(device)
    kres = main_path_kernel_cases(a32, a16, b32, b16)

    log("== end to end (repro_torch.core.api.matmul, ring_c)")
    a3 = DistBSR.from_dense(a_np, g=SPMM_G3, block_size=SPMM["block_size"],
                            device=device)
    b3 = DistDense.for_rhs(b_np, a3)
    log(f"SpMM operands at g {SPMM_G3}: real blocks per tile "
        f"{a3.counts.cpu().numpy().ravel().tolist()}, capacity "
        f"{a3.capacity}, store capacity {a3.tiled.store_capacity}")
    a_dense = torch.from_numpy(a_np).to(device)
    del a_np
    a_abs = a_dense.abs()
    b_t = torch.from_numpy(b_np).to(device)
    b_t16 = b_t.bfloat16().float()
    oracle32, scale32 = a_dense @ b_t, a_abs @ b_t.abs()
    oracle16, scale16 = a_dense @ b_t16, a_abs @ b_t16.abs()
    del a_dense, a_abs
    a14_np = rmat_matrix(SPGEMM["scale"], 8, seed=SPGEMM["seed"])
    a14 = DistBSR.from_dense(a14_np, g=SPGEMM["g"],
                             block_size=SPGEMM["block_size"], device=device)
    a14_dense = torch.from_numpy(a14_np).to(device)
    del a14_np
    oracle_gemm = a14_dense @ a14_dense
    scale_gemm = a14_dense.abs() @ a14_dense.abs()
    del a14_dense
    log(f"SpGEMM operand: R-MAT scale {SPGEMM['scale']}, bs "
        f"{SPGEMM['block_size']}, g {SPGEMM['g']}: real blocks per tile "
        f"{a14.counts.cpu().numpy().ravel().tolist()}, capacity "
        f"{a14.capacity}, store capacity {a14.tiled.store_capacity}")
    # on the single-stream executor overlap="auto" is the bulk body of "off"
    check(plan_matmul(a32, b32, overlap="auto").geom
          == plan_matmul(a32, b32, overlap="off").geom,
          "overlap='auto' does not resolve to the bulk body")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    bsr_spmm_cuda.launches = 0          # counts of the main path's run only
    e2e = {}
    for label, a_h, b_h, oracle, scale, tol, overlap in (
            ("SpMM float32 g=2", a32, b32, oracle32, scale32, TOL_F32_DEEP,
             "auto"),
            ("SpMM bfloat16 g=2", a16, b16, oracle16, scale16,
             TOL_F32_DEEP + a16.g * BF16_ROUND, "auto"),
            (f"SpMM float32 g={SPMM_G3}", a3, b3, oracle32, scale32,
             TOL_F32_DEEP, "on"),
            (f"SpMM float32 g={SPMM_G3}", a3, b3, oracle32, scale32,
             TOL_F32_DEEP, "off"),
            ("SpGEMM float32 g=2", a14, a14, oracle_gemm, scale_gemm,
             TOL_F32_SMALL, "auto")):
        e2e[f"{label} overlap={overlap}"] = e2e_case(
            label, a_h, b_h, oracle, scale, tol, overlap)
    launches = bsr_spmm_cuda.launches
    log(f"  bsr_spmm launches on the main path: {launches}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; kernel "
        f"workspace a launch: SpMM {workspace_gb(a32, b32.tile_shape[1]):.2f} GB, SpGEMM "
        f"{workspace_gb(a14, a14.tile_shape[1]):.2f} GB")
    check(launches > 0, "the main path never launched bsr_spmm")
    shift_ms = ring_shift_ms(a32, b32)
    breakdown = {"SpMM float32": device_breakdown(a32, b32, "SpMM float32"),
                 "SpGEMM float32": device_breakdown(a14, a14,
                                                    "SpGEMM float32")}

    log("== yardstick")
    for dtype in (torch.float32, torch.bfloat16):
        kres[dtype]["library_ms"] = library_yardstick(*kres[dtype]["inputs"],
                                                      TOL_F32_DEEP)

    f32, b16 = kres[torch.float32], kres[torch.bfloat16]
    blocks, _, _, dense, _ = f32["inputs"]
    record = {
        "name": "bsr_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_spmm.cu",
        "replaces": "src/repro/kernels/bsr_spmm.py:55",
        "launches": launches, "dtype": "float32",
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "max_err": f32["max_abs_err"], "kernel_ms": f32["ms"],
        "shape": dict(zip(("T", "S", "bs", "n"), (*blocks.shape[:3],
                                                   dense.shape[-1]))),
        "real_flops": f32["real_flops"], "stored_flops": f32["stored_flops"],
        "bytes": f32["bytes"],
        "bf16": {k: b16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "bytes",
                                     "library_ms")},
    }
    log(json.dumps({"build_s": build_s, "e2e_median_ms": e2e,
                    "ring_shift_ms": shift_ms, "breakdown": breakdown,
                    "card": card,
                    "total_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
