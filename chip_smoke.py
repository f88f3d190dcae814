"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
non-zero and prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc/Triton
   versions;
2. build: every CUDA kernel of the port (``bsr_spmm`` B1, ``bsr_pair`` B2
   and B3), compiled from ``src/`` with nvcc, one process per source;
3. kernels: each kernel against its plain PyTorch version on the card, at
   small block sizes with ragged shapes (f32 and bf16, segments several
   chunks long; B1 also through the storage layout's real mask; B1, B2 and
   B3 count on the card the blocks or pairs they multiply, held against
   their tables);
4. dense-output path: B1 at both of its main-path shapes (SpMM and
   SpGEMM, f32 and bf16, step 0 with the plan's own table of real blocks)
   against its plain version, its bound and two library yardsticks
   (``torch.sparse_bsr_tensor`` and ``torch.sparse_csr_tensor`` on the same
   real blocks), and on B with an inf, a NaN and a -inf planted: its NaN
   mask equal to the plain version's (zero blocks included, ``0 * inf``),
   and its NaN pass's time on finite B, under 1 % of each cell's multiply;
   then ``repro_torch.core.api.matmul`` — ``ring_c`` SpMM on
   R-MAT scale 15 (bs 128, B 512 wide) at g 2 in float32 and bf16 (overlap
   ``auto``, which resolves to the bulk body of ``off``: checked on the
   plans), with the packed wire, and at g 3 in float32 with overlap ``on``
   and ``off``, and dense-output SpGEMM ``A @ A`` on R-MAT scale 14 (bs
   64, B1's sparse-B path: B left sparse), each against a dense
   ``torch.matmul`` oracle in float32 (TF32 off), with the blocks B1
   multiplied counted on the card and held against the real blocks of the
   plan's tables; then B1's sparse-B path at the benchmark's square cell
   shape (R-MAT scale 16 relabelled, bs 32, T 4, n 32,768): each ring
   step's launch against its plain version, timed fresh and into C beside
   its bound, its plain version and cuSPARSE's ``CSR @ CSR``; then a
   ``torch.profiler``
   breakdown of one float32 multiply of each kind (device time by kernel,
   idle share), which must show no roll and no gather of the SpMM's
   operands;
5. steal3d (the paper's SS3.4 work stealing): on the SpMM cell at g 2
   (float32, bf16, the packed wire, overlap ``on``) and g 3 (where the
   assignment moves items: padded, and packed with overlap ``on``), and on
   the dense-output SpGEMM cell, each against the oracle, B1's launches a
   multiply (1, 2 with overlap) and the blocks it multiplied (counted on
   the card) against the plan's real pairs (g x A's real blocks); CUDA-event
   times of the B1 launches and of the reduce rounds; profiles that must
   show no roll and no copy of a placed operand;
6. other schedules: ``summa_bcast``, ``summa_ag``, ``ring_a`` and
   ``ring_c_bidir`` through the same entry point at the SpMM cell's full
   width (g 2; g 3 for ``ring_a`` and ``ring_c_bidir``, whose rides differ
   from g 3 on; the packed wire where the schedule packs A) and in
   dense-output SpGEMM on the scale-14 operand, each against the oracle
   with B1's blocks counted against the real blocks of its plan's tables
   (``plan.launch_maps()``); ``algorithm="auto"``'s choice and scores on the
   ``H100_SXM`` preset over all six schedules, planned and run, and each
   schedule's predicted
   seconds beside its measured median (a record, not a check); a
   ``torch.profiler`` breakdown of one SpMM per schedule, which must show
   no roll and no gather of a placed operand (``ring_c_bidir``'s split of B
   into contiguous halves is timed and printed);
7. obs: one traced multiply (``repro_torch.obs``), its span tree and its
   drift record (predicted for g x g H100s, measured on this card); an
   untraced call records nothing;
8. sparse-output path: ``matmul(A, A, output="auto")`` on R-MAT scale 16,
   edge factor 1 (bs 32, g 2), which resolves to a sparse output over the
   packed wire: its cold plan (symbolic phase), B2 at its step-0 shapes
   (fresh output) and at step 1's (into the carry) against the plain
   version and cuSPARSE ``CSR @ CSR``, the pairs B2 multiplied (counted on
   the card) against the real ones, the multiply's time and breakdown, and
   C against scipy's ``A @ A`` for equality (R-MAT values are 1.0, so C
   holds exact path counts); then the same through ``summa_bcast`` and
   ``summa_ag``, each equal to scipy's with B2's pairs counted;
9. the chained cube on ``benchmarks/spgemm_bench.py``'s configuration
   (R-MAT scale 13, edge factor 1, bs 8, g 2): ``(A @ A) @ A`` with sparse
   outputs over the padded and the packed wire, exactly against scipy;
10. the dense-tile SpGEMM entry point ``ops.bsr_pair_matmul`` (B3) on one
   tile, R-MAT scale 13 (bs 64) through ``ops.build_pair_lists``, against
   the plain version and cuSPARSE ``CSR @ CSR``;
11. serving: OLMoE-1B-7B at its published width and depth (16 layers,
   d_model 2048, 64 experts top-8, random weights from a seeded
   ``torch.Generator`` on the card) through ``ServeEngine(sparse=True)``,
   four requests (prompts of 128, 100, 57 and 128 tokens, 8 new tokens
   each, two decode slots).  Gate, in float32 with TF32 off: each
   request's tokens equal the port's dense ``lm.greedy_decode``'s but at a
   printed near-tie; B1 launched 48 times a prefill and 32 a decode step,
   B2 16 a prefill; the blocks and pairs they multiplied (counted on the
   card) equal their tables' real ones and the block-diagonal scores'
   pairs; no plan-cache miss for a same-bucket request or a decode step
   after the first.  Then in bfloat16: the first-token logits against the
   dense path's within the bound below, ``summary()`` (TTFT, TPOT, decode
   tok/s, plan lookups, drops), launches and host synchronisations of one
   prefill and one decode step, a ``torch.profiler`` window of each
   (device busy against wall, idle share, top device ops) and the host
   time of operator construction, tiling, plan lookups and multiplies
   (obs spans); then B1 at the MoE dispatch, MoE combine and P @ V shapes
   and B2 at the scoring shape against their plain versions, bounds and
   library yardsticks;
12. training (``repro_torch.launch.train.train``): a gate at smoke size,
   float32 with TF32 off: ``qwen2.5-3b``, ``olmoe-1b-7b`` (at the
   published capacity factor 1.25, so tokens drop), ``mamba2-130m``,
   ``recurrentgemma-2b`` and ``hubert-xlarge`` train 10 steps on the
   card and on the CPU from the same parameters, their losses, aux losses,
   dropped shares and gradient norms held at every step and their final
   parameters within the bounds below; resume on the card (20 steps
   straight against 10, a stop, and a relaunch that resumes to 20, with
   deterministic algorithms); then Qwen2.5-3B at its published width and
   depth (36 layers, d_model 2048, 3,085,697,024 parameters, bf16
   compute over float32 parameters and AdamW state, remat on) for 8 steps
   of 4 x 512 tokens: finite losses and gradient norms, the mean of the
   last 3 losses under the first 3's, each step's wall time, tokens/s,
   the model-flops share, peak memory, a ``torch.profiler`` step (busy
   against wall, top device ops), one step split by synchronisations
   into forward, backward and optimizer device time, and the host
   synchronisations of a step.  B1, B2 and B3 launch no time in training
   (the JAX training path runs no Pallas kernel);
13. elastic replanning and the static verifier (``repro_torch.analysis``,
   ``repro_torch.runtime.replan``) at the SpMM cell's full width:
   ``validate="fast"`` on a fresh plan of each of the six schedules (g 2),
   of steal3d at g 3 and of the scale-16 sparse-output A @ A, and
   ``validate="full"`` (one multiply under the op-trace lint, B1 and B2
   launched) on the six and the sparse one, each clean, with its host
   time from its span; ``auto`` at g 2 on the H100 preset with a 100x
   network, a traced multiply against the oracle, 8x straggler drift on
   two series, ``should_replan()`` tripping and ``replan()`` evicting and
   re-selecting (the choice before and after printed), the replanned
   multiply against the oracle; steal3d at g 3, the seeded loss of 5 of 9
   devices and ``recover_from_loss`` onto g 2 with no floating-point data
   copied to the host, the recovered multiply against the oracle with
   B1's blocks counted against the plan's real pairs, the recovery's
   host time by span and the multiply's device time; the serving gate's
   requests again through ``ServeEngine(sparse=True,
   replanner=ElasticReplanner())`` with drift injected after the first
   prefill: one drain-and-refit, the gate's tokens; and ``python -m
   repro_torch.launch.selftest --check all --g 3`` as a subprocess;
14. the recurrent, SSM and frontend families: RecurrentGemma-2B at its
   published width and depth (26 layers ``rrl``, d_model 2560, 10 query
   heads and 1 KV head of 256, GeGLU d_ff 7680, vocab 256,000; random
   weights from a seeded ``torch.Generator`` on the card) through
   ``ServeEngine(sparse=True)`` with phase 11's requests, prefilled at
   their exact lengths (the recurrent state sees every token, so nothing
   is padded).  Gate, in float32 with TF32 off: the tokens equal the
   port's dense ``lm.greedy_decode``'s but at a printed near-tie; B2
   (scores) and B1 (P @ V) launched 8 times a prefill (its 8 local
   attention layers) and never in a decode step; the blocks and pairs
   they multiplied (counted on the card) equal their tables' real ones
   and the scores' real pairs; no plan-cache miss for the second
   128-token request.  Then in bfloat16 as phase 11: first-token logits,
   ``summary()``, a profiled prefill and decode step, and B1 and B2 at
   these shapes against their plain versions, bounds and library
   yardsticks.  The published window (2048) is above ``max_len``, so it
   prunes no block here.  Then Mamba2-130m at its published width and
   depth trains 8 steps of 4 x 2048 tokens (bf16 over float32 state):
   finite losses and gradient norms, the last 3 losses' mean under the
   first 3's, tokens/s, peak memory, the largest ``A dt (chunk - 1)`` and
   intra-chunk exponent seen (whether the reference's unmasked decay would
   overflow), and a float32 prefill and 4 decode steps against the full
   forward (2e-3); hubert-xlarge at its published width trains 4 steps of
   4 x 512 frames (finite losses and gradient norms, time a step); and
   llava-next-mistral-7b at its published width, weights in bf16, decodes
   8 tokens greedily after 1,152 patches and 64 text tokens (finite
   logits, the prefill's wall time, peak memory);
15. the schedules on a process grid (``launch/grid.py``): 4 ranks
   (g = 2) spawned on this one card, joined over the ``gloo`` transport,
   each staging its tiles through pinned host memory (NCCL refuses two
   ranks on one card: ``make_grid_mesh(2, backend="nccl")`` must refuse
   at once).  The stacked executor's results come first, on the same
   inputs; the parent then frees its card memory and spawns the ranks,
   which load their own tiles only.  On the SpMM cell (R-MAT scale 15,
   bs 128, B 512 wide): ``ring_c`` in float32 and bf16, padded and packed
   wire, overlap on and off, then ``summa_bcast``, ``summa_ag``,
   ``ring_a``, ``ring_c_bidir`` and ``steal3d`` in float32; on the sparse
   cell (scale 16, edge factor 1, bs 32, packed): sparse outputs through
   ``ring_c``, ``summa_ag`` and ``summa_bcast``.  Every rank's C tile
   against the stacked executor's (dense: within the dense tolerance,
   bit-equality printed; sparse: the structure fingerprint and exact
   sums equal), the blocks and pairs each rank's B1 and B2 launches
   multiplied (counted on the card) equal to its tables' real ones and,
   summed over the ranks, to the stacked plan's, each rank's body bytes
   equal to the cost model's relation; the slowest rank's wall per
   multiply, each rank's host staging and transport time, B1's and B2's
   busy time by rank (profiled), peak memory by rank, and B1 and B2 at a
   rank's one-tile shapes against their plain versions, bounds and
   library yardsticks.  These times are of 4 ranks sharing one card over
   host memory, not of NVLink;
16. the LM stack sharded over ranks that share the card over ``gloo``,
   host-staged as in phase 15 (NCCL refuses two ranks on one card).  The
   single process's results come first.  (a) OLMoE-1B-7B at its published
   width and depth in bf16 with ``moe_impl="ring"`` on a (data 1, model 4)
   mesh of 4 ranks, each building the model layer by layer from the
   seeded init and keeping its 16 experts a layer (the rest whole): one
   forward of 2 x 512 tokens, the logits within twice the single process's
   dense bf16 distance from its float32 logits (phase 11's bound), at the
   capacity factor (printed) doubled from the published one until the
   dense path drops no token; the ring's hops, R = 4 per MoE layer on
   every rank; each rank's parameter bytes, peak memory and the wall.
   (b) Qwen2.5-3B at its published width with its depth cut to 4 of 36
   layers (full depth is ~49 GB of float32 parameters, gradients and
   moments summed over the ranks, before activations and 4 CUDA
   contexts), the FSDP x tensor-parallel program (``"fsdp_tp"``: each
   rank computes its q heads, MLP units and vocabulary of every product):
   ``train(mesh=)`` on a (2, 2) mesh for 3 float32 steps of 4 x 512
   tokens, the losses and gradient norms within 1e-4 (relative) of the
   single process's and each parameter shard within 1e-4 of its norm;
   each rank's parameter and moment bytes equal to its sanitized shards';
   each rank's product flops in one more step, recorded on the card by
   ``OpRecorder`` (``dryrun.record_cell``), equal to the dry run's for the
   same (2, 2) cell exactly; each rank's peak memory over the 3 steps;
   ``compressed_psum`` over the data axis on one step's gradients within
   one int8 step of the float32 all-reduce, its residual exactly ``g -
   deq``.  Then the same model on a (1, 4) mesh: ``sharded_prefill`` of 2
   x 512 tokens into a cache of 520 slots, split by sequence over the
   4 ranks (2 kv heads do not cover the model axis), and 3 steps of
   ``make_sharded_decode_step``, the logits of each within 1e-4 of the
   single process's ``lm.prefill`` and decode steps.  Then, in a world of
   their own, the recurrent, SSM and frontend families' cells
   (``LM_FAMILIES``), each on the (2, 2) mesh, held as Qwen's (losses,
   gradient norms, shards, bytes, product flops the dry run's (2, 2)
   cell's): Mamba2-130m at its published width and depth, 3 steps of 4 x
   512 tokens; RecurrentGemma-2B at its published width cut to one "rrl"
   group of 3 layers, 3 steps; both then served on (1, 4) as Qwen is;
   llava-next-mistral-7b cut to 2 of 32 layers, 1 step of 1152 patches
   and 512 tokens a row (hubert-xlarge's cell is cut for time: see
   ``LM_FAMILIES``).  (c) steal3d at the SpMM cell on a 3x3 grid of 9
   ranks: the seeded loss of 5 and ``recover_from_loss`` on the ranks
   (blocks re-placed by exchange, a new 2x2 grid over the survivors), every
   survivor's C tile bit-equal to the stacked recovery's, B1 launched on
   every survivor over exactly its plan's real pairs (counted on the
   card), the verifier's findings on the rank plans equal to the stacked
   plan's, the recovery's host ms by ``replan.*`` span, and B1 at a
   survivor's shape against its plain version and bound.
17. the dry run and the examples.  (a) Before the training phase's
   published run: ``launch/dryrun.py``'s machinery on its cell
   (Qwen2.5-3B, 4 x 512, bf16 over float32 state, remat) on a world of one
   rank, under ``FakeTensorMode``: the prediction is printed, then the
   same program (``dryrun.record_cell``) runs for real on the card under
   the same recorder.  The predicted parameter and moment bytes must equal
   the real ones exactly, the predicted product flops the real step's, and
   the predicted peak (arguments + temporaries) be within 10 % of the
   step's ``max_memory_allocated`` (less what was allocated before it).
   (b) Three production cells on a fake world of 256 ranks (16 x 16):
   ``qwen2.5-3b train_4k``, ``olmoe-1b-7b prefill_32k`` and ``mamba2-130m
   long_500k``, each ``ok``, its roofline line printed.  (c) The five
   examples (``examples/torch_*.py``) on the card, each in a child
   (started while (b) runs), each exiting 0 with its own correctness line;
   B1 and B2 counted on the card in each child, every launch over exactly
   its table's real blocks or pairs.

Each path runs with every launch count set to 0 just before it and read
just after.  The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from importlib import metadata, util
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


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
#
# The serving phase's bf16 first-token logits (engine against the dense
# path, both in bf16): each path computes the float32 function with bf16
# roundings, so each lies within its rounding noise of the float32 dense
# logits.  The dense bf16 path's largest distance from them over the
# requests measures that noise; two paths within it differ by at most
# twice it (triangle inequality), which is the bound held.
#
# The training gate (the card's train() against the CPU's, float32, TF32
# off, 10 steps from the same parameters and batches):
#
# * losses, aux losses and gradient norms: 1e-4 relative at every step.
#   One float32 step differs by the order of its sums, ~1e-6 relative at
#   smoke widths (tests/test_torch_train.py holds the CPU at 1e-5 of
#   JAX); the parameters' drift below lies in elements whose gradient is
#   within rounding of zero, which move the loss to second order only;
# * dropped shares: equal (the same routing on both sides);
# * parameters: 1e-5 (1 + |p|) plus Adam's amplification of rounding: a
#   step moves an element by lr_t * r_t, |r_t| <= R
#   (AdamW.ratio_bound, 1.011 within 10 steps), and where a gradient lies
#   within rounding of zero the two runs may step opposite ways, so two
#   runs part by at most 2 R sum_t lr_t (AdamW.rounding_allowance's cap:
#   its first-order part needs each step's moments, which train() keeps
#   to itself).  How many elements go past 1e-5 (1 + |p|) is printed;
# * resume on the card, deterministic algorithms on: the JAX test's rtol
#   1e-5, atol 1e-6 (tests/test_train_loop.py); the largest difference
#   is printed (0 expected: the same kernels in the same order).
TOL_F32_SMALL = 1e-5
TOL_F32_DEEP = 1e-4
TOL_TRAIN_GATE = 1e-4
BF16_STEP = 2.0 ** -7
BF16_ROUND = 2.0 ** -8

DEVICE = "cuda"
PROFILED = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
SPMM = dict(scale=15, seed=1, block_size=128, g=2, width=512)
SPMM_G3 = 3          # the overlap bodies differ from g = 3 on
# the schedules besides ring_c, in the registry's order; ring_a's and
# ring_c_bidir's rides differ from g = 3 on
OTHER = ("summa_bcast", "summa_ag", "ring_a", "ring_c_bidir")
OTHER_G3 = ("ring_a", "ring_c_bidir")
SPGEMM = dict(scale=14, seed=2, block_size=64, g=2)
# the benchmark's square cell (bench/configs/rmat16-square.json): R-MAT
# scale 16, edge factor 8, vertices relabelled by default_rng(seed + 1)'s
# permutation, bs 32 on a 2 x 2 grid, values standard normal
SQUARE = dict(scale=16, edgefactor=8, seed=1, block_size=32, g=2)
# sparse-output SpGEMM A @ A: predicted C block density 0.236, under
# output="auto"'s 0.25, so it resolves to a sparse output
SPARSE = dict(scale=16, edgefactor=1, seed=2, block_size=32, g=2)
# benchmarks/spgemm_bench.py's graph-squaring configuration
CUBE = dict(scale=13, edgefactor=1, seed=0, block_size=8, g=2)
# the dense-tile SpGEMM of ops.bsr_pair_matmul on one tile
PAIR_TILE = dict(scale=13, edgefactor=8, seed=3, block_size=64)
# block sizes of the pair kernels' small cases
PAIR_SMALL_BS = (4, 8, 16, 24, 32, 64)
# the serving phase: OLMoE-1B-7B at its published width and depth, four
# requests (buckets 128, 128, 64, 128) through two decode slots
SERVE = dict(arch="olmoe-1b-7b", seed=0, prompt_lens=(128, 100, 57, 128),
             new_tokens=8, max_batch=2, max_len=144, block_size=8)
# a token may differ from the dense path's only where the dense path's
# top-2 logit margin is under this share of its largest |logit|
NEAR_TIE = 1e-4
# the training phase: the smoke-size gate (card against CPU), resume on
# the card, and Qwen2.5-3B at its published width and depth
TRAIN_GATE = dict(archs=("qwen2.5-3b", "olmoe-1b-7b", "mamba2-130m",
                         "recurrentgemma-2b", "hubert-xlarge"), steps=10,
                  batch=4,
                  seq=32, lr=3e-3, seed=0, capacity_factor=1.25)
TRAIN_RESUME = dict(arch="qwen2.5-3b", steps=20, stop_after=10, batch=2,
                    seq=16, seed=7)
TRAIN = dict(arch="qwen2.5-3b", steps=8, batch=4, seq=512, lr=3e-4, seed=0)
# elastic replanning and the static verifier at the SpMM cell: steal3d at
# g 3 loses 5 of its 9 devices (seeded) and recovers onto g 2; straggler
# drift of 8x on 4 records a series
ELASTIC = dict(steal_g=3, devices=9, lost=5, seed=0, factor=8.0, records=4)
# the schedules whose straggler drift the replan fits, beside the auto
# plan's own: a bulk-synchronous and a ring series, whose (bytes, messages)
# rows are not proportional
FIT_SERIES = ("summa_bcast", "ring_a")
# phase 14: RecurrentGemma-2B served as phase 11 serves OLMoE (SERVE's
# requests, slots and block size); Mamba2-130m and hubert-xlarge trained and
# llava-next-mistral-7b decoded at their published widths and depths
RECURRENT_SERVE = "recurrentgemma-2b"
MAMBA_TRAIN = dict(arch="mamba2-130m", steps=8, batch=4, seq=2048, lr=1e-3,
                   seed=0, prefill=260, decode=4)
HUBERT_TRAIN = dict(arch="hubert-xlarge", steps=4, batch=4, seq=512, lr=3e-4,
                    seed=0)
LLAVA_DECODE = dict(arch="llava-next-mistral-7b", text=64, new_tokens=8,
                    seed=0)
# decode steps against the full forward: tests/test_models_smoke.py's 2e-3
DECODE_TOL = 2e-3


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


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn``, a short launch sequence whose
    host side takes longer than its device side: a sleep kernel holds the
    card while the host queues the ``reps`` calls, so the CUDA events time
    the device's work back to back, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)         # ~25 ms at the H100's clock
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
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, driver {driver}")
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


def peaks():
    """The H100 SXM's HBM bytes/s and its peak operations by operand type
    (float32 FMA on the CUDA cores, bf16 on the tensor cores), from the
    port's roofline presets (NVIDIA's data sheet, dense rates)."""
    from repro_torch.core.roofline import H100_SXM, H100_SXM_PEAK_OPS
    return H100_SXM.mem_bw, {getattr(torch, k): v
                             for k, v in H100_SXM_PEAK_OPS.items()}


def b1_bound(table, bs: int, dense, out) -> dict:
    """Least time for one B1 call, from the work of the path its table
    takes.  The block path: the real blocks and the B block-rows they
    multiply read once, the output written once (and the table's int32s
    read once), the real blocks' flops.  The element path
    (``table.elements``): A's nonzeros read once (value, B row, pool
    offset), the B rows they gather read once, the output written once
    (and the units, segments, chunks and the visited rows' pointers read
    once), two flops a nonzero and output column.  ``real_flops`` is the
    real blocks' flops on both paths."""
    elem = dense.element_size()
    n = dense.shape[-1]
    real = table.real_blocks
    real_flops = 2 * real * bs * bs * n
    out_bytes = out.numel() * out.element_size()
    el = table.elements
    if el is None:
        ch = table.chunks.long()
        first, order = torch.sort(ch[1])
        lengths = (ch[2] - ch[1])[order]
        b_tile = torch.repeat_interleave(ch[5][order], lengths)
        k_blocks = dense.shape[1] // bs
        b_rows = torch.unique(b_tile * k_blocks
                              + table.ent[1].long()).numel() * bs
        table_bytes = 4 * sum(x.numel() for x in (
            table.ent, table.chunks, table.reduce, table.fill))
        nbytes = real * bs * bs * elem + b_rows * n * elem + out_bytes \
            + table_bytes
        flops = real_flops
    else:
        lists = el.lists
        units = el.units.long()
        row0 = units[1] * (lists.n_block_rows * bs) + units[3]
        lo, hi = lists.rowptr[row0], lists.rowptr[row0 + units[4]]
        lengths = hi - lo
        at = torch.repeat_interleave(lo - torch.cumsum(lengths, 0) + lengths,
                                     lengths) \
            + torch.arange(int(lengths.sum()), device=lo.device)
        b_rows = torch.unique(
            torch.repeat_interleave(units[2], lengths) * dense.shape[1]
            + lists.brow[at].long()).numel()
        table_bytes = sum(x.numel() * x.element_size() for x in (
            el.units, el.segs, el.seg_chunks, el.flag_chunks, table.fill)) \
            + (int(units[4].sum()) + units.shape[1]) \
            * lists.rowptr.element_size()
        nbytes = el.n_elements * (elem + lists.brow.element_size()
                                  + lists.aoff.element_size()) \
            + b_rows * n * elem + out_bytes + table_bytes
        flops = 2 * el.n_elements * n
    peak_bytes, peak_ops = peaks()
    t_bytes = nbytes / peak_bytes * 1e3
    t_ops = flops / peak_ops[dense.dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "real_blocks": real,
            "real_flops": real_flops}


def counted_blocks(fn):
    """``fn()`` with B1's block counter on: (its result, the blocks that
    the kernel's launches in it multiplied, counted on the card)."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    counter = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    bsr_spmm_cuda.block_counter = counter
    try:
        out = fn()
    finally:
        bsr_spmm_cuda.block_counter = None
    torch.cuda.synchronize()
    return out, int(counter.item())


def kernel_case(blocks, rows, cols, dense, nbr: int, tol: float, label: str,
                table=None, reps: int = 0, timer=None) -> dict:
    """B1 against its plain version on the same inputs (``tol`` for the
    float32 sums, one bf16 step more for a bf16 output), the blocks it
    multiplied (counted on the card) against its table's; timed when
    ``reps`` by ``timer`` (``time_ms``; ``device_ms`` where a launch is
    shorter than the host's call).  Without ``table`` every listed block
    counts as real (a raw call)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_spmm import (bsr_spmm_cuda, kernel_path,
                                              spmm_table)
    t, s, bs, _ = blocks.shape
    if table is None:
        slots = torch.arange(t)[:, None] * s + torch.arange(s)
        table = spmm_table(slots, rows, cols, nbr, device=blocks.device)
    got, multiplied = counted_blocks(
        lambda: bsr_spmm_cuda(blocks, dense, table))
    want = ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    step = BF16_STEP if got.dtype == torch.bfloat16 else 0.0
    err, share, ok = compare(got, want, abs_product(blocks, rows, cols, dense,
                                                    nbr), tol, step)
    del want
    path = kernel_path(bs, torch.promote_types(blocks.dtype, dense.dtype)) \
        if table.elements is None else "element gather, float32 FMA"
    n = dense.shape[-1]
    log(f"  B1 {label} [{path}]: {table.chunks.shape[1]} chunks, "
        f"{table.reduce.shape[1]} segments in partials, workspace "
        f"{table.workspace_bytes(bs, n) / 1e6:.2f} MB; multiplied "
        f"{multiplied} blocks, {table.real_blocks} in the table, of {t * s} "
        f"stored: max_abs_err {err:.3e}, {share:.3g} of its allowance "
        f"(tol {tol:g} x |A||B| + {step:g} x |want|) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"B1 {label} disagrees with its plain version")
    check(multiplied == table.real_blocks,
          f"B1 {label} multiplied {multiplied} blocks, not the table's "
          f"{table.real_blocks}")
    res = {"max_abs_err": err, "share_of_tolerance": share, "path": path,
           "blocks_multiplied": multiplied, "stored_blocks": t * s,
           "workspace_bytes": table.workspace_bytes(bs, n),
           "stored_flops": 2 * t * s * bs * bs * n}
    if reps:
        timer = timer or time_ms
        res["ms"] = timer(lambda: bsr_spmm_cuda(blocks, dense, table),
                            reps)
        res["plain_ms"] = timer(lambda: ref.bsr_spmm_raw_ref(
            blocks, rows, cols, dense, nbr), max(1, reps // 4))
        res.update(b1_bound(table, bs, dense, got))
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        log(f"  B1 {label}: {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
            f"({res['bound_by']}, the {table.path} path's work), "
            f"{100 * res['share_of_bound']:.1f} % of it; "
            f"{res['flops'] / res['ms'] / 1e9:.1f} TFLOP/s on the "
            f"{'nonzeros' if table.elements is not None else 'real blocks'}")
    return res


def small_kernel_cases(device) -> None:
    """Block sizes 4..192 (192 takes two row parts) with ragged widths, in
    float32 and bf16 for each of the kernel's tile shapes (SIMT at every
    bs, the tensor cores for bf16 at multiples of 16), listed as a raw call
    lists them (every stored block real; capacity padding several chunks
    long takes partials), and once through the storage layout's real mask
    (the padding and coverage zeros skipped)."""
    from repro_torch.core.bsr import TiledBSR, random_sparse
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.kernels.bsr_spmm import CHUNK, kernel_path, spmm_table
    rng = np.random.default_rng(0)
    cases = [(4, 37, torch.float32, "bucket"),
             (8, 70, torch.float32, "bucket"),
             (16, 129, torch.float32, "bucket"),
             (24, 45, torch.float32, "bucket"),
             (64, 37, torch.float32, "bucket"),
             (192, 70, torch.float32, "bucket"),
             (8, 37, torch.bfloat16, "bucket"),
             (24, 45, torch.bfloat16, "bucket"),
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
        args = (t.blocks.reshape(3, s, bs, bs), t.rows.reshape(3, s),
                t.cols.reshape(3, s), dense, t.tile_shape[0] // bs,
                TOL_F32_SMALL)
        label = f"bs={bs} n={n} {str(dtype)[6:]} capacity {t.capacity}"
        res = kernel_case(*args, label)
        if capacity != "bucket":
            check(res["workspace_bytes"] > 0,
                  f"B1 {label}: no segment several chunks long")
        else:
            real = spmm_table(torch.arange(3)[:, None] * s + torch.arange(s),
                              args[1], args[2], args[4],
                              real=t.real_slots().reshape(3, s),
                              device=device)
            kernel_case(*args, label + ", real blocks", table=real)
    for bs in (64, 128):
        check(kernel_path(bs, torch.bfloat16) == "mma.sync bf16 tensor cores",
              f"B1 bf16 at bs {bs} is not on the tensor cores")
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


def main_path_kernel_cases(cases) -> dict:
    """B1 at the shapes of its main paths' ring step, with the plan's own
    table (the real blocks alone), each input read where the plan reads
    it: the natural A stack and the natural (for SpGEMM densified) B stack,
    output tile p reading tile p of each.  Then its two library yardsticks
    on the same real blocks.  ``cases`` are (shape name, dtype, A handle,
    B handle)."""
    from repro_torch.core import api
    res = {}
    for shape, dtype, a_h, b_h in cases:
        plan = api.plan_matmul(a_h, b_h)
        ex, g, bs = plan.executor, a_h.g, a_h.block_size
        nbr = a_h.tile_shape[0] // bs
        nat = a_h.placed(api.NATURAL)
        blocks, rows, cols = (ex.batch(nat[k])
                              for k in ("blocks", "rows", "cols"))
        dense = ex.batch(api._densify_b(b_h.placed(api.NATURAL),
                                        plan.geom, ex)["dense"])
        ident = ex.identity_map()
        table = plan.spmm_table(a_h, ident, ident)
        ch = table.chunks
        seg = (ch[2] - ch[1]).float()
        log(f"  main-path {shape} step: T={g * g} tiles, S={blocks.shape[1]} "
            f"stored blocks, bs={bs}, n={dense.shape[-1]}; "
            f"{table.real_blocks} real blocks in {ch.shape[1]} chunks (a "
            f"block-row segment: mean {seg.mean().item():.1f}, max "
            f"{int(seg.max().item())}), {table.fill.shape[1]} block-rows "
            f"zero-filled, {table.n_parts} partials")
        label = f"main-path {shape} {str(dtype)[6:]}"
        # an element launch is shorter than the host's call: device time
        r = kernel_case(blocks, rows, cols, dense, nbr, TOL_F32_DEEP, label,
                        table=table, reps=10 if shape == "SpMM" else 4,
                        timer=device_ms if table.elements is not None
                        else None)
        check(r["workspace_bytes"] == 0,
              f"B1 {label} needs a partial workspace")
        r["nonfinite"] = nonfinite_case(blocks, rows, cols, dense, nbr, table,
                                        label, r["ms"])
        real = a_h.pool_lists(False).real
        r.update(b1_yardsticks(blocks, rows, cols, dense, nbr, real,
                               TOL_F32_DEEP, label))
        r["shape"] = {"T": g * g, "S": blocks.shape[1], "bs": bs,
                      "n": dense.shape[-1]}
        res[(shape, dtype)] = r
        if shape == "SpMM" and table.elements is not None:
            # the block path on the same real blocks, which raw calls,
            # steal3d and high-fill handles take
            blocks_table = a_h.pool_lists(False).table(
                ident, ident, nbr, device=blocks.device)
            b = kernel_case(blocks, rows, cols, dense, nbr, TOL_F32_DEEP,
                            label + ", block path", table=blocks_table,
                            reps=4)
            b["shape"] = r["shape"]
            res[(shape + " block path", dtype)] = b
            del blocks_table
        del blocks, rows, cols, dense, table
        free()
    return res


def nonfinite_case(blocks, rows, cols, dense, nbr: int, table, label: str,
                   launch_ms: float) -> dict:
    """B1 on B with an inf, a NaN and a -inf planted (in the first B chunk,
    which coverage blocks read, in a middle chunk, and in the last tile):
    its NaN mask must equal the plain version's, which multiplies every
    listed block, zero blocks included (``0 * inf``); its finite values
    agree as on finite B.  Then the NaN pass's device time on finite B
    (:func:`device_ms`), where it must write nothing, beside one read of
    the B chunks it flags at the HBM peak (``flag_read_ms``): the element
    path's pass flags every chunk a real block reads, the block path's
    those of the skipped entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda, nan_pass
    k, n = dense.shape[1], dense.shape[2]
    bad = dense.clone()
    bad[0, 1, 3 % n] = float("inf")
    bad[0, k // 2 + 1, 7 % n] = float("nan")
    bad[-1, k - 2, 11 % n] = float("-inf")
    got = bsr_spmm_cuda(blocks, bad, table)
    want = ref.bsr_spmm_raw_ref(blocks, rows, cols, bad, nbr)
    nan = torch.isnan(want)
    same = bool(torch.equal(torch.isnan(got), nan))
    n_nan = int(nan.sum().item())
    keep = torch.isfinite(want)
    scale = abs_product(blocks, rows, cols, bad.nan_to_num(0.0, 0.0, 0.0),
                        nbr)
    step = BF16_STEP if got.dtype == torch.bfloat16 else 0.0
    err, share, ok = compare(got[keep], want[keep], scale[keep],
                             TOL_F32_DEEP, step)
    del got, want, nan, keep, scale, bad
    out = bsr_spmm_cuda(blocks, dense, table)
    flag_ms = device_ms(lambda: nan_pass(dense, table, out), 20)
    flagged = (table.skip_chunks if table.elements is None
               else table.elements.flag_chunks).shape[1]
    flag_read_ms = flagged * blocks.shape[-1] * n * dense.element_size() \
        / peaks()[0] * 1e3
    finite = bool(torch.isfinite(out).all())
    del out
    log(f"  B1 {label} on non-finite B: {n_nan} NaN elements, NaN mask "
        f"{'equal to' if same else 'DIFFERENT FROM'} the plain version's "
        f"({table.skip.shape[1]} skipped entries on "
        f"{table.skip_chunks.shape[1]} B chunks); finite values max_abs_err "
        f"{err:.3e}, {share:.3g} of their allowance; the NaN pass on finite "
        f"B: {flag_ms * 1e3:.1f} us of device time a launch, "
        f"{100 * flag_ms / launch_ms:.3f} % of the launch, "
        f"{flag_ms / flag_read_ms:.2f} x a read of its {flagged} B chunks "
        f"at the HBM peak, writes "
        f"{'nothing' if finite else 'NON-FINITE VALUES'}")
    check(same and n_nan > 0 and ok and finite,
          f"B1 {label}: non-finite B gives another NaN mask than the plain "
          "version, or the NaN pass writes on finite B")
    return {"nan_elements": n_nan, "skipped_entries": table.skip.shape[1],
            "flag_ms": flag_ms, "flag_read_ms": flag_read_ms}


def e2e_case(label, a_h, b_h, oracle, scale, tol, overlap, reps=3,
             wire="auto", algorithm="ring_c") -> dict:
    """Time ``matmul`` (median after one warm-up) and hold its result
    against the oracle within ``tol * scale`` elementwise; the warm-up's
    blocks multiplied by B1 (counted on the card) against the real blocks
    of the tables of its plan's launches (``plan.launch_maps()``): each
    launch multiplies every tile's real blocks once."""
    from repro_torch.core import api
    from repro_torch.core.roofline import H100_SXM
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    from repro_torch.obs import sync_elapsed
    kw = dict(overlap=overlap, wire=wire, algorithm=algorithm)
    before = bsr_spmm_cuda.launches
    out, multiplied = counted_blocks(lambda: api.matmul(a_h, b_h, **kw))
    per_multiply = bsr_spmm_cuda.launches - before
    plan = api.plan_matmul(a_h, b_h, **kw)
    name = plan.algorithm.name
    if plan.steal is not None:          # algorithm="auto" may pick steal3d
        launches = plan._steal.segments
        real = plan._steal.real_pairs
        want = a_h.g * int(a_h.counts.sum())
    else:
        launches = [m for step in plan.launch_maps() for m in step]
        real = sum(plan.spmm_table(a_h, a_map, b_map).real_blocks
                   for a_map, b_map in launches)
        want = len(launches) * int(a_h.counts.sum())
    log(f"  e2e {label} {algorithm} overlap={overlap} wire={plan.wire}: B1 "
        f"multiplied {multiplied} blocks in {per_multiply} launches; the "
        f"real blocks of the plan's {len(launches)} launches' tables: {real} "
        f"({want // max(1, int(a_h.counts.sum()))} x "
        f"{int(a_h.counts.sum())} real)")
    check(multiplied == real == want and per_multiply == len(launches),
          f"{label} {algorithm}: B1 multiplied {multiplied} blocks in "
          f"{per_multiply} launches on the main path, not the {want} real "
          f"ones in {len(launches)}")
    times = []
    for _ in range(reps):
        del out
        t0 = time.perf_counter()
        out = api.matmul(a_h, b_h, **kw)
        times.append(sync_elapsed(t0, out) * 1e3)
    check(tuple(out.shape) == tuple(oracle.shape),
          f"{label}: shape {tuple(out.shape)} vs {tuple(oracle.shape)}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err, share, ok = compare(out, oracle, scale, tol)
    med = statistics.median(times)
    predicted = plan.predicted_cost(H100_SXM) * 1e3
    log(f"  e2e {label} {name} overlap={overlap} wire={plan.wire}: median "
        f"{med:.2f} ms of {[round(x, 2) for x in times]} (the cost model "
        f"predicts {predicted:.4f} ms for a grid of {a_h.g ** 2} H100s), "
        f"max_abs_err {err:.3e}, {share:.3g} of its allowance (tol {tol:g} "
        f"x |A||B|) {'ok' if ok else 'MISMATCH'}; workspace "
        f"{plan.workspace_bytes()} bytes")
    check(ok, f"{label} {name} overlap={overlap} disagrees with the dense "
          "oracle")
    check_workspace(plan, a_h.block_size, label)
    return {"ms": med, "launches": per_multiply * (1 + reps),
            "blocks_multiplied": multiplied, "real_blocks": real,
            "algorithm": name, "predicted_ms": predicted}


def check_workspace(plan, bs: int, label: str) -> dict:
    """B1's float32 partial workspace against what the plan's tables need.

    A ring or SUMMA launch's block-row segment is one tile row, at most
    nbc <= CHUNK real blocks: one chunk, no workspace.  A steal3d segment
    gathers one output block-row of a device over every A tile it draws
    on (up to g of them), so it may pass one chunk: its workspace must be
    the largest launch's partials (one ``bs x tn`` float32 per chunk of a
    segment cut into several, counted from the table's chunk list), and
    no larger than that launch's output held in float32 (``g*g x n_slots``
    block-rows of ``bs x tn``): the partials at most double the launch's
    memory."""
    ws = plan.workspace_bytes()
    if plan.steal is None:
        check(ws == 0, f"{label}: B1 needs a {ws}-byte workspace")
        return {"workspace_bytes": ws}
    st, geom = plan._steal, plan.geom
    parts = [int((s["table"].chunks[4] >= 0).sum()) for s in st.segments
             if "table" in s]
    need = max(parts, default=0) * bs * geom.tn * 4
    limit = geom.g * geom.g * st.n_slots * bs * geom.tn * 4
    log(f"  {label}: B1 workspace {ws / 1e6:.2f} MB; the tables' partials "
        f"{parts} x {bs} x {geom.tn} float32 = {need / 1e6:.2f} MB at the "
        f"largest launch; limit {limit / 1e6:.2f} MB (the launch's output "
        f"in float32), {100 * ws / limit:.1f} % of it")
    check(ws == need and ws <= limit,
          f"{label}: B1 workspace {ws} bytes, the tables need {need}, the "
          f"limit is {limit}")
    return {"workspace_bytes": ws, "workspace_limit_bytes": limit}


# B1's and B2's main kernels as the profiler names them, and the launch
# counts (:func:`traced_counts`) of which each runs once a launch: B1's by
# path (a launch with no chunk of work runs none: no profiled window here
# has such a launch)
TRACED_KERNELS = {"spmm_kernel": ("bsr_spmm.blocks",),
                  "spmm_elem_kernel": ("bsr_spmm.elements",),
                  "spmm_sparse_b_kernel": ("bsr_spmm.sparse_b",),
                  "pair_kernel": ("bsr_pair_accumulate", "bsr_pair_matmul")}
# host time between the profiler's start and the window's first launch
PROFILE_PREROLL_S = 0.02


def profiled(fn, label: str, attempts: int = 3):
    """``fn()`` in a ``torch.profiler`` window, checked against the launch
    counters: the trace must hold each kernel of ``TRACED_KERNELS`` as
    many times as its wrappers launched it.  A trace that lost one is
    printed (with what the profiler's raw results held, and its runtime
    launch records against its kernel records) and taken again, at most
    ``attempts`` times in all, each retry with the window held open
    longer around ``fn``: ``PROFILE_PREROLL_S`` before it at first, then
    also 0.2 s after it, then 0.2 s on both sides.  ``fn`` returns its
    wall milliseconds (it synchronises).  Returns (device events, wall ms,
    profiler, launches, lost: kernel -> (in the trace, launched), empty
    when the last trace holds every launch); a window whose trace lost a
    kernel has no device busy time or idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    rolls = [(PROFILE_PREROLL_S, 0.0), (PROFILE_PREROLL_S, 0.2), (0.2, 0.2)]
    for attempt in range(1, attempts + 1):
        pre, post = rolls[min(attempt, len(rolls)) - 1]
        before = traced_counts()
        with profile(activities=PROFILED) as prof:
            time.sleep(pre)
            wall_ms = fn()
            torch.cuda.synchronize()
            time.sleep(post)
        after = traced_counts()
        launched = {k: after[k] - before[k] for k in after}
        events = device_events(prof)
        lost = {}
        for kern, wrappers in TRACED_KERNELS.items():
            want = sum(launched[w] for w in wrappers)
            got = sum(1 for e in events if e[0] == kern)
            if got != want:
                lost[kern] = (got, want)
        if not lost:
            if attempt > 1:
                log(f"  {label}: attempt {attempt} (window open {pre} s "
                    f"before and {post} s after) holds every launch")
            return events, wall_ms, prof, launched, {}
        raw = {}
        results = getattr(prof.profiler, "kineto_results", None)
        if results is not None:
            for e in results.events():
                for kern in lost:
                    if kern in e.name():
                        raw[kern] = raw.get(kern, 0) + 1
        runtime = sum(1 for e in prof.events() if e.device_type
                      == DeviceType.CPU and "LaunchKernel" in e.name)
        kernels = sum(1 for n, _, _ in events
                      if not n.startswith(("Memcpy", "Memset")))
        log(f"  {label}: the trace (attempt {attempt} of {attempts}, window "
            f"open {pre} s before and {post} s after) holds "
            f"{ {k: f'{g} of {w} launches' for k, (g, w) in lost.items()} }"
            f"; the profiler's raw results {raw or 'none of them'}; "
            f"{runtime} runtime launch records against {kernels} kernel "
            f"records")
    return events, wall_ms, prof, launched, lost


def device_events(prof) -> list:
    """(name, start us, end us) of each kernel and copy on the card in a
    ``torch.profiler`` window."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        # "void at::native::(anonymous namespace)::roll_kernel<...>(...)"
        # -> "at::native::roll_kernel"
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("<")[0].split("(")[0].strip()
        out.append((name, e.time_range.start, e.time_range.end))
    return out


def device_breakdown(a_h, b_h, label: str, operands=(), **kw) -> dict:
    """Device time by kernel over one multiply (``torch.profiler``), beside
    the multiply's wall time: where the time goes, and the share of the
    wall time in which no kernel or copy ran on the card.  ``kw`` goes to
    ``matmul``; one more multiply lists its rolls and, for the tensors in
    ``operands`` (the handles' storage and the natural stacks the bodies
    read), the copy ops that read them
    (``repro_torch.analysis.op_lint.copy_ops``)."""
    from repro_torch.analysis.op_lint import copy_ops
    from repro_torch.core.api import matmul
    from repro_torch.obs import sync_elapsed
    out = matmul(a_h, b_h, **kw)
    del out
    torch.cuda.synchronize()

    def once():
        t0 = time.perf_counter()
        out = matmul(a_h, b_h, **kw)
        return sync_elapsed(t0, out) * 1e3
    events, wall_ms, _, _, lost = profiled(once, label)
    copies, rolls = copy_ops(lambda: matmul(a_h, b_h, **kw), operands)
    torch.cuda.synchronize()
    res = device_summary(events, wall_ms, label, lost=lost)
    res.update(operand_copies=copies, rolls=rolls)
    if operands:
        log(f"  {label}: copies of its operands: {copies or 'none'}; rolls "
            f"(seen by the dispatcher): {rolls or 'none'}")
    return res


def device_summary(events, wall_ms: float, label: str, top_n: int = 8,
                   lost=None) -> dict:
    """Device time by kernel of ``device_events`` beside the window's wall
    time: where the time goes, and the share of the wall time in which no
    kernel or copy ran on the card; neither share nor busy time where the
    trace ``lost`` a kernel (:func:`profiled`)."""
    spans, by_name = [], {}
    for name, start, end in events:
        spans.append((start, end))
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    measured = bool(spans) and not lost
    res = {"wall_ms": wall_ms,
           "device_busy_ms": busy_ms if measured else None,
           "idle_share": 1.0 - busy_ms / wall_ms if measured else None,
           "by_kernel_ms": {k: round(v[0], 3) for k, v in top},
           "launches_by_kernel": {k: v[1] for k, v in top},
           "kernels": sorted(by_name), "trace_lost": lost or {}}
    if lost:
        log(f"  {label}: wall {wall_ms:.2f} ms; the profiler's trace lost "
            f"kernels in every try ({lost}: in the trace, launched), so "
            f"device busy time and idle share are not measured; it holds:")
        for k, (ms, n) in top:
            log(f"    {ms:9.3f} ms  {n:4d}x  {k}")
    elif spans:
        log(f"  {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
            f"(idle share {res['idle_share']:.3f})")
        for k, (ms, n) in top:
            log(f"    {ms:9.3f} ms  {n:4d}x  {k}")
    else:
        log(f"  {label}: wall {wall_ms:.2f} ms; the profiler recorded no "
            "device time (idle share not measured)")
    return res


def b1_yardsticks(blocks, rows, cols, dense, nbr: int, real, tol: float,
                  label: str, timer=None) -> dict:
    """Two PyTorch calls computing B1's product of the same real blocks
    (the ``real`` bool ``[T, S]``), as block-diagonal matrices over the T
    tiles, timed only (the port never calls them): cuSPARSE BSR @ dense
    (``torch.sparse_bsr_tensor``) and, as B2's yardstick works, CSR @
    dense on the element nonzeros (``torch.sparse_csr_tensor``).  Each is
    held against the plain version first; None, with the reason printed,
    where PyTorch has no such call for these operands."""
    from repro_torch.kernels import ref
    t, s, bs, _ = blocks.shape
    k, n = dense.shape[1], dense.shape[2]
    mask = torch.as_tensor(np.asarray(real), device=blocks.device)
    tile = torch.arange(t, device=blocks.device)[:, None].expand(t, s)[mask]
    r_real = rows[mask].long() + tile * nbr     # stored lists are row-sorted
    c_real = cols[mask].long() + tile * (k // bs)
    b_real = blocks[mask]
    d = dense.reshape(t * k, n)
    want = ref.bsr_spmm_raw_ref(blocks, rows, cols, dense, nbr)
    scale = abs_product(blocks, rows, cols, dense, nbr)
    step = BF16_STEP if blocks.dtype == torch.bfloat16 else 0.0
    res = {}
    crow = torch.searchsorted(r_real, torch.arange(
        t * nbr + 1, device=blocks.device)).to(torch.int32)
    bsr = torch.sparse_bsr_tensor(crow, c_real.to(torch.int32), b_real,
                                  size=(t * nbr * bs, t * k))
    sb, rr, cc = b_real.nonzero().unbind(1)
    csr = torch.sparse_coo_tensor(
        torch.stack([r_real[sb] * bs + rr, c_real[sb] * bs + cc]),
        b_real[sb, rr, cc], size=(t * nbr * bs, t * k)).coalesce()
    csr = csr.to_sparse_csr()
    for name, a in (("library_bsr_ms", bsr), ("library_ms", csr)):
        what = "torch.sparse_bsr_tensor" if name == "library_bsr_ms" \
            else "torch.sparse_csr_tensor"
        try:
            got = (a @ d).reshape(t, nbr * bs, n)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            log(f"  yardstick {label}: {what} @ dense, no library call "
                f"({type(e).__name__}: {str(e).splitlines()[0][:160]})")
            res[name] = None
            continue
        # a library may sum bf16 products at bf16 precision: it is held
        # to 2^-7 of |A| @ |B|, which still tells another function apart
        err, share, ok = compare(got, want, scale,
                                 max(tol, 2 * BF16_ROUND) if step else tol,
                                 step)
        del got
        check(ok, f"the yardstick {what} @ dense computes another function "
              f"(max_abs_err {err:.3e}, {share:.3g} of its allowance)")
        res[name] = (timer or time_ms)(lambda: a @ d, 5)
        log(f"  yardstick {label}: {what} @ dense {res[name]:.3f} ms "
            f"({a.values().shape[0]} "
            f"{'blocks' if a.layout == torch.sparse_bsr else 'nonzeros'}), "
            f"max_abs_err {err:.3e} vs the plain version, {share:.3g} of "
            f"its allowance")
    return res


# ---------------------------------------------------------------------------
# launch counts, memory, exact checks
# ---------------------------------------------------------------------------
def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the kernel's name."""
    from repro_torch.kernels.bsr_pair import (bsr_pair_accumulate_cuda,
                                              bsr_pair_matmul_cuda)
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    return {"bsr_spmm": bsr_spmm_cuda,
            "bsr_pair_accumulate": bsr_pair_accumulate_cuda,
            "bsr_pair_matmul": bsr_pair_matmul_cuda}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "paths"):
            fn.paths = dict.fromkeys(fn.paths, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def traced_counts() -> dict:
    """The launch counts :data:`TRACED_KERNELS` names: B1's by path
    (``bsr_spmm_cuda.paths``), B2's and B3's by wrapper."""
    counts = read_counts()
    paths = kernel_wrappers()["bsr_spmm"].paths
    return {"bsr_spmm.blocks": paths["blocks"],
            "bsr_spmm.elements": paths["elements"],
            "bsr_spmm.sparse_b": paths["sparse_b"],
            "bsr_pair_accumulate": counts["bsr_pair_accumulate"],
            "bsr_pair_matmul": counts["bsr_pair_matmul"]}


def phase_peak(label: str) -> float:
    """Print the peak device memory since the last call, and reset it."""
    torch.cuda.synchronize()
    gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory, {label}: {gb:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    return gb


def free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def compare_tiles(got, want, scale, tol: float, step: float = 0.0):
    """:func:`compare` one tile at a time along dim 0, which bounds the
    temporaries at the sparse path's 1.9 GB tiles."""
    err = share = 0.0
    ok = True
    for i in range(got.shape[0]):
        e, sh, o = compare(got[i], want[i], scale[i], tol, step)
        err, share, ok = max(err, e), max(share, sh), ok and o
    return err, share, ok


def rmat_csr(cfg: dict):
    """scipy CSR of ``rmat_matrix(cfg)`` (1.0 on each distinct edge), from
    the edge list, as float64."""
    import scipy.sparse as sp
    from repro_torch.core.bsr import rmat_edges
    n = 1 << cfg["scale"]
    e = np.unique(rmat_edges(cfg["scale"], cfg["edgefactor"],
                             seed=cfg["seed"]), axis=0)
    return sp.csr_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))


def check_sparse_exact(c_h, sym, oracle, label: str) -> None:
    """C (a DistBSR from the plan of ``sym``) against a scipy product with
    nonnegative integer values, for equality: every nonzero of the oracle
    lies in a real (predicted) block of C with the same value, and C has
    no other nonzero element."""
    t = c_h.tiled
    dev, g, bs = t.device, c_h.g, c_h.block_size
    nbr, nbc = sym.tile_nbr, sym.tile_nbc
    lookup = torch.full((g, g, nbr * nbc), -1, dtype=torch.int64, device=dev)
    gi, gj, slot = (torch.as_tensor(x, device=dev)
                    for x in np.nonzero(sym.c_real))
    pos = (t.rows[gi, gj, slot].long() * nbc + t.cols[gi, gj, slot].long())
    lookup[gi, gj, pos] = slot
    coo = oracle.tocoo()
    r = torch.as_tensor(coo.row, device=dev).long()
    c = torch.as_tensor(coo.col, device=dev).long()
    v = torch.as_tensor(coo.data, device=dev)
    br, bc = r // bs, c // bs
    ti, tj = br // nbr, bc // nbc
    s_of = lookup[ti, tj, (br % nbr) * nbc + bc % nbc]
    check(bool((s_of >= 0).all()), f"{label}: an oracle nonzero lies "
          "outside C's predicted blocks")
    got = t.blocks[ti, tj, s_of, r % bs, c % bs].double()
    err = (got - v).abs().max().item() if v.numel() else 0.0
    nnz = int(torch.count_nonzero(t.blocks).item())
    ok = err == 0 and nnz == coo.nnz
    log(f"  {label}: {coo.nnz} oracle nonzeros, C holds {nnz} nonzero "
        f"elements in {int(sym.c_counts.sum())} real blocks, max |C - "
        f"oracle| {err:g} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{label} differs from scipy's product")


# ---------------------------------------------------------------------------
# the pair kernels: B2 (bsr_pair_accumulate) and B3 (bsr_pair_matmul)
# ---------------------------------------------------------------------------
def ring_step_pairs(t_a, t_b, step: int = 0):
    """A @ B's sparse-output ring step on the stacked grid (padded wire):
    the stacked stored tiles ``[g*g, S, bs, bs]`` that position (i, j)
    holds, A[i, k] and B[k, j] with k = (i + j + step) % g, the step's
    ``[g*g, P]`` pair lists and their plan-time real mask, as plan_matmul
    schedules them."""
    from repro_torch.core.symbolic import symbolic_spgemm
    g, bs = t_a.grid_shape[0], t_a.block_size
    sym = symbolic_spgemm(t_a, t_b)
    sched = sym.scheduled_pairs(lambda i, j, t, g: (i + j + t) % g)
    ii = torch.arange(g, device=t_a.device)[:, None]
    jj = torch.arange(g, device=t_a.device)[None, :]
    k = (ii + jj + step) % g
    a = t_a.blocks[ii, k].reshape(g * g, -1, bs, bs).contiguous()
    b = t_b.blocks[k, jj].reshape(g * g, -1, bs, bs).contiguous()
    lists = [torch.from_numpy(np.ascontiguousarray(
        sched[x][:, :, step].reshape(g * g, -1))).to(t_a.device)
        for x in ("pa", "pb", "ps")]
    real = sched["real"][:, :, step].reshape(g * g, -1)
    return a, b, lists, sym.store_capacity, real


def pair_bound(a, b, pa, pb, index_bytes: int, out_bytes: int) -> dict:
    """Least time for one pair-kernel call: each input read once, the
    output written once, and the flops of the pairs whose two blocks both
    hold data."""
    t, bs = a.shape[0], a.shape[-1]
    tile = torch.arange(t, device=a.device)[:, None]
    a_nz = (a != 0).flatten(2).any(dim=2)
    b_nz = (b != 0).flatten(2).any(dim=2)
    real = int((a_nz[tile, pa.long()] & b_nz[tile, pb.long()]).sum().item())
    inputs = [a] if b.data_ptr() == a.data_ptr() else [a, b]
    nbytes = sum(x.numel() * x.element_size() for x in inputs) \
        + index_bytes + out_bytes
    flops = 2 * real * bs ** 3
    peak_bytes, peak_ops = peaks()
    t_bytes = nbytes / peak_bytes * 1e3
    t_ops = flops / peak_ops[a.dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "real_pairs": real, "pairs": pa.numel(),
            "real_flops": flops, "pair_flops": 2 * pa.numel() * bs ** 3}


def counted(fn, wrapper):
    """``fn()`` with ``wrapper``'s pair counter on: (its result, the pairs
    that the kernel's launches in it multiplied, counted on the card)."""
    counter = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    wrapper.pair_counter = counter
    try:
        out = fn()
    finally:
        wrapper.pair_counter = None
    torch.cuda.synchronize()
    return out, int(counter.item())


def pair_acc_case(a, b, pa, pb, ps, n_slots: int, label: str, real,
                  table=None, reps: int = 0, tol: float = TOL_F32_SMALL,
                  chunk=None, timer=None) -> dict:
    """B2 (fresh output) against its plain version on the same inputs
    (float32 output, so ``tol`` alone), the pairs it multiplied against
    the real ones; timed when ``reps``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_pair import (CHUNK, bsr_pair_accumulate_cuda,
                                              kernel_path, pair_table)
    table = table or pair_table(ps, n_slots, real=real,
                                chunk=chunk or CHUNK, device=a.device)
    got, multiplied = counted(
        lambda: bsr_pair_accumulate_cuda(a, b, pa, pb, table),
        bsr_pair_accumulate_cuda)
    want = ref.bsr_pair_accumulate_raw_ref(a, b, pa, pb, ps, n_slots)
    scale = ref.bsr_pair_accumulate_raw_ref(a.abs(), b.abs(), pa, pb, ps,
                                            n_slots)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"B2 {label}: non-finite output")
    err, share, ok = compare_tiles(got, want, scale, tol)
    del want, scale
    n_real = int(np.asarray(real).sum())
    path = kernel_path(a.shape[-1], a.dtype)
    log(f"  B2 {label} [{path}]: T={a.shape[0]} P={pa.shape[1]} "
        f"slots={n_slots}, {table.chunks.shape[1]} chunks, "
        f"{table.reduce.shape[1]} segments in partials, workspace "
        f"{table.workspace_bytes(a.shape[-1]) / 1e6:.2f} MB; multiplied "
        f"{multiplied} pairs, {n_real} real of {pa.numel()}: max_abs_err "
        f"{err:.3e}, {share:.3g} of its allowance {'ok' if ok else 'MISMATCH'}")
    check(ok, f"B2 {label} disagrees with its plain version")
    check(multiplied == n_real == table.real_pairs,
          f"B2 {label} multiplied {multiplied} pairs, not the {n_real} real")
    res = {"max_abs_err": err, "share_of_tolerance": share, "path": path,
           "pairs_multiplied": multiplied, "n_parts": table.n_parts,
           "workspace_bytes": table.workspace_bytes(a.shape[-1])}
    if reps:
        timer = timer or time_ms
        res["ms"] = timer(lambda: bsr_pair_accumulate_cuda(
            a, b, pa, pb, table), reps)
        res["plain_ms"] = timer(lambda: ref.bsr_pair_accumulate_raw_ref(
            a, b, pa, pb, ps, n_slots), max(1, reps // 4))
        res.update(pair_bound(a, b, pa, pb, 3 * pa.numel() * 4,
                              got.numel() * 4))
        log(f"  B2 {label}: {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} "
            f"ms, bound {res['bound_ms']:.3f} ms ({res['bound_by']}); "
            f"{res['real_pairs']} of {res['pairs']} pairs real, "
            f"{multiplied} multiplied")
    return res


def pair_acc_carry_case(a, b, pa, pb, ps, n_slots: int, label: str, real,
                        table, reps: int) -> dict:
    """B2 accumulating into a float32 carry in place: carry + the step's
    sums on the slots the real pairs visit, every other slot bit-identical;
    timed (each timed launch adds into the same carry)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_pair import bsr_pair_accumulate_cuda
    t, bs = a.shape[0], a.shape[-1]
    gen = torch.Generator(device=a.device).manual_seed(7)
    carry = torch.randint(0, 4, (t, n_slots, bs, bs), generator=gen,
                          device=a.device).float()
    before = carry.clone()
    _, multiplied = counted(
        lambda: bsr_pair_accumulate_cuda(a, b, pa, pb, table, out=carry),
        bsr_pair_accumulate_cuda)
    want = ref.bsr_pair_accumulate_raw_ref(a, b, pa, pb, ps, n_slots)
    scale = ref.bsr_pair_accumulate_raw_ref(a.abs(), b.abs(), pa, pb, ps,
                                            n_slots)
    visited = torch.zeros((t, n_slots), dtype=torch.bool, device=a.device)
    tile = torch.arange(t, device=a.device)[:, None].expand_as(ps)
    mask = torch.as_tensor(np.asarray(real), device=a.device)
    visited[tile[mask], ps[mask].long()] = True
    untouched = bool(torch.equal(carry[~visited], before[~visited]))
    want += before
    scale += before.abs()
    err, share, ok = compare_tiles(carry, want, scale, TOL_F32_SMALL)
    del want, scale, before
    n_real = int(np.asarray(real).sum())
    log(f"  B2 {label}: {int(visited.sum())} of {t * n_slots} slots visited; "
        f"multiplied {multiplied} pairs, {n_real} real: max_abs_err "
        f"{err:.3e}, {share:.3g} of its allowance, other slots "
        f"{'untouched' if untouched else 'CHANGED'}")
    check(ok and untouched, f"B2 {label} is not carry + the step's sums")
    check(multiplied == n_real, f"B2 {label} multiplied {multiplied} pairs, "
          f"not the {n_real} real")
    n_visited = int(visited.sum())
    del visited
    res = {"max_abs_err": err, "pairs_multiplied": multiplied,
           "visited_slots": n_visited}
    res["ms"] = time_ms(lambda: bsr_pair_accumulate_cuda(
        a, b, pa, pb, table, out=carry), reps)
    # the carry's visited slots are read and written once
    res.update(pair_bound(a, b, pa, pb, 3 * pa.numel() * 4,
                          2 * n_visited * bs * bs * 4))
    log(f"  B2 {label}: {res['ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']})")
    del carry
    return res


def pair_mm_case(blocks, lists, nbr: int, label: str, table=None,
                 reps: int = 0, tol: float = TOL_F32_SMALL) -> dict:
    """B3 (one tile, A @ A through build_pair_lists' lists) against its
    plain version, the pairs it multiplied against the real ones (not both
    on the appended zero slot); timed when ``reps``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_pair import (bsr_pair_matmul_cuda,
                                              kernel_path, pair_table)
    bs, zero = blocks.shape[-1], blocks.shape[0]
    ext = torch.cat([blocks, blocks.new_zeros((1, bs, bs))])[None]
    pa, pb, pr, pc = (x[None] for x in lists)
    real = ((pa != zero) | (pb != zero)).cpu().numpy()
    table = table or pair_table(pr.long() * nbr + pc.long(), nbr * nbr,
                                real=real, device=blocks.device)
    got, multiplied = counted(
        lambda: bsr_pair_matmul_cuda(ext, ext, pa, pb, table,
                                     n_block_rows=nbr, n_block_cols=nbr),
        bsr_pair_matmul_cuda)
    got = got.to(blocks.dtype)
    want = ref.bsr_pair_matmul_raw_ref(ext, ext, pa, pb, pr, pc, nbr, nbr)
    scale = ref.bsr_pair_matmul_raw_ref(ext.abs(), ext.abs(), pa, pb, pr,
                                        pc, nbr, nbr,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"B3 {label}: non-finite output")
    step = BF16_STEP if blocks.dtype == torch.bfloat16 else 0.0
    err, share, ok = compare(got, want, scale, tol, step)
    del want, scale
    path = kernel_path(bs, blocks.dtype)
    log(f"  B3 {label} [{path}]: P={pa.shape[1]}, {table.chunks.shape[1]} "
        f"chunks; multiplied {multiplied} pairs, {int(real.sum())} real: "
        f"max_abs_err {err:.3e}, {share:.3g} of its allowance "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"B3 {label} disagrees with its plain version")
    check(multiplied == int(real.sum()) == table.real_pairs,
          f"B3 {label} multiplied {multiplied} pairs, not the real ones")
    res = {"max_abs_err": err, "share_of_tolerance": share, "path": path,
           "pairs_multiplied": multiplied}
    if reps:
        res["ms"] = time_ms(lambda: bsr_pair_matmul_cuda(
            ext, ext, pa, pb, table, n_block_rows=nbr, n_block_cols=nbr),
            reps)
        res["plain_ms"] = time_ms(lambda: ref.bsr_pair_matmul_raw_ref(
            ext, ext, pa, pb, pr, pc, nbr, nbr), max(1, reps // 4))
        res.update(pair_bound(ext, ext, pa, pb, 4 * pa.numel() * 4,
                              got.numel() * 4))
        log(f"  B3 {label}: {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} "
            f"ms, bound {res['bound_ms']:.3f} ms ({res['bound_by']}); "
            f"{res['real_pairs']} of {res['pairs']} pairs real, "
            f"{multiplied} multiplied")
    return res


def pair_small_cases(device) -> None:
    """B2 and B3 at small block sizes in float32 and bf16 (the SIMT variant
    and, for bf16 at multiples of 16, the tensor cores; bs 24 ragged):
    a hub block-row and block-column make one tile's lists long, cut into
    chunks of 4 so that those segments store partials."""
    from repro_torch.core.bsr import BSR, TiledBSR, random_sparse
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.kernels import ops
    for bs in PAIR_SMALL_BS:
        for dtype in (torch.float32, torch.bfloat16):
            a = random_sparse(28 * bs, 28 * bs, 0.02, seed=bs)
            a[:bs] += random_sparse(bs, 28 * bs, 0.9, seed=bs + 1)
            a[:, :bs] += random_sparse(28 * bs, bs, 0.9, seed=bs + 2)
            t = TiledBSR.from_dense(a, ProcessGrid(2, 2), bs, dtype=dtype,
                                    device=device)
            blocks_a, blocks_b, lists, n_slots, real = ring_step_pairs(t, t)
            res = pair_acc_case(blocks_a, blocks_b, *lists, n_slots,
                                f"bs={bs} {str(dtype)[6:]}", real, chunk=4)
            check(res["n_parts"] > 0,
                  f"B2 bs={bs}: no segment several chunks long")
            flat = BSR.from_dense(a, bs, dtype=dtype, device=device)
            nbr = flat.n_block_rows
            pl = [torch.from_numpy(x).to(device)
                  for x in ops.build_pair_lists(
                      flat.rows, flat.cols, flat.nnzb, flat.rows, flat.cols,
                      flat.nnzb, nbr, nbr)[:4]]
            pair_mm_case(flat.blocks, pl, nbr, f"bs={bs} {str(dtype)[6:]}")


def blockdiag_csr(t, tiles):
    """Block-diagonal element CSR of the listed tiles of a TiledBSR."""
    bs = t.block_size
    tm, tn = t.tile_shape
    idx, vals = [], []
    for n, (i, j) in enumerate(tiles):
        s_, r_, c_ = t.blocks[i, j].nonzero().unbind(1)
        idx.append(torch.stack([n * tm + t.rows[i, j][s_].long() * bs + r_,
                                n * tn + t.cols[i, j][s_].long() * bs + c_]))
        vals.append(t.blocks[i, j][s_, r_, c_])
    coo = torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals),
                                  size=(len(tiles) * tm, len(tiles) * tn))
    return coo.coalesce().to_sparse_csr()


def csr_yardstick(a_csr, b_csr, want_sum: float, label: str,
                  rel: Optional[float] = None):
    """Time cuSPARSE ``CSR @ CSR`` (timed only; the port never calls it),
    after checking that it sums to the kernel's total (within ``rel`` of
    it: by default 1e-6 for float32, whose exact values here sum exactly,
    one bf16 step for bf16).  None, with the reason printed, where PyTorch
    has no such call for these operands."""
    try:
        c = a_csr @ b_csr
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"  yardstick {label}: no library call ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:160]})")
        return None
    total = c.values().double().sum().item()
    # a bf16 product rounds each output element to 8 bits
    if rel is None:
        rel = 1e-6 if c.dtype == torch.float32 else 2.0 ** -7
    check(abs(total - want_sum) <= rel * max(1.0, abs(want_sum)),
          f"yardstick {label} computes another function ({total} vs "
          f"{want_sum})")
    del c
    ms = time_ms(lambda: a_csr @ b_csr, 5)
    log(f"  yardstick {label}: torch CSR @ CSR (cuSPARSE) {ms:.3f} ms, "
        f"{a_csr._nnz()} x {b_csr._nnz()} nonzeros")
    return ms


def square_handle(device):
    """The square cell's A (:data:`SQUARE`) as a handle on ``device``, its
    values standard normal (seeded), tiled from a dense matrix made on the
    card and freed."""
    from repro_torch.core.api import DistBSR
    from repro_torch.core.bsr import rmat_edges
    cfg = SQUARE
    n = 1 << cfg["scale"]
    e = rmat_edges(cfg["scale"], cfg["edgefactor"], seed=cfg["seed"])
    e = np.unique(np.random.default_rng(cfg["seed"] + 1).permutation(n)[e],
                  axis=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg["seed"])
    dense = torch.zeros((n, n), device=device)
    dense[torch.as_tensor(e[:, 0], device=device),
          torch.as_tensor(e[:, 1], device=device)] = torch.randn(
              len(e), generator=gen, device=device)
    a_h = DistBSR.from_dense(dense, g=cfg["g"],
                             block_size=cfg["block_size"], device=device)
    del dense
    free()
    return a_h, len(e)


def sparse_b_square(device) -> dict:
    """B1's sparse-B path at the square cell's shape (R-MAT scale 16
    relabelled, bs 32, T 4, K = n = 32,768 a tile): each ring step's launch
    against its plain version (fresh, tile by tile; NaN-free), the blocks
    it credits against its table's; the launch timed fresh and into C, its
    bound (a fresh C written once, or the 32-byte sectors that hold the
    positions its sums reach read and written once; both lists, B's window
    offsets, the units and zero rows read once; two flops a product), the
    plain version's time and
    cuSPARSE's ``CSR @ CSR`` of the step's tiles as a yardstick; then one
    ``matmul`` counted by path.  Returns the kernels-line entry."""
    from repro_torch.core.api import NATURAL, matmul, plan_matmul
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    a_h, nnz = square_handle(device)
    g, bs = SQUARE["g"], SQUARE["block_size"]
    plan = plan_matmul(a_h, a_h, algorithm="ring_c", output="dense")
    ex = plan.executor
    # A's natural stacks, read as A and as B through the launch maps
    placed = [ex.batch(a_h.placed(NATURAL)[k])
              for k in ("blocks", "rows", "cols")] * 2
    nbr = a_h.tile_shape[0] // bs
    log(f"  square: {nnz} nonzeros, fill {100 * a_h.tiled.fill():.4f} %, "
        f"real blocks {a_h.counts.cpu().numpy().ravel().tolist()}")
    reset_counts()
    res = {}
    for step, ((a_map, b_map),) in enumerate(plan.launch_maps()):
        table = plan.sparse_b_table(a_h, a_h, a_map, b_map)
        check(table is not None and table.path == "sparse_b",
              "the square's step takes no sparse-B table")
        sb = table.sparse_b
        pools = (placed[0], placed[3])
        got, multiplied = counted_blocks(
            lambda: bsr_spmm_cuda(*pools, table))
        check(multiplied == table.real_blocks,
              f"square step {step}: credited {multiplied} blocks, the "
              f"table's real ones {table.real_blocks}")
        check(bool(torch.isfinite(got).all()),
              f"square step {step}: non-finite output")
        err = share = 0.0
        ok = True
        for t in range(got.shape[0]):
            ai = torch.as_tensor(a_map[t:t + 1], device=device)
            bi = torch.as_tensor(b_map[t:t + 1], device=device)
            a = [x[ai] for x in placed[:3]]
            b = [x[bi] for x in placed[3:]]
            want = ref.bsr_spmm_sparse_b_raw_ref(*a, *b, nbr, nbr)
            scale = ref.bsr_spmm_sparse_b_raw_ref(a[0].abs(), *a[1:],
                                                  b[0].abs(), *b[1:], nbr,
                                                  nbr)
            e, sh, o = compare(got[t:t + 1], want, scale, TOL_F32_SMALL)
            err, share, ok = max(err, e), max(share, sh), ok and o
            del want, scale
        check(ok, f"square step {step}: the sparse-B path disagrees with "
              f"its plain version ({share:.3g} of the allowance)")
        reached = int(torch.count_nonzero(got))
        # the 32-byte sectors (8 float32) that a later step reads and writes
        sectors = int(got.view(-1, 8).ne(0).any(-1).sum())
        total = got.double().sum().item()
        ms = time_ms(lambda: bsr_spmm_cuda(*pools, table), 5)
        acc_ms = time_ms(lambda: bsr_spmm_cuda(*pools, table, out=got), 5)
        del got
        free()
        plain_ms = time_ms(lambda: ref.bsr_spmm_sparse_b_raw_ref(
            placed[0][a_map], *[x[a_map] for x in placed[1:3]],
            placed[3][b_map], *[x[b_map] for x in placed[4:]], nbr, nbr),
            1, warmup=0)
        free()
        al, bl = sb.a_lists, sb.b_lists
        lists = sum(x.n_elements * (4 + 8 + 4) for x in (al, bl)) \
            + sum(x.rowptr.numel() * 8 for x in (al, bl))
        tables = sum(x.numel() * 4 for x in (sb.windows, sb.units,
                                             sb.zero_rows))
        c_bytes = table.tiles * nbr * bs * sb.n * 4
        peak_bytes, peak_ops = peaks()
        flops = 2 * sb.n_products
        t_ops = flops / peak_ops[torch.float32] * 1e3
        bound = max((c_bytes + lists + tables) / peak_bytes * 1e3, t_ops)
        acc_bound = max((2 * sectors * 32 + lists + tables) / peak_bytes
                        * 1e3, t_ops)
        lib = csr_yardstick(
            blockdiag_csr(a_h.tiled, [divmod(int(p), g) for p in a_map]),
            blockdiag_csr(a_h.tiled, [divmod(int(p), g) for p in b_map]),
            total, f"square step {step}", rel=1e-4)
        free()
        res[step] = {"ms": ms, "accumulate_ms": acc_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "accumulate_bound_ms": acc_bound,
                     "share_of_bound": bound / ms,
                     "accumulate_share_of_bound": acc_bound / acc_ms,
                     "library_ms": lib, "max_abs_err": err,
                     "share_of_tolerance": share, "products": sb.n_products,
                     "reached": reached, "sectors": sectors,
                     "units": int(sb.units.shape[1]),
                     "zero_rows": int(sb.zero_rows.numel())}
        log(f"  B1 sparse-B square step {step}: fresh {ms:.3f} ms (bound "
            f"{bound:.3f} ms, {100 * bound / ms:.1f} %), into C "
            f"{acc_ms:.3f} ms (bound {acc_bound:.3f} ms, "
            f"{100 * acc_bound / acc_ms:.1f} %), plain {plain_ms:.1f} ms, "
            f"cuSPARSE CSR @ CSR {lib} ms; {sb.n_products} products, "
            f"{reached} positions reached in {sectors} sectors, "
            f"{sb.units.shape[1]} units; "
            f"max_abs_err {err:.3e}, {share:.3g} of its allowance")
    before = dict(bsr_spmm_cuda.paths)
    out = matmul(a_h, a_h, algorithm="ring_c", output="dense")
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in bsr_spmm_cuda.paths.items()}
    check(ran == {"elements": 0, "blocks": 0, "sparse_b": g},
          f"the square's multiply launched B1 by path {ran}")
    del out
    launches = bsr_spmm_cuda.launches
    del a_h, placed, plan
    free()
    first = res[0]
    return {"name": "bsr_spmm (square cell shape, sparse-B path)",
            "route": "cuda", "source":
            "src/repro_torch/kernels/csrc/bsr_spmm.cu",
            "replaces": "none: B1 gains a path (bsr_spmm_pallas densifies "
            "B)", "launches": launches, "dtype": "float32",
            "shape": {"T": 4, "K": nbr * bs, "n": nbr * bs, "bs": bs},
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "library_ms",
                                     "share_of_bound", "accumulate_ms",
                                     "accumulate_bound_ms",
                                     "accumulate_share_of_bound",
                                     "products", "reached", "sectors")},
            "bound_by": "bytes", "steps": res}


def sparse_path(device) -> dict:
    """The sparse-output path at full width: R-MAT scale 16 A @ A with
    output="auto" (a sparse C over the packed wire), B2 at its step-0
    shapes, the multiply's time and breakdown, and C against scipy."""
    from repro_torch.core import api
    from repro_torch.core.api import NATURAL, DistBSR, matmul, plan_matmul
    from repro_torch.core.bsr import rmat_matrix
    from repro_torch.obs import sync_elapsed
    cfg = SPARSE
    t0 = time.perf_counter()
    a_np = rmat_matrix(cfg["scale"], cfg["edgefactor"], seed=cfg["seed"])
    a_h = DistBSR.from_dense(a_np, g=cfg["g"], block_size=cfg["block_size"],
                             device=device)
    del a_np
    a_csr = rmat_csr(cfg)
    oracle = a_csr @ a_csr
    torch.cuda.synchronize()
    log(f"sparse-output operand: R-MAT scale {cfg['scale']}, edge factor "
        f"{cfg['edgefactor']}, bs {cfg['block_size']}, g {cfg['g']}: "
        f"{a_csr.nnz} nonzeros, real blocks per tile "
        f"{a_h.counts.cpu().numpy().ravel().tolist()}, store capacity "
        f"{a_h.tiled.store_capacity}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the cold plan: structure read, symbolic phase, pair tables
    t0 = time.perf_counter()
    sym = api._symbolic_for(a_h, a_h)
    sym_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_matmul(a_h, a_h, output="auto")
    rest_s = time.perf_counter() - t0
    check(plan.output == "sparse" and plan.wire == "packed",
          f"output='auto' resolved to output={plan.output!r}, "
          f"wire={plan.wire!r}")
    c_bytes = sym.store_capacity * sym.block_size ** 2 * 4 * sym.g ** 2
    log(f"  plan: symbolic phase {sym_s:.2f} s (cold), the rest of the plan "
        f"{rest_s:.2f} s; predicted density {sym.density():.4f}, C real "
        f"blocks per tile {sym.c_counts.ravel().tolist()}, store capacity "
        f"{sym.store_capacity}, C store {c_bytes / 1e9:.2f} GB float32, "
        f"pair capacity {sym.pair_capacity}, real pairs "
        f"{sym.total_real_pairs()}, {sym.flops() / 1e9:.1f} GFLOP; kernel "
        f"workspace {plan.workspace_bytes() / 1e6:.2f} MB a step")
    # B2 at the step-0 shapes of this path (fresh output), and at step 1's
    # (into the carry)
    g, bs = a_h.g, a_h.block_size
    real = sym.scheduled_pairs(plan.algorithm.k_order)["real"]
    real = [real[:, :, t].reshape(g * g, -1) for t in range(g)]
    # each step's A and B tiles, gathered from the natural packed stack
    # through the step's launch maps, as the sparse-output body reads them
    nat = a_h.packed_wire(NATURAL)["blocks"].reshape(g * g, -1, bs, bs)
    maps = plan.launch_maps()

    def tiles(t):
        return [nat.index_select(0, torch.as_tensor(m, device=nat.device))
                for m in maps[t][0]]

    a0, b0 = tiles(0)
    st = plan._pairs[0]
    kres = {torch.float32: pair_acc_case(
        a0, b0, st["pa"], st["pb"], st["ps"], sym.store_capacity,
        "main-path step 0 float32", real[0], table=st["table"], reps=5)}
    a16, b16 = a0.bfloat16(), b0.bfloat16()        # R-MAT 1.0 is exact
    kres[torch.bfloat16] = pair_acc_case(
        a16, b16, st["pa"], st["pb"], st["ps"], sym.store_capacity,
        "main-path step 0 bf16", real[0], table=st["table"], reps=5)
    del a16, b16
    free()
    a1, b1 = tiles(1)
    st1 = plan._pairs[1]
    carry_res = {}
    for dtype in (torch.float32, torch.bfloat16):
        carry_res[dtype] = pair_acc_carry_case(
            a1.to(dtype), b1.to(dtype), st1["pa"], st1["pb"], st1["ps"],
            sym.store_capacity, f"main-path step 1 into the carry "
            f"{str(dtype)[6:]}", real[1], st1["table"], reps=5)
        free()
    del a1, b1
    ii = np.arange(g)[:, None]
    jj = np.arange(g)[None, :]
    k = (ii + jj) % g
    tiles_a = list(zip(ii.repeat(g, 1).ravel(), k.ravel()))
    tiles_b = list(zip(k.ravel(), jj.repeat(g, 0).ravel()))
    csr_a = blockdiag_csr(a_h.tiled, tiles_a)
    csr_b = blockdiag_csr(a_h.tiled, tiles_b)
    want_sum = ops_sum(a0, b0, st)
    for dtype in (torch.float32, torch.bfloat16):
        kres[dtype]["library_ms"] = csr_yardstick(
            csr_a.to(dtype), csr_b.to(dtype), want_sum,
            f"B2 step 0 {str(dtype)[6:]}")
    del a0, b0, csr_a, csr_b
    free()
    phase_peak("sparse-output kernel cases")

    # the path: counts from 0, a warm-up and three timed multiplies, with
    # B2's pair counter on (one atomic add per warp; the timed runs carry
    # it too)
    from repro_torch.kernels.bsr_pair import bsr_pair_accumulate_cuda
    reset_counts()
    counter = torch.zeros(1, dtype=torch.int64, device=device)
    bsr_pair_accumulate_cuda.pair_counter = counter
    try:
        out = matmul(a_h, a_h, output="auto")
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            del out
            t0 = time.perf_counter()
            out = matmul(a_h, a_h, output="auto")
            times.append(sync_elapsed(t0, out) * 1e3)
    finally:
        bsr_pair_accumulate_cuda.pair_counter = None
    counts = read_counts()
    multiplied = int(counter.item())
    check(counts["bsr_pair_accumulate"] > 0,
          "the sparse-output path never launched bsr_pair_accumulate")
    med = statistics.median(times)
    log(f"  e2e sparse-output A @ A float32: median {med:.2f} ms of "
        f"{[round(x, 2) for x in times]}; launches {counts}")
    want_pairs = 4 * sym.total_real_pairs()
    log(f"  B2 on the path multiplied {multiplied} pairs in 4 multiplies "
        f"({counts['bsr_pair_accumulate']} launches; steps' real pairs "
        f"{[int(r.sum()) for r in real]}, "
        f"{sum(int(st_['table'].real_pairs) for st_ in plan._pairs)} in the "
        f"plan's tables); the real pairs of 4 multiplies: {want_pairs}, of "
        f"{4 * sym.g * sym.g * sym.g * sym.pair_capacity} listed")
    check(multiplied == want_pairs,
          f"B2 multiplied {multiplied} pairs on the main path, not the "
          f"{want_pairs} real ones (an inert pair was multiplied, or a "
          "real one skipped)")
    check(isinstance(out, DistBSR), "output='auto' did not give a DistBSR")
    check_sparse_exact(out, sym, oracle, "sparse-output A @ A vs scipy")
    del out
    free()
    summa = {alg: sparse_schedule_case(a_h, sym, oracle, alg)
             for alg in ("summa_bcast", "summa_ag")}
    breakdown = device_breakdown(a_h, a_h, "sparse-output A @ A float32",
                                 output="auto")
    breakdown["by_launch_ms"] = sparse_step_times(plan, a_h)
    peak = phase_peak("sparse-output path")
    return {"kernel": kres, "carry": carry_res, "a_h": a_h,
            "launches": counts["bsr_pair_accumulate"] + sum(
                v["launches"] for v in summa.values()),
            "pairs_multiplied": multiplied, "e2e_ms": med, "summa": summa,
            "symbolic_s": sym_s, "plan_rest_s": rest_s,
            "c_store_bytes": c_bytes,
            "workspace_bytes": plan.workspace_bytes(),
            "breakdown": breakdown, "peak_gb": peak}


def sparse_schedule_case(a_h, sym, oracle, algorithm: str) -> dict:
    """The sparse-output A @ A through a SUMMA schedule (output="auto",
    which resolves to a sparse C over the packed wire): counts from 0, a
    warm-up and three timed multiplies with B2's pair counter on, the pairs
    multiplied against the real ones, C against scipy for equality."""
    from repro_torch.core.api import matmul, plan_matmul
    from repro_torch.kernels.bsr_pair import bsr_pair_accumulate_cuda
    from repro_torch.obs import sync_elapsed
    plan = plan_matmul(a_h, a_h, output="auto", algorithm=algorithm)
    check(plan.output == "sparse" and plan.wire == "packed",
          f"{algorithm}: output='auto' resolved to output={plan.output!r}, "
          f"wire={plan.wire!r}")
    reset_counts()
    counter = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    bsr_pair_accumulate_cuda.pair_counter = counter
    try:
        out = matmul(a_h, a_h, output="auto", algorithm=algorithm)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            del out
            t0 = time.perf_counter()
            out = matmul(a_h, a_h, output="auto", algorithm=algorithm)
            times.append(sync_elapsed(t0, out) * 1e3)
    finally:
        bsr_pair_accumulate_cuda.pair_counter = None
    counts = read_counts()
    multiplied = int(counter.item())
    want = 4 * sym.total_real_pairs()
    med = statistics.median(times)
    log(f"  e2e sparse-output A @ A {algorithm} float32: median {med:.2f} ms "
        f"of {[round(x, 2) for x in times]} (predicted "
        f"{plan.predicted_cost() * 1e3:.4f} ms for a 2 x 2 grid of H100s); "
        f"launches {counts}; B2 multiplied {multiplied} pairs in 4 "
        f"multiplies, the real pairs: {want}")
    check(counts["bsr_pair_accumulate"] == 4 * sym.g,
          f"{algorithm}: B2 launched {counts['bsr_pair_accumulate']} times "
          f"in 4 multiplies, not {4 * sym.g}")
    check(multiplied == want, f"{algorithm}: B2 multiplied {multiplied} "
          f"pairs on the main path, not the {want} real ones")
    check(isinstance(out, type(a_h)), "output='auto' did not give a DistBSR")
    check_sparse_exact(out, plan.symbolic, oracle,
                       f"{algorithm} sparse-output A @ A vs scipy")
    del out
    free()
    return {"ms": med, "launches": counts["bsr_pair_accumulate"],
            "pairs_multiplied": multiplied,
            "predicted_ms": plan.predicted_cost() * 1e3}


def sparse_step_times(plan, a_h) -> dict:
    """CUDA-event times of one sparse-output multiply run launch by launch
    as ``_sparse_body`` runs it: each step's gathers of its A and B tiles
    through the launch maps and its B2 launch, then the cast to the output
    dtype (the profiler's trace of this path has missed launches)."""
    from repro_torch.core import api
    _, (a_tree, b_tree, pairs) = plan._operands(a_h, a_h)
    geom, ex = plan.geom, plan.executor
    a_pool, b_pool = ex.batch(a_tree["blocks"]), ex.batch(b_tree["blocks"])

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spans, c = [], None
    for t, step in enumerate(pairs):
        e0 = mark()
        a_t = {"blocks": ex.unbatch(a_pool.index_select(0, step["a_map"]))}
        b_t = {"blocks": ex.unbatch(b_pool.index_select(0, step["b_map"]))}
        e1 = mark()
        c = api._sparse_step(a_t, b_t, step, c, geom, ex)
        e2 = mark()
        spans += [(f"gathers launched at step {t}", e0, e1),
                  (f"step {t} B2", e1, e2)]
    e0 = mark()
    out = c.to(geom.out_dtype)
    spans.append(("cast to the output dtype", e0, mark()))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    res = {name: a.elapsed_time(b) for name, a, b in spans}
    res["wall_ms"] = wall
    log(f"  sparse-output A @ A launch by launch (CUDA events), wall "
        f"{wall:.2f} ms: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                       res.items() if k != "wall_ms"))
    del out, c
    return res


def ops_sum(a, b, step) -> float:
    """Sum of a B2 step's products (the plain version's, float64)."""
    from repro_torch.kernels import ref
    return ref.bsr_pair_accumulate_raw_ref(
        a, b, step["pa"], step["pb"], step["ps"],
        step["table"].n_slots).double().sum().item()


def chained_cube(device) -> dict:
    """``(A @ A) @ A`` with sparse outputs over the padded and the packed
    wire, on spgemm_bench's configuration, exactly against scipy."""
    from repro_torch.core.api import DistBSR, matmul, plan_matmul
    from repro_torch.core.bsr import rmat_matrix
    cfg = CUBE
    a_h = DistBSR.from_dense(
        rmat_matrix(cfg["scale"], cfg["edgefactor"], seed=cfg["seed"]),
        g=cfg["g"], block_size=cfg["block_size"], device=device)
    a_csr = rmat_csr(cfg)
    sq = a_csr @ a_csr
    cube = sq @ a_csr
    reset_counts()
    for wire in ("padded", "packed"):
        c2 = matmul(a_h, a_h, output="sparse", wire=wire)
        c3 = matmul(c2, a_h, output="sparse", wire=wire)
        check_sparse_exact(c2, plan_matmul(a_h, a_h, output="sparse",
                                           wire=wire).symbolic, sq,
                           f"cube {wire}: A @ A")
        check_sparse_exact(c3, plan_matmul(c2, a_h, output="sparse",
                                           wire=wire).symbolic, cube,
                           f"cube {wire}: (A @ A) @ A")
    counts = read_counts()
    log(f"  chained cube launches: {counts}")
    check(counts["bsr_pair_accumulate"] > 0,
          "the chained cube never launched bsr_pair_accumulate")
    return counts


def pair_tile_path(device) -> dict:
    """The dense-tile SpGEMM entry point ``ops.bsr_pair_matmul`` on one
    R-MAT tile (A @ A through ``ops.build_pair_lists``), against a dense
    ``torch.matmul``; then B3 against its plain version, timed."""
    from repro_torch.core.bsr import BSR, rmat_matrix
    from repro_torch.kernels import ops
    from repro_torch.kernels.bsr_pair import pair_table
    cfg = PAIR_TILE
    bs = cfg["block_size"]
    a_np = rmat_matrix(cfg["scale"], cfg["edgefactor"], seed=cfg["seed"])
    a = BSR.from_dense(a_np, bs, device=device)
    nbr = a.n_block_rows
    t0 = time.perf_counter()
    pa, pb, pr, pc, n_real = ops.build_pair_lists(
        a.rows, a.cols, a.nnzb, a.rows, a.cols, a.nnzb, nbr, nbr)
    lists = [torch.from_numpy(x).to(device) for x in (pa, pb, pr, pc)]
    real = int(((pa < a.nnzb) & (pb < a.nnzb)).sum())
    log(f"B3 tile: R-MAT scale {cfg['scale']}, edge factor "
        f"{cfg['edgefactor']}, bs {bs}: {a.nnzb} blocks, {real} real pairs "
        f"of {len(pa)} ({2 * real * bs ** 3 / 1e9:.0f} GFLOP), pair lists in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_counts()
    got = ops.bsr_pair_matmul(a.blocks, a.blocks, *lists, n_block_rows=nbr,
                              n_block_cols=nbr)
    counts = read_counts()
    dense = torch.from_numpy(a_np).to(device)
    want = dense @ dense
    check(bool(torch.equal(got, want)),
          "ops.bsr_pair_matmul differs from the dense A @ A")
    log(f"  ops.bsr_pair_matmul equals the dense A @ A ({tuple(got.shape)}); "
        f"launches {counts}")
    check(counts["bsr_pair_matmul"] > 0,
          "ops.bsr_pair_matmul never launched bsr_pair_matmul")
    del got, want
    real = ((lists[0] != a.nnzb) | (lists[1] != a.nnzb)).cpu().numpy()
    table = pair_table((lists[2].long() * nbr + lists[3].long())[None],
                       nbr * nbr, real=real[None], device=device)
    kres = {torch.float32: pair_mm_case(a.blocks, lists, nbr,
                                        "tile float32", table=table, reps=5)}
    kres[torch.bfloat16] = pair_mm_case(a.blocks.bfloat16(), lists, nbr,
                                        "tile bf16", table=table, reps=5)
    csr = dense.to_sparse_csr()
    del dense
    want_sum = float(a_np.astype(np.float64).sum(0) @ a_np.sum(1))
    for dtype in (torch.float32, torch.bfloat16):
        kres[dtype]["library_ms"] = csr_yardstick(
            csr.to(dtype), csr.to(dtype), want_sum,
            f"B3 tile {str(dtype)[6:]}")
    peak = phase_peak("dense-tile SpGEMM")
    return {"kernel": kres, "launches": counts["bsr_pair_matmul"],
            "peak_gb": peak}


def other_schedules(ops: dict) -> dict:
    """The other four schedules at the SpMM cell's full width (g 2 float32,
    g 3 for the rides that differ there, the packed wire where the schedule
    packs A) and in dense-output SpGEMM, each against the oracle with B1's
    blocks counted against its plan's tables; ``algorithm="auto"``'s choice
    and scores on the H100 preset, planned and run; then a profile of one
    SpMM per schedule, which must show no roll and no gather of a placed
    operand (ring_c_bidir's split of B into two contiguous halves is the
    one copy, timed and printed).  ``ops`` holds the operands and oracles
    of the ring_c path."""
    from repro_torch.core import api
    from repro_torch.core.roofline import H100_SXM
    a32, b32, a3, b3, a14 = (ops[k] for k in ("a32", "b32", "a3", "b3",
                                              "a14"))
    spmm = (ops["oracle32"], ops["scale32"], TOL_F32_DEEP)
    gemm = (ops["oracle_gemm"], ops["scale_gemm"], TOL_F32_SMALL)
    reset_counts()                  # counts of this path's run only
    e2e = {}
    for alg in OTHER:
        cases = [("SpMM float32 g=2", a32, b32, spmm, "auto")]
        if "a" in api.REGISTRY.get(alg).packable:
            cases.append(("SpMM float32 g=2", a32, b32, spmm, "packed"))
        if alg in OTHER_G3:
            cases.append((f"SpMM float32 g={SPMM_G3}", a3, b3, spmm, "auto"))
        cases.append(("SpGEMM float32 g=2", a14, a14, gemm, "auto"))
        for label, a_h, b_h, (oracle, scale, tol), wire in cases:
            e2e[f"{alg} {label} wire={wire}"] = e2e_case(
                label, a_h, b_h, oracle, scale, tol, "auto", wire=wire,
                algorithm=alg)
    choice, scores = api.auto_select(a32, b32, machine=H100_SXM)
    log(f"  algorithm='auto' on {H100_SXM.name} for the SpMM cell (a grid "
        f"of {a32.g ** 2} cards, as the schedules are written), over "
        f"{len(scores)} schedules: {choice}; predicted ms "
        + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in scores.items()))
    check(tuple(scores) == api.algorithms() and len(scores) == 6,
          f"auto scored {tuple(scores)}, not the six schedules")
    e2e["auto SpMM float32 g=2 wire=auto"] = auto = e2e_case(
        "SpMM float32 g=2", a32, b32, *spmm, "auto", algorithm="auto")
    check(auto["algorithm"] == choice,
          f"algorithm='auto' ran {auto['algorithm']}, not {choice}")
    counts = read_counts()
    launches = {shape: sum(v["launches"] for k, v in e2e.items()
                           if shape in k) for shape in ("SpMM", "SpGEMM")}
    log(f"  launches on the other schedules' paths: {counts} (B1: "
        f"{launches['SpMM']} at the SpMM shapes, {launches['SpGEMM']} at "
        f"SpGEMM's)")
    check(counts["bsr_spmm"] == sum(launches.values())
          and min(launches.values()) > 0,
          "the other schedules did not launch bsr_spmm at both shapes")
    log("  SpMM float32 g=2, median ms measured on one card beside the "
        "cost model's seconds for a 2 x 2 grid of H100s (a record, not a "
        "check):")
    for alg in ("ring_c",) + OTHER + ("steal3d",):
        got = e2e.get(f"{alg} SpMM float32 g=2 wire=auto") or ops[
            "steal3d" if alg == "steal3d" else "ring_c"]
        log(f"    {alg:13s} measured {got['ms']:8.3f} ms   predicted "
            f"{scores[alg] * 1e3:.4f} ms")
    breakdown = {}
    for alg in OTHER:
        bd = breakdown[alg] = device_breakdown(
            a32, b32, f"{alg} SpMM float32", algorithm=alg, operands=(
                a32.placed(api.NATURAL)["blocks"], b32.data,
                b32.placed(api.NATURAL)["dense"]))
        check(not bd["operand_copies"]
              and not bd["rolls"],
              f"{alg}: the multiply rolls or gathers an operand "
              f"({bd['operand_copies']})")
    b_pool = b32.placed(api.NATURAL)["dense"].reshape(
        a32.g ** 2, *b32.tile_shape)
    split_ms = time_ms(lambda: api._split_cols(b_pool, b32.tile_shape[1]
                                               // 2), 5)
    log(f"  ring_c_bidir's split of B into two contiguous column halves: "
        f"{split_ms:.3f} ms a multiply (CUDA events), "
        f"{b_pool.numel() * b_pool.element_size() / 1e6:.1f} MB copied")
    return {"e2e": e2e, "launches": launches, "auto": {
        "choice": choice, "scores_s": scores}, "breakdown": breakdown,
        "bidir_split_ms": split_ms}


def steal_case(label, a_h, b_h, oracle, scale, tol, overlap, wire,
               reps=3) -> dict:
    """steal3d through its plan: the plan (cold, timed), one counted
    multiply (B1's launches, 1 or 2 with overlap, and the blocks it
    multiplied against the plan's real pairs, g x A's real blocks), and the
    median of ``reps`` timed multiplies against the oracle."""
    from repro_torch.core import api
    from repro_torch.core.roofline import H100_SXM
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    from repro_torch.obs import sync_elapsed
    kw = dict(algorithm="steal3d", overlap=overlap, wire=wire)
    t0 = time.perf_counter()
    plan = api.plan_matmul(a_h, b_h, **kw)
    plan_s = time.perf_counter() - t0
    st, sp = plan._steal, plan.steal
    before = bsr_spmm_cuda.launches
    out, multiplied = counted_blocks(lambda: plan(a_h, b_h))
    per_multiply = bsr_spmm_cuda.launches - before
    want_real = a_h.g * int(a_h.counts.sum())
    asg = sp.assignment
    log(f"  steal3d {label} overlap={overlap} wire={plan.wire}: plan "
        f"{plan_s:.2f} s cold; {asg.n_moved} items moved, LPT makespan "
        f"{asg.makespan:.0f} against owner-computes {asg.owner_makespan:.0f} "
        f"real blocks; n_out {sp.n_out}, {len(st.rounds)} reduce rounds; B1 "
        f"multiplied {multiplied} blocks in {per_multiply} launches, the "
        f"plan's real pairs {st.real_pairs} (g x {int(a_h.counts.sum())} "
        f"real = {want_real}), of "
        f"{sum(s['real'].size for s in st.segments)} listed")
    check(multiplied == st.real_pairs == want_real
          and per_multiply == len(st.segments)
          == (2 if overlap == "on" else 1),
          f"steal3d {label}: B1 multiplied {multiplied} blocks in "
          f"{per_multiply} launches, not the {want_real} real pairs in "
          f"{len(st.segments)}")
    times = []
    for _ in range(reps):
        del out
        t0 = time.perf_counter()
        out = plan(a_h, b_h)
        times.append(sync_elapsed(t0, out) * 1e3)
    check(tuple(out.shape) == tuple(oracle.shape),
          f"steal3d {label}: shape {tuple(out.shape)} vs "
          f"{tuple(oracle.shape)}")
    check(bool(torch.isfinite(out).all()), f"steal3d {label}: non-finite "
          "output")
    # bf16: each partial rounds once, the overlap's second launch and each
    # reduce round once more, each by at most 2^-8 of |A| @ |B|
    if out.dtype == torch.bfloat16:
        tol += (1 + (overlap == "on") + len(st.rounds)) * BF16_ROUND
    err, share, ok = compare(out, oracle, scale, tol)
    del out
    med = statistics.median(times)
    predicted = plan.predicted_cost(H100_SXM) * 1e3
    log(f"  steal3d {label} overlap={overlap} wire={plan.wire}: median "
        f"{med:.2f} ms of {[round(x, 2) for x in times]} (the cost model "
        f"predicts {predicted:.4f} ms for a grid of {a_h.g ** 2} H100s), "
        f"max_abs_err {err:.3e}, {share:.3g} of its allowance (tol {tol:g} "
        f"x |A||B|) {'ok' if ok else 'MISMATCH'}; workspace "
        f"{plan.workspace_bytes() / 1e6:.2f} MB")
    check(ok, f"steal3d {label} overlap={overlap} wire={wire} disagrees "
          "with the dense oracle")
    res = {"ms": med, "launches": per_multiply * (1 + reps),
           "blocks_multiplied": multiplied, "real_pairs": st.real_pairs,
           "plan_s": plan_s, "predicted_ms": predicted,
           "n_moved": asg.n_moved, "n_out": sp.n_out,
           "reduce_rounds": len(st.rounds)}
    res.update(check_workspace(plan, a_h.block_size, f"steal3d {label}"))
    return res


def steal_pieces(label: str, a_h, b_h, **kw) -> dict:
    """CUDA-event times of a steal3d multiply's pieces on its plan's
    operands: the B1 launches (every device's partial tiles) and the
    reduce rounds alone; then B1 at these shapes against its plain version
    (:func:`steal_kernel_case`)."""
    from repro_torch.core import api
    plan = api.plan_matmul(a_h, b_h, algorithm="steal3d", **kw)
    st, geom, ex = plan._steal, plan.geom, plan.executor
    _, (a_tree, b_tree, _) = plan._operands(a_h, b_h)
    b_pool = api._densify_b(b_tree, geom, ex)["dense"]
    partials = lambda: api._steal3d_partials(a_tree, b_pool, st, geom, ex)
    partials_ms = time_ms(partials, 3)
    c = partials()
    reduce_ms = time_ms(lambda: api._steal3d_reduce(c, st, geom), 5)
    del c
    log(f"  steal3d {label}: B1 launches {partials_ms:.3f} ms, reduce "
        f"rounds ({len(st.rounds)}) {reduce_ms:.3f} ms (CUDA events)")
    res = {"partials_ms": partials_ms, "reduce_ms": reduce_ms}
    res.update(steal_kernel_case(label, plan, a_tree, b_pool))
    return res


def steal_kernel_case(label: str, plan, a_tree, b_pool) -> dict:
    """B1 at the shapes steal3d gives it (T = g*g devices, ``n_slots``
    output block-rows, B as one flat ``[g*g*tk, tn]`` tile, segments past
    one chunk summed through float32 partials and the reduce pass): the
    plan's launches (``api._steal3d_partials``, the second added into the
    first) against the plain version on the same card tensors
    (``ref.steal_pair_accumulate_raw_ref`` over every listed pair, dummy
    and coverage pairs on the zero block included), within
    ``TOL_F32_DEEP`` of |A| @ |B| (a bf16 output: one bf16 step more, and
    2^-8 of |A| @ |B| for each launch added into another); then the same
    with an inf, a NaN and a -inf planted in the placed B (in its first
    chunk, which the coverage pairs read, a middle chunk and the last
    tile): the NaN masks must be equal."""
    from repro_torch.core import api
    from repro_torch.kernels import ref
    st, geom, ex = plan._steal, plan.geom, plan.executor
    if not st.sparse_a:
        return {}
    blocks = a_tree["blocks"]
    pool = blocks.reshape(-1, *blocks.shape[-2:])

    def plain(b, a=pool, dtype=None):
        want = None
        for seg in st.segments:
            part = ref.steal_pair_accumulate_raw_ref(
                a, b.reshape(-1, geom.tn), seg["pa"], seg["pb"], seg["ps"],
                st.n_slots, out_dtype=dtype)
            want = part if want is None else want.add_(part)
        return want

    def against_plain(b):
        got = api._steal3d_partials(a_tree, b, st, geom, ex)
        want = plain(b)
        torch.cuda.synchronize()
        return got, want

    bf16 = torch.promote_types(pool.dtype, b_pool.dtype) == torch.bfloat16
    tol = TOL_F32_DEEP + (len(st.segments) - 1) * BF16_ROUND * bf16
    step = BF16_STEP if bf16 else 0.0
    got, want = against_plain(b_pool)
    check(got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(got).all()),
          f"steal3d {label}: B1's partials {tuple(got.shape)} {got.dtype}, "
          f"the plain version's {tuple(want.shape)} {want.dtype}")
    scale = plain(b_pool.abs(), pool.abs(), torch.float32)
    err, share, ok = compare(got, want, scale, tol, step)
    del got, want, scale
    k, n = b_pool.shape[-2:]
    bad = b_pool.clone()
    tiles = bad.view(-1, k, n)
    tiles[0, 1, 3 % n] = float("inf")
    tiles[0, k // 2 + 1, 7 % n] = float("nan")
    tiles[-1, k - 2, 11 % n] = float("-inf")
    got, want = against_plain(bad)
    nan = torch.isnan(want)
    same = bool(torch.equal(torch.isnan(got), nan))
    n_nan = int(nan.sum().item())
    keep = torch.isfinite(want)
    scale = plain(bad.nan_to_num(0.0, 0.0, 0.0).abs(), pool.abs(),
                  torch.float32)
    err_bad, share_bad, ok_bad = compare(got[keep], want[keep], scale[keep],
                                         tol, step)
    del got, want, nan, keep, scale, bad
    skipped = sum(s["table"].skip.shape[1] for s in st.segments
                  if "table" in s)
    log(f"  B1 at steal3d {label}'s shapes: T={geom.g ** 2}, n_slots "
        f"{st.n_slots}, pool {tuple(pool.shape)}, B "
        f"{(b_pool.numel() // geom.tn, geom.tn)} as one flat tile, {len(st.segments)} launches: max_abs_err "
        f"{err:.3e}, {share:.3g} of its allowance (tol {tol:g} x |A||B| + "
        f"{step:g} x |want|) {'ok' if ok else 'MISMATCH'}; on non-finite "
        f"B: {n_nan} NaN elements, NaN mask "
        f"{'equal to' if same else 'DIFFERENT FROM'} the plain version's "
        f"({skipped} skipped entries), finite values max_abs_err "
        f"{err_bad:.3e}, {share_bad:.3g} of their allowance")
    check(ok, f"steal3d {label}: B1 disagrees with its plain version")
    check(same and n_nan > 0 and ok_bad,
          f"steal3d {label}: on non-finite B, B1 gives another NaN mask or "
          "other finite values than its plain version")
    return {"kernel_max_abs_err": err, "kernel_share_of_tolerance": share,
            "nonfinite_nan_elements": n_nan, "nonfinite_skipped": skipped}


def steal3d_phase(ops: dict) -> dict:
    """steal3d on the SpMM cell (g 2: float32, bf16, the packed wire,
    overlap on; g 3, where the assignment moves items: padded, and packed
    with overlap on) and on the dense-output SpGEMM cell, each against the
    oracle; then a profile of one SpMM, which must show no roll and no
    copy of a placed operand."""
    from repro_torch.core import api
    spmm32 = (ops["oracle32"], ops["scale32"], TOL_F32_DEEP)
    spmm16 = (ops["oracle16"], ops["scale16"], TOL_F32_DEEP)
    gemm = (ops["oracle_gemm"], ops["scale_gemm"], TOL_F32_SMALL)
    a32, b32, a16, b16, a3, b3, a14 = (ops[k] for k in (
        "a32", "b32", "a16", "b16", "a3", "b3", "a14"))
    cases = (("SpMM float32 g=2", a32, b32, spmm32, "off", "auto"),
             ("SpMM bfloat16 g=2", a16, b16, spmm16, "off", "auto"),
             ("SpMM float32 g=2", a32, b32, spmm32, "off", "packed"),
             ("SpMM float32 g=2", a32, b32, spmm32, "on", "auto"),
             (f"SpMM float32 g={SPMM_G3}", a3, b3, spmm32, "off", "auto"),
             (f"SpMM float32 g={SPMM_G3}", a3, b3, spmm32, "on", "packed"),
             ("SpGEMM float32 g=2", a14, a14, gemm, "off", "auto"))
    reset_counts()                  # counts of this path's run only
    res = {}
    for label, a_h, b_h, ref_, overlap, wire in cases:
        res[f"{label} overlap={overlap} wire={wire}"] = steal_case(
            label, a_h, b_h, *ref_, overlap, wire)
        free()
    counts = read_counts()
    launches = {shape: sum(v["launches"] for k, v in res.items()
                           if k.startswith(shape)) for shape in ("SpMM",
                                                                 "SpGEMM")}
    log(f"  launches on the steal3d paths: {counts} (B1: {launches['SpMM']} "
        f"at the SpMM cell, {launches['SpGEMM']} at SpGEMM's)")
    check(counts["bsr_spmm"] == sum(launches.values())
          and min(launches.values()) > 0,
          "the steal3d paths did not launch bsr_spmm at both cells")
    for label, a_h, b_h, _, overlap, wire in cases:
        key = f"{label} overlap={overlap} wire={wire}"
        res[key].update(steal_pieces(key, a_h, b_h, overlap=overlap,
                                     wire=wire))
        free()
    breakdown = {}
    for label, a_h, b_h, kw, operands in (
            ("steal3d SpMM float32 g=2", a32, b32, {},
             (a32.placed(api.NATURAL)["blocks"],
              b32.placed(api.NATURAL)["dense"])),
            (f"steal3d SpMM float32 g={SPMM_G3} packed overlap=on", a3, b3,
             dict(wire="packed", overlap="on"),
             (a3.packed_wire(api.NATURAL)["blocks"],
              b3.placed(api.NATURAL)["dense"]))):
        bd = breakdown[label] = device_breakdown(
            a_h, b_h, label, algorithm="steal3d", operands=operands, **kw)
        check(not bd["operand_copies"]
              and not bd["rolls"],
              f"{label}: the multiply rolls or copies an operand "
              f"({bd['operand_copies']})")
    return {"e2e": res, "launches": launches, "breakdown": breakdown}


def obs_phase(a_h, b_h) -> dict:
    """Traced multiplies (``repro_torch.obs``): a fresh plan and two calls
    with tracing on (the first builds B1's tables on the host).  Prints
    the span tree and the drift records (the cost model's seconds for a
    grid of g x g H100s beside the seconds measured on this one card); an
    untraced call after them records nothing."""
    from repro_torch import obs
    from repro_torch.core import api
    obs.enable(clear=True)
    obs.reset_drift()
    plan = api.plan_matmul(a_h, b_h, algorithm="ring_c", cache=False)
    for _ in range(2):
        out = plan(a_h, b_h)
        del out
    obs.disable()
    evs = sorted(obs.events(), key=lambda e: e["ts"])
    log(f"  span tree ({len(evs)} spans):")
    for e in evs:
        log(f"    {'  ' * e['args'].get('depth', 0)}{e['name']}: "
            f"{e['dur'] / 1e3:.3f} ms")
    recs = obs.drift_records()
    for rec, when in zip(recs, ("cold", "warm")):
        log(f"  drift record ({when}): {rec['algorithm']}/{rec['wire']}/"
            f"{rec['overlap']} {rec['kind']}: predicted "
            f"{rec['predicted_s'] * 1e3:.4f} ms for {a_h.g ** 2} cards "
            f"({rec['machine']}), measured {rec['measured_s'] * 1e3:.3f} ms "
            f"on one card, ratio {rec['measured_s'] / rec['predicted_s']:.3f}")
    report = obs.drift_report()
    log(f"  drift report: {report}")
    names = [e["name"] for e in evs]
    check({"plan_build", "plan_build.executable", "multiply.ring_c"}
          <= set(names) and not obs.validate_trace(obs.export_trace()),
          f"the traced multiply recorded {names}")
    plan(a_h, b_h)
    torch.cuda.synchronize()
    check(len(recs) == 2 and len(obs.events()) == len(evs)
          and len(obs.drift_records()) == 2,
          "an untraced multiply recorded spans or drift")
    obs.reset_all()
    return {"spans": [(e["name"], e["dur"] / 1e3) for e in evs],
            "predicted_ms": recs[-1]["predicted_s"] * 1e3,
            "measured_ms": [r["measured_s"] * 1e3 for r in recs],
            "report": report}


# ---------------------------------------------------------------------------
# the serving path: OLMoE-1B-7B through ServeEngine(sparse=True)
# ---------------------------------------------------------------------------
def serve_counters_on() -> tuple:
    """B1's and B2's counters on, their table tallies at 0: (blocks, pairs)
    int64 counters on the card."""
    from repro_torch.kernels.bsr_pair import bsr_pair_accumulate_cuda as b2
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda as b1
    blocks = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    pairs = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    b1.block_counter, b1.table_blocks = blocks, 0
    b2.pair_counter, b2.table_pairs = pairs, 0
    return blocks, pairs


def serve_counters_off(blocks, pairs) -> dict:
    """Counters off: what B1 and B2 multiplied, counted on the card, beside
    the real blocks and pairs of the tables they launched."""
    from repro_torch.kernels.bsr_pair import bsr_pair_accumulate_cuda as b2
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda as b1
    b1.block_counter = b2.pair_counter = None
    torch.cuda.synchronize()
    return {"blocks_multiplied": int(blocks.item()),
            "table_blocks": b1.table_blocks,
            "pairs_multiplied": int(pairs.item()),
            "table_pairs": b2.table_pairs}


def serve_prompts(cfg) -> list:
    rng = np.random.default_rng(SERVE["seed"])
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in SERVE["prompt_lens"]]


def serve_engine(model, cfg, prompts, new_tokens=SERVE["new_tokens"], **kw):
    """A sparse ServeEngine over ``model`` with the prompts queued."""
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params=model, max_batch=SERVE["max_batch"],
                      max_len=SERVE["max_len"], sparse=True,
                      block_size=SERVE["block_size"], device=DEVICE, **kw)
    for toks in prompts:
        eng.submit(toks, max_new_tokens=new_tokens)
    return eng


def padded_prefill(model, cfg, toks):
    """``lm.prefill`` of one prompt right-padded to its bucket (the
    engine's prefill shape): (last real token's logits [1, V], caches,
    next position)."""
    from repro_torch.models import lm
    from repro_torch.serving.batcher import effective_bucket, pad_prompt
    b = effective_bucket(cfg, len(toks), SERVE["max_len"])
    padded = torch.as_tensor(pad_prompt(toks, b), device=DEVICE)[None]
    lengths = torch.tensor([len(toks)], dtype=torch.int32, device=DEVICE)
    return lm.prefill(model, {"tokens": padded}, cfg, SERVE["max_len"],
                      torch.float32, lengths)


def dense_decode(model, cfg, prompts) -> list:
    """The port's dense path one request at a time, as ``lm.greedy_decode``
    runs it but on the prompt right-padded to its bucket (the engine's
    prefill shape, ``lm.prefill(lengths=...)``): per request its tokens
    and each step's float32 logits.  The bucket matters for MoE: the
    expert capacity is a function of the padded token count (20 at 128
    tokens, 15 at 100), so at the published capacity factor an unpadded
    prefill can drop tokens that the padded one keeps, and the two are
    different functions."""
    from repro_torch.models import lm
    step = lm.make_decode_step(cfg)
    out = []
    for toks in prompts:
        logits, caches, pos = padded_prefill(model, cfg, toks)
        got, seen = [], []
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for _ in range(SERVE["new_tokens"]):
            got.append(int(tok[0, 0]))
            seen.append(logits[0])
            logits, caches = step(model, tok, caches, pos)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            pos = pos + 1
        out.append((np.asarray(got, np.int32), seen))
    return out


def match_tokens(got: np.ndarray, want: np.ndarray, logits, rid: int) -> dict:
    """The engine's tokens against the dense path's.  Where they first
    differ the dense path's top-2 logit margin must be under NEAR_TIE of
    its largest |logit| (a near-tie, printed, and the request is compared
    no further); any other difference fails the run."""
    for step in range(len(want)):
        if int(got[step]) == int(want[step]):
            continue
        lg = logits[step].float()
        top2 = lg.topk(2).values
        margin = (top2[0] - top2[1]).item() / lg.abs().max().item()
        log(f"  request {rid}: step {step} gives {int(got[step])}, the dense "
            f"path {int(want[step])}: top-2 margin {margin:.3e} of the "
            f"largest |logit| ({'near-tie, compared no further' if margin < NEAR_TIE else 'NOT a near-tie'})")
        check(margin < NEAR_TIE, f"request {rid}: the sparse engine's token "
              f"{step} differs from the dense path's away from a near-tie")
        return {"equal_steps": step, "near_tie_step": step,
                "near_tie_margin": margin}
    return {"equal_steps": len(want), "near_tie_step": None}


# a multiply's host phases: spans inside its ``multiply.<algorithm>`` span
MULTIPLY_PHASES = ("multiply.place", "multiply.body", "multiply.epilogue")


def span_totals(events, names) -> dict:
    """Total milliseconds of the obs spans named each of ``names`` (a name
    ending in "." takes every span it prefixes, a multiply's phases
    apart), and the plan-cache misses (``plan_build`` spans not served
    from the cache)."""
    tot = {n: 0.0 for n in names}
    misses = 0
    for e in events:
        for n in names:
            if e["name"] == n or (n.endswith(".")
                                  and e["name"].startswith(n)
                                  and e["name"] not in MULTIPLY_PHASES):
                tot[n] += e["dur"] / 1e3
        if e["name"] == "plan_build" and not e["args"].get("cached", True):
            misses += 1
    tot["plan_misses"] = misses
    return tot


def misses_by_request(events) -> dict:
    """Plan-cache misses inside each request's prefill span, by rid, and
    inside the decode-step spans after the first."""
    pre = [e for e in events if e["name"] == "serve.prefill"]
    steps = sorted((e for e in events if e["name"] == "serve.decode_step"),
                   key=lambda e: e["ts"])
    builds = [e for e in events if e["name"] == "plan_build"
              and not e["args"].get("cached", True)]

    def inside(span):
        return sum(1 for b in builds
                   if span["ts"] <= b["ts"] <= span["ts"] + span["dur"])
    out = {int(e["args"]["rid"]): inside(e) for e in pre}
    out["decode_after_first"] = sum(inside(e) for e in steps[1:])
    out["decode_first"] = inside(steps[0]) if steps else 0
    return out


def serve_layers(cfg) -> tuple:
    """(attention layers, MoE layers) of a model: each attention layer's
    prefill runs B2 (scores) and B1 (P @ V) once, each MoE layer B1 twice
    (dispatch, combine) in a prefill and in a decode step."""
    n_attn = sum(1 for k in cfg.pattern if k in ("g", "l"))
    return n_attn, (n_attn if cfg.moe is not None else 0)


def score_pairs(t: int, heads: int, hd: int, bs: int) -> int:
    """Real block pairs of the scoring product ``Q_bd @ K_bd^T`` of one
    attention layer at prompt length ``t``: ``heads`` panels of ``t x hd``
    stacked block-diagonally, tiled in ``bs`` blocks.  Where ``bs`` divides
    ``t`` each head gives (t/bs)^2 output blocks of hd/bs pairs; otherwise
    a block-row or column straddles two panels and meets both."""
    def mask(rows_per, cols_per):
        # each row's and column's panel; the padding's never match
        r = np.arange(heads * rows_per) // rows_per
        c = np.arange(heads * cols_per) // cols_per
        r = np.pad(r, (0, -len(r) % bs), constant_values=-1)
        c = np.pad(c, (0, -len(c) % bs), constant_values=-2)
        hit = r[:, None] == c[None]
        return hit.reshape(len(r) // bs, bs, len(c) // bs, bs).any((1, 3))
    q, k = mask(t, hd).astype(np.int64), mask(hd, t).astype(np.int64)
    return int((q @ k).sum())


def serve_gate(model, cfg32, prompts) -> dict:
    """float32, TF32 off: the sparse engine's tokens against the dense
    path's, B1 and B2 launched with every real block and pair (and no
    other) multiplied, and no plan-cache miss for a same-bucket request."""
    from repro_torch import obs
    from repro_torch.core import api
    from repro_torch.serving import effective_bucket
    t0 = time.perf_counter()
    dense = dense_decode(model, cfg32, prompts)
    dense_s = time.perf_counter() - t0
    api.clear_plan_cache()
    eng = serve_engine(model, cfg32, prompts)
    reset_counts()                  # counts of this path's run only
    counters = serve_counters_on()
    obs.reset_all()
    obs.enable(clear=True)
    try:
        t0 = time.perf_counter()
        results = eng.run()
        run_s = time.perf_counter() - t0
        events = obs.events()
    finally:
        obs.disable()
        tallies = serve_counters_off(*counters)
    counts = read_counts()
    summary = eng.summary()
    log(f"  dense path (greedy, prefill at the engine's shape, float32): "
        f"{dense_s:.1f} s for "
        f"{len(prompts)} requests; sparse engine: {run_s:.1f} s "
        f"(traced), {summary['decode_steps']} decode steps")
    match = {rid: match_tokens(results[rid], dense[rid][0], dense[rid][1],
                               rid) for rid in range(len(prompts))}
    log(f"  tokens equal to the dense path's: "
        f"{ {r: m['equal_steps'] for r, m in match.items()} } of "
        f"{SERVE['new_tokens']} a request; near-ties: "
        f"{ {r: m['near_tie_step'] for r, m in match.items() if m['near_tie_step'] is not None} or 'none'}")
    n_pre, n_dec = len(prompts), summary["decode_steps"]
    n_attn, n_moe = serve_layers(cfg32)
    want_b1 = (n_attn + 2 * n_moe) * n_pre + 2 * n_moe * n_dec
    want_b2 = n_attn * n_pre
    log(f"  launches: {counts} (B1 {n_attn + 2 * n_moe} a prefill and "
        f"{2 * n_moe} a decode step predicted: {want_b1}; B2 "
        f"{n_attn} a prefill and none a decode step: {want_b2})")
    check(counts["bsr_spmm"] == want_b1 and counts["bsr_pair_accumulate"]
          == want_b2, "the serving path did not launch B1 and B2 once for "
          "each of its products")
    hd, bs = cfg32.resolved_head_dim, SERVE["block_size"]
    buckets = [effective_bucket(cfg32, len(p), SERVE["max_len"])
               for p in prompts]
    want_pairs = n_attn * sum(score_pairs(b, cfg32.n_heads, hd, bs)
                              for b in buckets)
    log(f"  B1 multiplied {tallies['blocks_multiplied']} blocks (counted on "
        f"the card), its tables' real blocks {tallies['table_blocks']}; B2 "
        f"{tallies['pairs_multiplied']} pairs, its tables' "
        f"{tallies['table_pairs']}, the block-diagonal scores' "
        f"{want_pairs}")
    check(tallies["blocks_multiplied"] == tallies["table_blocks"] > 0,
          "B1 multiplied other blocks than its tables' real ones")
    check(tallies["pairs_multiplied"] == tallies["table_pairs"] == want_pairs,
          "B2 multiplied other pairs than the real ones")
    misses = misses_by_request(events)
    first = {}
    for rid, b in enumerate(buckets):
        first.setdefault(b, rid)
    repeat = [rid for rid, b in enumerate(buckets) if first[b] != rid]
    log(f"  plan-cache misses by request (buckets {buckets}): "
        f"{ {k: v for k, v in misses.items()} }")
    check(all(misses[rid] == 0 for rid in repeat),
          "a same-bucket request built a plan")
    check(misses["decode_after_first"] == 0,
          "a decode step after the first built a plan")
    return {"dense_s": dense_s, "traced_run_s": run_s, "match": match,
            "tokens": {rid: results[rid].tolist() for rid in results},
            "launches": counts, **tallies, "want_pairs": want_pairs,
            "misses": misses, "buckets": buckets,
            "dense_first_logits": [d[1][0] for d in dense],
            "dropped_mean": summary["dropped_mean"],
            "dropped_max": summary["dropped_max"]}


def serve_windows(model, cfg, toks, label: str) -> dict:
    """One request of two tokens (one prefill, one decode step) through
    ``run()`` of a fresh engine on the warm plan cache, traced (obs spans;
    a traced multiply synchronises) in one ``torch.profiler`` window
    (:func:`profiled`), with the host's synchronisations reported
    (``torch.cuda.set_sync_debug_mode``).  The engine's own
    ``serve.prefill`` and ``serve.decode_step`` spans split the window;
    for each: wall, device busy and idle share, top device ops, the B1 and
    B2 kernels in the trace, host synchronisations by source line, and the
    host time in operator construction, tiling, plan lookups and
    multiplies (obs spans).  One marker, recorded both as an obs event
    and a profiler range, puts the three clocks on one axis."""
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from repro_torch import obs
    from repro_torch.obs import sync_elapsed
    syncs, anchor = [], {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append((time.perf_counter(),
                          f"{Path(filename).name}:{lineno}"))

    def once():
        syncs.clear()
        eng = serve_engine(model, cfg, [toks], new_tokens=2)
        obs.enable(clear=True)
        try:
            with record_function("smoke.anchor"):
                anchor["perf"] = time.perf_counter()
                obs.instant("smoke.anchor")
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = note
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    eng.run()
                    wall = sync_elapsed(t0, eng.tokens) * 1e3
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            obs.disable()
        return wall

    events, wall, prof, launched, lost = profiled(once,
                                                  f"{label} one request")
    spans = obs.events()
    o_anchor = next(e["ts"] for e in spans if e["name"] == "smoke.anchor")
    k_anchor = next(e.time_range.start for e in prof.events()
                    if e.name == "smoke.anchor"
                    and e.device_type == DeviceType.CPU)
    offset = k_anchor - o_anchor        # obs µs -> profiler µs
    res = {"run_wall_ms": wall, "launched": launched}
    seen = {k: 0 for k in TRACED_KERNELS}
    for name, span_name in (("prefill", "serve.prefill"),
                            ("decode_step", "serve.decode_step")):
        sp, = (e for e in spans if e["name"] == span_name)
        lo, hi = sp["ts"], sp["ts"] + sp["dur"]
        inside = [(n, max(s0, lo + offset), min(s1, hi + offset))
                  for n, s0, s1 in events
                  if s0 < hi + offset and s1 > lo + offset]
        r = res[name] = device_summary(inside, sp["dur"] / 1e3,
                                       f"{label} {name}", top_n=10,
                                       lost=lost)
        kern = {k: sum(1 for n, s0, _ in events if n == k
                       and lo + offset <= s0 <= hi + offset)
                for k in TRACED_KERNELS}
        for k in kern:
            seen[k] += kern[k]
        where = {}
        for p, line in syncs:
            if lo <= (p - anchor["perf"]) * 1e6 + o_anchor <= hi:
                where[line] = where.get(line, 0) + 1
        host = span_totals([e for e in spans
                            if lo <= e["ts"] and e["ts"] + e["dur"] <= hi],
                           ("serve.operator", "serve.tile", "plan_build",
                            "multiply."))
        b1 = kern["spmm_kernel"] + kern["spmm_elem_kernel"] \
            + kern["spmm_sparse_b_kernel"]
        r.update({"launches": {"bsr_spmm": b1,
                               "bsr_pair_accumulate": kern["pair_kernel"]},
                  "host_syncs": sum(where.values()),
                  "syncs_by_line": dict(sorted(
                      where.items(), key=lambda kv: -kv[1])[:8]),
                  "host_ms": {k: round(v, 3) for k, v in host.items()}})
        log(f"  {label} {name}: B1 {b1} and B2 "
            f"{kern['pair_kernel']} kernels in the trace"
            f"{' (which lost some)' if lost else ''}; "
            f"{r['host_syncs']} host synchronisations, by source line: "
            f"{r['syncs_by_line']}")
        log(f"  {label} {name}, traced: wall "
            f"{r['wall_ms']:.1f} ms; operator construction "
            f"{host['serve.operator']:.1f} ms, tiling {host['serve.tile']:.1f}"
            f" ms, plan lookups {host['plan_build']:.1f} ms, multiplies "
            f"{host['multiply.']:.1f} ms")
    check(lost or all(seen[k] == sum(launched[w] for w in ws)
                      for k, ws in TRACED_KERNELS.items()),
          f"{label}: B1 or B2 launched outside the prefill and decode-step "
          f"spans ({seen} in them, {launched} in the run)")
    return res


def serve_published(model, cfg16, cfg32, prompts, dense32_first) -> dict:
    """bfloat16 (the published compute type): the same requests through the
    same engine, the first-token logits against the dense path's in bf16,
    the serving metrics, launches a prefill and a decode step, peak memory
    and where a prefill's and a decode step's time goes."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    firsts = [padded_prefill(model, cfg16, toks)[0][0] for toks in prompts]
    eng = serve_engine(model, cfg16, prompts, keep_first_logits=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bsr_spmm_cuda.by_shape = {}
    try:
        t0 = time.perf_counter()
        results = eng.run()
        run_s = time.perf_counter() - t0
    finally:
        b1_by_shape, bsr_spmm_cuda.by_shape = bsr_spmm_cuda.by_shape, None
    counts = read_counts()
    peak = phase_peak("serving, bf16 engine run")
    s = eng.summary()
    # the bound: both bf16 paths compute the float32 function with bf16
    # roundings, so each lies within its rounding noise of the float32
    # dense logits; the dense bf16 path's own distance from them, at its
    # largest over the requests, is that noise, and two paths that each
    # stay within it differ by at most twice it (triangle inequality)
    noise = max((d16 - d32).abs().max().item()
                for d16, d32 in zip(firsts, dense32_first))
    errs = [(eng.first_logits[rid] - firsts[rid]).abs().max().item()
            for rid in range(len(prompts))]
    agree = [int(eng.first_logits[rid].argmax()) == int(firsts[rid].argmax())
             for rid in range(len(prompts))]
    log(f"  first-token logits, bf16 engine vs bf16 dense path: max |diff| "
        f"{[f'{e:.4f}' for e in errs]}, bound 2 x {noise:.4f} (the dense "
        f"bf16 path's distance from float32); top-1 agrees: {agree}")
    check(max(errs) <= 2 * noise, "the bf16 engine's first-token logits "
          "leave the bound")
    n_attn, n_moe = serve_layers(cfg16)
    check(counts["bsr_spmm"] == (n_attn + 2 * n_moe) * len(prompts)
          + 2 * n_moe * s["decode_steps"]
          and counts["bsr_pair_accumulate"] == n_attn * len(prompts),
          "the bf16 serving run did not launch B1 and B2 once a product")
    # smoke readings of this four-request window, not serving metrics: of
    # four requests the 99th percentile is the largest, so the largest is
    # printed under its own name
    reqs = eng.metrics.requests.values()
    keys = ("ttft_p50_s", "tpot_p50_s", "decode_tok_per_s", "prefill_s",
            "decode_s", "decode_steps", "tokens", "elapsed_s",
            "plan_lookups", "plan_cache_hit_rate", "dropped_mean",
            "dropped_max")
    metrics = {k: s[k] for k in keys}
    metrics["ttft_max_s"] = max(r.ttft for r in reqs)
    metrics["tpot_max_s"] = max(r.tpot for r in reqs if r.tpot is not None)
    log(f"  smoke readings of this {len(prompts)}-request window "
        f"(summary() and the largest per request): {json.dumps(metrics)}")
    log(f"  generated (first request): {results[0].tolist()}")
    by_product = b1_products(b1_by_shape, cfg16)
    log(f"  B1 launches by product, counted where B1 launches: "
        f"{by_product} (by (m, k, n): {b1_by_shape})")
    check(sum(by_product.values()) == counts["bsr_spmm"],
          "B1's launches by product do not add up to its launches")
    check(by_product["dispatch"] == by_product["combine"]
          == n_moe * (len(prompts) + s["decode_steps"])
          and by_product["pv"] == n_attn * len(prompts),
          "the bf16 serving run did not launch B1 once for each MoE "
          "dispatch, MoE combine and P @ V product")
    windows = serve_windows(model, cfg16, prompts[0], "bf16")
    log(f"  the four-request run untraced, for comparison: a prefill "
        f"{s['prefill_s'] / len(prompts) * 1e3:.1f} ms on average, a "
        f"decode step of two slots "
        f"{s['decode_s'] / s['decode_steps'] * 1e3:.1f} ms")
    return {"metrics": metrics, "launches": counts, "run_s": run_s,
            "b1_by_product": by_product, "peak_gb": peak,
            "first_logit_err": errs, "bound": 2 * noise,
            "top1_agrees": agree, "windows": windows}


def b1_products(by_shape: dict, cfg) -> dict:
    """B1's launches of a serving run, by product, from its tally by ``(m,
    k, n)``: ``P_bd @ V`` is the one with n = head_dim; of those with n =
    d_model, the MoE dispatch ``D @ X`` maps k tokens to m >= k expert
    lines and the combine ``W @ Y`` m tokens from k >= m lines."""
    out = {"dispatch": 0, "combine": 0, "pv": 0}
    for (m, k, n), c in by_shape.items():
        if n == cfg.resolved_head_dim:
            out["pv"] += c
        elif n == cfg.d_model and m != k:
            out["dispatch" if m > k else "combine"] += c
        else:
            check(False, f"a B1 launch of the serving run at (m, k, n) = "
                  f"{(m, k, n)} is none of its products")
    return out


def serve_b1_case(ops, label: str, a_dense, x, capacity="bucket") -> dict:
    """B1 at one serving product's shape: the plan's own table over the
    operator's real blocks, held against the plain version, with its bound
    and library yardsticks, each timed on the card's clock behind a sleep
    kernel (``device_ms``: a launch here is shorter than the host's
    call)."""
    from repro_torch.core import api
    a_h = ops.tile(a_dense, capacity)
    b_h = api.DistDense.for_rhs(x, a_h, allow_pad=True)
    plan = api.plan_matmul(a_h, b_h, algorithm="ring_a")
    ex, bs = plan.executor, a_h.block_size
    blocks, rows, cols = (ex.batch(a_h.placed(api.NATURAL)[k])
                          for k in ("blocks", "rows", "cols"))
    dense = ex.batch(b_h.placed(api.NATURAL)["dense"])
    ident = ex.identity_map()
    table = plan.spmm_table(a_h, ident, ident)
    nbr = a_h.tile_shape[0] // bs
    log(f"  B1 {label}: A {tuple(a_h.logical_shape)} {str(a_h.dtype)[6:]}, "
        f"{table.real_blocks} real blocks of {blocks.shape[1]} stored, B "
        f"{tuple(dense.shape[1:])}")
    r = kernel_case(blocks, rows, cols, dense, nbr, TOL_F32_SMALL, label,
                    table=table, reps=20, timer=device_ms)
    real = a_h.pool_lists(False).real
    r.update(b1_yardsticks(blocks, rows, cols, dense, nbr, real,
                           TOL_F32_SMALL, label, timer=device_ms))
    r["shape"] = {"A": list(a_h.logical_shape), "B": list(dense.shape[1:]),
                  "bs": bs, "dtype": str(a_h.dtype)[6:]}
    return r


def serve_b2_case(ops, q_bd, kt_bd) -> dict:
    """B2 at the scoring product's shape (ring_c's only step at g 1),
    against the plain version, with its bound and cuSPARSE ``CSR @ CSR`` on
    the same operands as its yardstick (held against the plain product
    first), each timed by ``device_ms``."""
    a_h, b_h = ops.tile(q_bd), ops.tile(kt_bd)
    a, b, (pa, pb, ps), n_slots, real = ring_step_pairs(a_h.tiled,
                                                        b_h.tiled, 0)
    label = "attention scores"
    log(f"  B2 {label}: Q_bd {tuple(q_bd.shape)} x K_bd^T "
        f"{tuple(kt_bd.shape)}, {int(np.asarray(real).sum())} real pairs "
        f"of {pa.numel()}")
    r = pair_acc_case(a, b, pa, pb, ps, n_slots, label, real, reps=20,
                      timer=device_ms)
    want = q_bd @ kt_bd
    scale = q_bd.abs() @ kt_bd.abs()
    a_csr, b_csr = q_bd.to_sparse_csr(), kt_bd.to_sparse_csr()
    try:
        got = (a_csr @ b_csr).to_dense()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"  yardstick {label}: no library call ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:160]})")
        r["library_ms"] = None
        return r
    err, share, ok = compare(got, want, scale, TOL_F32_SMALL)
    check(ok, f"the yardstick CSR @ CSR computes another function "
          f"({err:.3e}, {share:.3g} of its allowance)")
    del got
    r["library_ms"] = device_ms(lambda: a_csr @ b_csr, 5)
    log(f"  yardstick {label}: torch CSR @ CSR (cuSPARSE) "
        f"{r['library_ms']:.3f} ms, {a_csr._nnz()} x {b_csr._nnz()} "
        f"nonzeros, {share:.3g} of its allowance")
    return r


def serve_kernel_cases(model, cfg16, toks) -> dict:
    """B2 at the scoring shape and B1 at the P @ V shape (and, in an MoE
    model, at the MoE dispatch and combine shapes), on the first attention
    layer's weights applied to one prompt's embedding (bf16 activations,
    as the published run), with that layer's mask."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.attention import _pair_mask
    from repro_torch.models.common import rms_norm
    from repro_torch.serving import sparse as ss
    li = next(i for i, k in enumerate(cfg16.pattern) if k in ("g", "l"))
    blk, kind = model.layers[li], cfg16.pattern[li]
    ops = ss.SparseOps(block_size=SERVE["block_size"], device=DEVICE)
    m = cfg16.moe
    with torch.no_grad():
        t_in = torch.as_tensor(toks, device=DEVICE)
        x = model.top.embed[t_in.long()].to(torch.bfloat16)[None]
        if cfg16.emb_scale:
            x = x * torch.tensor(cfg16.d_model ** 0.5, dtype=x.dtype)
        h = rms_norm(x, blk.norms.ln1, cfg16.norm_eps)
        pos = torch.arange(t_in.shape[0], dtype=torch.int32, device=DEVICE)
        qh, kh_f, v_f, _, _ = ss._qkv_panels(blk.attn, h, pos, cfg16)
        q_bd = torch.block_diag(*qh)
        kt_bd = torch.block_diag(*kh_f.transpose(1, 2))
        mask = _pair_mask(cfg16, kind, pos, pos)
        pv = torch.block_diag(*ss._probs(
            ops.spgemm_sparse(q_bd, kt_bd).densify(), mask, cfg16))
        res = {"pv": serve_b1_case(ops, "attention P_bd @ V", pv, v_f),
               "scores": serve_b2_case(ops, q_bd, kt_bd)}
        if m is None:
            return res
        n, d = x.shape[1], x.shape[2]
        xf = h.reshape(n, d)
        r = tmoe.route_tokens(blk.moe.router, xf, cfg16)
        disp, comb = ss.routing_operators(r, n, cfg16, torch.bfloat16)
        cap, groups, _ = tmoe.route_meta(n, cfg16)
        lines = groups * m.n_experts * cap
        bound = ss.routing_capacity(n, lines, m.top_k, ops.g, ops.block_size)
        xe = (disp.float() @ xf.float()).to(torch.bfloat16)
        y = tmoe.expert_ffn(blk.moe, xe.reshape(groups, m.n_experts, cap, d),
                            cfg16).reshape(lines, d)
    res.update(dispatch=serve_b1_case(ops, "MoE dispatch D @ X", disp, xf,
                                      bound),
               combine=serve_b1_case(ops, "MoE combine W @ Y", comb, y,
                                     bound))
    res["dispatch"]["capacity_bound"] = bound
    return res


def exact_params(cfg) -> int:
    """The model's parameter count: ``param_count()`` plus what it leaves
    out, the norm scales (``ln1`` a layer, ``ln2`` where a layer has an MLP
    or MoE, gemma2's post-norms, the final norm), QKV biases, the RG-LRU's
    conv and gate biases and ``lam`` (4 w a layer), Mamba's conv bias and
    ``dt_bias``, the audio frontend's layer norm and the vlm projector's
    second matrix.  It restates every module's parameter set, so a module
    that gains or loses a parameter must change it too:
    ``tests/test_torch_models.py::test_exact_params`` holds it against
    the JAX package's parameter tree for every configuration."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    norms, extra = 1, 0
    for kind in cfg.pattern:
        norms += 1
        if kind in ("g", "l"):
            norms += (cfg.moe is not None or cfg.mlp_kind != "none") \
                + 2 * cfg.post_norms
            extra += cfg.qkv_bias * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        elif kind == "r":
            norms += cfg.mlp_kind != "none"
            extra += 4 * (cfg.lru_width or d)
        else:
            di = cfg.ssm.expand * d
            extra += di + 2 * cfg.ssm.d_state + di // cfg.ssm.head_dim
    extra += {"audio": 2 * d, "vlm": d * d}.get(cfg.frontend, 0)
    return cfg.param_count() + norms * d + extra


def describe(cfg) -> str:
    """A configuration's published shape, for the log."""
    parts = [f"{cfg.n_layers} layers {cfg.pattern[:6]}"
             f"{'...' if cfg.n_layers > 6 else ''}", f"d_model {cfg.d_model}"]
    if any(k in "gl" for k in cfg.pattern):
        parts.append(f"{cfg.n_heads} query heads and {cfg.n_kv_heads} KV "
                     f"heads of {cfg.resolved_head_dim}")
    if cfg.moe is not None:
        parts.append(f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
                     f"(d_ff {cfg.moe.d_ff_expert})")
    elif cfg.mlp_kind != "none":
        parts.append(f"{cfg.mlp_kind} d_ff {cfg.d_ff}")
    if "r" in cfg.pattern:
        parts.append(f"lru_width {cfg.lru_width}, local window "
                     f"{cfg.local_window}")
    if "m" in cfg.pattern:
        parts.append(f"d_state {cfg.ssm.d_state}, head_dim "
                     f"{cfg.ssm.head_dim}, chunk {cfg.ssm.chunk}")
    if cfg.frontend:
        parts.append(f"{cfg.frontend} frontend of {cfg.frontend_dim}")
    parts.append(f"vocab {cfg.vocab_size}")
    return f"{cfg.name}: " + ", ".join(parts)


def init_model(cfg, seed: int, dtype=torch.float32):
    """``init_params`` on the card (float32; cast to ``dtype`` after),
    its parameters counted against :func:`exact_params`."""
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=seed, device=DEVICE)
    if dtype != torch.float32:
        model = model.to(dtype)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{describe(cfg)}: {n_params} parameters ({cfg.param_count()} by "
        f"param_count(); {n_params * model.top.embed.element_size() / 1e9:.2f}"
        f" GB in {str(dtype)[6:]}), initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    check(n_params == exact_params(cfg), f"parameter count {n_params} "
          f"differs from the config's {exact_params(cfg)}")
    return model


def serving_phase(arch: str = SERVE["arch"]) -> dict:
    """``arch`` at its published width and depth through
    ``ServeEngine(sparse=True)``: the float32 gate, the bf16 run, the
    kernels at the serving shapes."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    cfg16 = get_config(arch)
    cfg32 = dc.replace(cfg16, compute_dtype="float32")
    model = init_model(cfg16, SERVE["seed"])
    prompts = serve_prompts(cfg16)
    log(f"requests: prompt lengths {list(SERVE['prompt_lens'])}, "
        f"{SERVE['new_tokens']} new tokens each, max_batch "
        f"{SERVE['max_batch']}, max_len {SERVE['max_len']}")
    log("-- gate run (float32, TF32 off)")
    gate = serve_gate(model, cfg32, prompts)
    phase_peak("serving, float32 gate")
    free()
    log("-- published run (bfloat16)")
    pub = serve_published(model, cfg16, cfg32, prompts,
                          gate.pop("dense_first_logits"))
    free()
    log("-- B1 and B2 at the serving shapes")
    kern = serve_kernel_cases(model, cfg16, prompts[0])
    del model
    free()
    return {"gate": gate, "published": pub, "kernels": kern}


def train_schedule_sum(cfg_steps: int, lr: float) -> float:
    """The sum of the learning rates ``train()`` applies over ``cfg_steps``
    steps (its schedule: cosine, warmup ``max(steps // 20, 1)``)."""
    from repro_torch.optim import cosine_schedule
    sched = cosine_schedule(lr, max(cfg_steps // 20, 1), cfg_steps)
    return sum(float(sched(t)) for t in range(1, cfg_steps + 1))


def train_gate(arch: str) -> dict:
    """``train()`` at smoke size on the card and on the CPU from the same
    parameters (drawn on the CPU), float32 with TF32 off: every step's
    loss, aux loss and gradient norm within ``TOL_TRAIN_GATE``, the dropped
    shares equal, the final parameters within 1e-5 (1 + |p|) plus Adam's
    cap (the tolerance comment); B1-B3 launched no time."""
    import copy
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamW
    g = TRAIN_GATE
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dc.replace(cfg, moe=dc.replace(
            cfg.moe, capacity_factor=g["capacity_factor"]))
    check(cfg.compute_dtype == "float32", f"{cfg.name} is not float32")
    kw = dict(steps=g["steps"], batch=g["batch"], seq=g["seq"], lr=g["lr"],
              seed=g["seed"], log_every=0)
    cpu_model = tf.init_params(cfg, seed=g["seed"], device="cpu")
    reset_counts()
    t0 = time.perf_counter()
    card = train(cfg, device=DEVICE, params=copy.deepcopy(cpu_model).to(
        DEVICE), **kw)
    card_s = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    cpu = train(cfg, device="cpu", params=cpu_model, **kw)
    cpu_s = time.perf_counter() - t0
    check(not any(counts.values()),
          f"{cfg.name} training launched a sparse kernel: {counts}")
    worst = {}
    for key in ("losses", "aux", "grad_norms"):
        got, want = np.asarray(card[key]), np.asarray(cpu[key])
        share = np.abs(got - want) / (TOL_TRAIN_GATE * np.maximum(
            np.abs(want), np.finfo(np.float32).tiny))
        share[(got == want)] = 0.0
        worst[key] = float(share.max())
        check(len(got) == g["steps"] and np.isfinite(got).all()
              and worst[key] <= 1.0,
              f"{cfg.name} gate: {key} on the card {got.tolist()} against "
              f"the CPU's {want.tolist()}")
    check(card["dropped"] == cpu["dropped"],
          f"{cfg.name} gate: dropped shares {card['dropped']} on the card, "
          f"{cpu['dropped']} on the CPU")
    cap = 2 * AdamW().ratio_bound(g["steps"]) \
        * train_schedule_sum(g["steps"], g["lr"])
    err_max, past_base, n_el = 0.0, 0, 0
    cpu_params = dict(cpu["params"].named_parameters())
    for name, p in card["params"].named_parameters():
        want = cpu_params[name].detach()
        err = (p.detach().cpu() - want).abs()
        base = TOL_F32_SMALL * (1 + want.abs())
        check(bool((err <= base + cap).all()),
              f"{cfg.name} gate: {name} differs by {err.max().item():.3e} "
              f"(allowed 1e-5 (1 + |p|) + {cap:.3e})")
        err_max = max(err_max, err.max().item())
        past_base += int((err > base).sum())
        n_el += err.numel()
    log(f"  {cfg.name}: {g['steps']} steps of {g['batch']} x {g['seq']} "
        f"on the card ({card_s:.1f} s) and the CPU ({cpu_s:.1f} s); losses "
        f"{card['losses'][0]:.5f} -> {card['losses'][-1]:.5f}; worst share "
        f"of the {TOL_TRAIN_GATE} allowance: loss {worst['losses']:.3f}, "
        f"aux {worst['aux']:.3f}, gradient norm {worst['grad_norms']:.3f}; "
        f"dropped {card['dropped'][0]:.4f} .. {card['dropped'][-1]:.4f} "
        f"(equal); parameters: max |card - CPU| {err_max:.3e}, "
        f"{past_base} of {n_el} elements past 1e-5 (1 + |p|), Adam's cap "
        f"{cap:.3e}; launches {counts}")
    return {"steps": g["steps"], "losses_card": card["losses"],
            "losses_cpu": cpu["losses"], "dropped": card["dropped"],
            "worst_share": worst, "param_max_abs_err": err_max,
            "param_past_base": past_base, "param_elements": n_el,
            "adam_cap": cap, "card_s": card_s, "cpu_s": cpu_s}


def train_resume() -> dict:
    """On the card, with deterministic algorithms: ``train()`` of 20 steps
    straight against 10 steps, a stop, and a relaunch from the checkpoint
    that resumes to 20 (the JAX test's 1e-5 / 1e-6 on every parameter and
    loss; the largest difference printed)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    r = TRAIN_RESUME
    cfg = get_config(r["arch"], smoke=True)
    kw = dict(steps=r["steps"], batch=r["batch"], seq=r["seq"],
              ckpt_every=100, log_every=0, seed=r["seed"], device=DEVICE)
    torch.use_deterministic_algorithms(True)
    with tempfile.TemporaryDirectory() as d:
        full = train(cfg, ckpt_dir=f"{d}/straight", **kw)
        first = train(cfg, ckpt_dir=f"{d}/resumed",
                      stop_after=r["stop_after"], **kw)
        second = train(cfg, ckpt_dir=f"{d}/resumed", **kw)
    torch.use_deterministic_algorithms(False)
    check(len(first["losses"]) == r["stop_after"]
          and len(second["losses"]) == r["steps"] - r["stop_after"]
          and int(second["opt"]["step"]) == r["steps"],
          "resume: the relaunch did not take the remaining steps")
    loss_err = float(np.abs(np.asarray(second["losses"]) - np.asarray(
        full["losses"][r["stop_after"]:])).max())
    check(np.allclose(second["losses"], full["losses"][r["stop_after"]:],
                      rtol=1e-5, atol=1e-6), "resume: losses differ")
    err_max = 0.0
    want = dict(full["params"].named_parameters())
    for name, p in second["params"].named_parameters():
        a, b = p.detach(), want[name].detach()
        err_max = max(err_max, (a - b).abs().max().item())
        check(bool(torch.isclose(a, b, rtol=1e-5, atol=1e-6).all()),
              f"resume: {name} differs from the straight run's")
    log(f"  resume ({cfg.name}, {r['steps']} steps, stopped at "
        f"{r['stop_after']}, deterministic algorithms): max |resumed - "
        f"straight| {err_max:.3e} on the parameters, {loss_err:.3e} on the "
        "losses")
    return {"param_max_abs_err": err_max, "loss_max_abs_err": loss_err}


def count_syncs(fn):
    """``fn()`` with the card's synchronising calls counted
    (``torch.cuda.set_sync_debug_mode``): (result, count, count by source
    line)."""
    import warnings
    where = {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            key = f"{Path(filename).name}:{lineno}"
            where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), dict(sorted(
        where.items(), key=lambda kv: -kv[1])[:8])


MATMUL_KERNELS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def kernel_kinds(by_kernel_ms: dict) -> dict:
    """Device ms by kind of kernel: matmuls, reductions and the rest
    (elementwise: casts, AdamW's chains, activations; copies)."""
    kinds = {"matmul": 0.0, "reduce": 0.0, "elementwise": 0.0, "copy": 0.0}
    for name, ms in by_kernel_ms.items():
        low = name.lower()
        kind = ("matmul" if any(k in low for k in MATMUL_KERNELS) else
                "copy" if low.startswith(("memcpy", "memset")) else
                "reduce" if "reduce" in low or "softmax" in low else
                "elementwise")
        kinds[kind] += ms
    return {k: round(v, 3) for k, v in kinds.items()}


def train_profile(model, opt_state, cfg, spec: dict = TRAIN) -> dict:
    """Three more steps of a published run (``spec``: ``TRAIN``,
    ``MAMBA_TRAIN``, ``HUBERT_TRAIN``), each on the batch after the
    run's: one with its host synchronisations counted, one in a
    ``torch.profiler`` window (busy against wall, idle share, top device
    ops, device time by kind), and one split by synchronisations into
    forward, backward and optimizer (what ``lm.make_train_step`` does, in
    three ``record_function`` ranges), each range's device time summed
    from the kernels inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, record_function
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, cosine_schedule
    t = spec
    opt = AdamW(lr=cosine_schedule(t["lr"], max(t["steps"] // 20, 1),
                                   t["steps"]))
    step_fn = lm.make_train_step(cfg, opt)
    source = SyntheticLM(cfg, t["batch"], t["seq"], seed=t["seed"])
    state = {"opt": opt_state}

    def one_step(step):
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in source(step).items()}
        t0 = time.perf_counter()
        _, state["opt"], m = step_fn(model, state["opt"], batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss, gnorm

    (sync_ms, _, _), n_syncs, sync_lines = count_syncs(
        lambda: one_step(t["steps"]))
    log(f"  host synchronisations in one step (the batch's copy, the "
        f"step, reading its loss and gradient norm): {n_syncs}, by source "
        f"line: {sync_lines}")
    label = f"{cfg.name} training step"
    events, wall_ms, _, _, lost = profiled(
        lambda: one_step(t["steps"] + 1)[0], label)
    summary = device_summary(events, wall_ms, label, top_n=12, lost=lost)
    kinds = kernel_kinds(_by_name_ms(events))
    log(f"  device ms by kind: {kinds}")

    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in source(t["steps"] + 2).items()}
    named = dict(model.named_parameters())
    phases = ("forward", "backward", "optimizer")
    with profile(activities=PROFILED) as prof:
        time.sleep(PROFILE_PREROLL_S)
        t0 = time.perf_counter()
        with record_function("smoke.train.forward"):
            total, _ = lm.loss_fn(model, batch, cfg)
            torch.cuda.synchronize()
        with record_function("smoke.train.backward"):
            total.backward()
            torch.cuda.synchronize()
        # a parameter the loss does not read (an audio encoder's token
        # embedding) has no gradient: a zero one, as make_train_step gives
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        with record_function("smoke.train.optimizer"):
            state["opt"] = opt.apply(named, grads, state["opt"])
            torch.cuda.synchronize()
        split_wall = (time.perf_counter() - t0) * 1e3
    del grads, total
    # the ranges' own device-side annotations are not kernels
    split_events = [e for e in device_events(prof)
                    if not e[0].startswith("smoke.")]
    ranges = {e.name.removeprefix("smoke.train."): e.time_range
              for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name.startswith("smoke.train.")}
    check(sorted(ranges) == sorted(phases), f"the split step's ranges: "
          f"{sorted(ranges)}")
    by_phase = {}
    for ph in phases:
        lo, hi = ranges[ph].start, ranges[ph].end
        inside = [(n, s0, s1) for n, s0, s1 in split_events
                  if lo <= s0 and s1 <= hi]
        busy = sum(s1 - s0 for _, s0, s1 in inside) / 1e3
        by_phase[ph] = {"host_ms": (hi - lo) / 1e3, "device_ms": busy,
                        "kernels": len(inside),
                        "by_kind_ms": kernel_kinds(_by_name_ms(inside))}
    outside = len(split_events) - sum(v["kernels"] for v in
                                      by_phase.values())
    log(f"  one step split by synchronisations (wall {split_wall:.1f} ms): "
        + "; ".join(f"{ph} device {v['device_ms']:.1f} ms in "
                    f"{v['kernels']} kernels (host range "
                    f"{v['host_ms']:.1f} ms), {v['by_kind_ms']}"
                    for ph, v in by_phase.items())
        + f"; {outside} kernels outside the three ranges")
    summary.update(by_kind_ms=kinds, host_syncs=n_syncs,
                   syncs_by_line=sync_lines, split_wall_ms=split_wall,
                   by_phase=by_phase, kernels_outside_phases=outside)
    return summary


def _by_name_ms(events) -> dict:
    out = {}
    for name, s0, s1 in events:
        out[name] = out.get(name, 0.0) + (s1 - s0) / 1e3
    return out


def train_published() -> dict:
    """Qwen2.5-3B at its published width and depth through ``train()``:
    8 steps of 4 x 512 tokens of ``SyntheticLM(seed=0)``, bf16 compute over
    float32 parameters and AdamW state, remat on; no checkpoint (49 GB to
    disk)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    t = TRAIN
    cfg = get_config(t["arch"])
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias,
           cfg.tie_embeddings, cfg.compute_dtype, cfg.remat)
          == (36, 2048, 16, 2, 128, 11008, 151936, True, True, "bfloat16",
              True), f"{cfg.name} is not the published configuration")
    n_model = cfg.param_count()
    tokens = t["batch"] * t["seq"]
    free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                  lr=t["lr"], seed=t["seed"], ckpt_dir=None, device=DEVICE,
                  log_every=1)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model, opt_state = state["params"], state["opt"]
    n_params = sum(p.numel() for p in model.parameters())
    # param_count() leaves out the norm scales (two a layer and the
    # final norm's) and the QKV biases
    extra = (2 * cfg.n_layers + 1) * cfg.d_model + cfg.n_layers * (
        (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim)
    check(n_params == n_model + extra, f"parameter count {n_params} "
          f"differs from the config's {n_model} + {extra}")
    check(not any(counts.values()),
          f"training launched a sparse kernel: {counts}")
    losses, gnorms = np.asarray(state["losses"]), np.asarray(
        state["grad_norms"])
    check(len(losses) == t["steps"] and np.isfinite(losses).all()
          and np.isfinite(gnorms).all(),
          f"non-finite loss or gradient norm: {losses}, {gnorms}")
    first3, last3 = losses[:3].mean(), losses[-3:].mean()
    check(last3 < first3, f"the loss did not decrease: {losses}")
    step_ms = [1e3 * s for s in state["step_s"]]
    warm_ms = statistics.median(step_ms[1:])
    flops = 6 * n_model * tokens
    _, peak_ops = peaks()
    share = flops / (warm_ms / 1e3) / peak_ops[torch.bfloat16]
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters ({n_model} by param_count); "
        f"{t['steps']} steps of {t['batch']} x {t['seq']} tokens in "
        f"{run_s:.1f} s (initialisation included)")
    log(f"  losses {[round(float(x), 4) for x in losses]} (first "
        f"{losses[0]:.4f} "
        f"against ~12.4 predicted: ln {cfg.vocab_size} = "
        f"{np.log(cfg.vocab_size):.2f} plus ~0.5); mean of the first 3 "
        f"{first3:.4f} -> last 3 {last3:.4f}")
    log(f"  gradient norms {[round(float(x), 4) for x in gnorms]}")
    log(f"  step wall ms (synchronised): {[round(x, 1) for x in step_ms]}; "
        f"median after the first {warm_ms:.1f} ms: "
        f"{tokens / (warm_ms / 1e3):.0f} tokens/s, model flops 6 x "
        f"{n_model} x {tokens} = {flops / 1e12:.1f} TFLOP a step, "
        f"{100 * share:.1f} % of 989 TFLOP/s bf16")
    log(f"  peak device memory {peak_gb:.2f} GB; launches {counts}")
    prof = train_profile(model, opt_state, cfg)
    del model, opt_state, state
    free()
    return {"losses": losses.tolist(), "grad_norms": gnorms.tolist(),
            "step_ms": step_ms, "median_step_ms": warm_ms,
            "tokens_per_s": tokens / (warm_ms / 1e3),
            "model_flops_share": share, "peak_gb": peak_gb,
            "n_params": n_params, "run_s": run_s, "profile": prof}


def training_phase() -> dict:
    """The gate at smoke size (card against CPU), resume on the card, and
    the published run, with every launch count read around each."""
    log("-- gate: train() on the card against the CPU (float32, TF32 off)")
    gate = {arch: train_gate(arch) for arch in TRAIN_GATE["archs"]}
    log("-- resume on the card")
    resume = train_resume()
    log("-- phase 17a: the dry run of the published run's cell, then the "
        "same program's step on the card")
    dry = dryrun_gate()
    log("-- published run (Qwen2.5-3B, bf16 compute, remat)")
    pub = train_published()
    return {"gate": gate, "resume": resume, "dryrun": dry,
            "published": pub}


# ---------------------------------------------------------------------------
# phase 13: elastic replanning and the static verifier
# ---------------------------------------------------------------------------
def us(scores: dict) -> dict:
    """Seconds by schedule as microseconds, 4 significant digits."""
    return {k: float(f"{v * 1e6:.4g}") for k, v in scores.items()}


def span_ms(events, name: str) -> list:
    """Host milliseconds of each span ``name``, in the order they ran."""
    return [e["dur"] / 1e3 for e in sorted(events, key=lambda e: e["ts"])
            if e["name"] == name]


def elastic_validation(el: dict) -> dict:
    """``validate="fast"`` on a fresh plan of each schedule at the SpMM cell
    (g 2), of steal3d at g 3 and of the scale-16 sparse-output A @ A;
    ``validate="full"`` (one multiply under the op-trace lint, kernels
    launched) on the six schedules' plans and the sparse one.  Every plan
    proves clean (a finding raises); each validation's host time comes
    from its ``plan_build.validate`` span."""
    from repro_torch import obs
    from repro_torch.core import api
    cases = [(alg, el["a32"], el["b32"], dict(algorithm=alg))
             for alg in api.algorithms()]
    cases += [(f"steal3d g={ELASTIC['steal_g']}", el["a3"], el["b3"],
               dict(algorithm="steal3d")),
              ("sparse A @ A", el["sparse"], el["sparse"],
               dict(output="auto"))]
    obs.enable(clear=True)
    try:
        plans = {label: api.plan_matmul(a, b, cache=False, validate="fast",
                                        **kw)
                 for label, a, b, kw in cases}
        fast = span_ms(obs.events(), "plan_build.validate")
        obs.clear_trace()
        full_cases = [c for c in cases if not c[0].startswith("steal3d g")]
        for label, a, b, _ in full_cases:
            plans[label].validate("full", a, b)
            torch.cuda.synchronize()
        full = span_ms(obs.events(), "plan_build.validate")
    finally:
        obs.disable()
    check(plans["sparse A @ A"].output == "sparse",
          "the scale-16 A @ A did not resolve to a sparse output")
    check(len(fast) == len(cases) and len(full) == len(full_cases)
          and all({"fast", "full"} <= plans[c[0]]._validated
                  for c in full_cases),
          "a validation did not run or did not pass")
    res = {"fast_ms": dict(zip([c[0] for c in cases], fast)),
           "full_ms": dict(zip([c[0] for c in full_cases], full))}
    for label, ms in res["fast_ms"].items():
        full_ms = res["full_ms"].get(label)
        log(f"  validate fast {label} ({plans[label].algorithm.name}, wire "
            f"{plans[label].wire}): clean in {ms:.1f} ms of host time"
            + ("" if full_ms is None else f"; full: {full_ms:.1f} ms (one "
               "multiply under the op-trace lint)"))
    return res


def elastic_replan(el: dict) -> dict:
    """The elastic selftest's drift check at the SpMM cell: ``auto`` at g 2
    on the fast-net H100 machine, one traced multiply against the oracle,
    8x straggler drift injected on the auto plan's series and on
    ``FIT_SERIES``, ``should_replan()`` trips, ``replan()`` refits and
    evicts, and the replanned multiply meets the oracle.  The fit reads
    the injected records only (the traced multiply's own record, one
    card's seconds against g x g modelled H100s, is printed and dropped
    first), and its rows must have rank 2, so that both unknowns are
    determined (steal3d's records carry a structure-dependent cost and are
    not fitted; summa_ag's row is half of summa_bcast's, so the two alone
    give rank 1).  Its ``net_bw`` and ``hop_latency`` describe those
    records, not the H100."""
    from repro_torch import obs
    from repro_torch.core import api
    from repro_torch.core.roofline import H100_SXM
    from repro_torch.launch.selftest import fast_net_machine
    from repro_torch.runtime.faultinject import record_straggler_drift
    from repro_torch.runtime.replan import ElasticReplanner, ReplanConfig
    a32, b32 = el["a32"], el["b32"]
    base = fast_net_machine()
    preset = dataclasses.astuple(H100_SXM)
    obs.reset_all()
    obs.enable(clear=True)
    api.set_drift_machine(base)
    try:
        p0 = api.plan_matmul(a32, b32, algorithm="auto", machine=base)
        # a cached plan keeps the scores of the auto_select that first
        # built it; the scores printed here are this machine's
        choice0, scores0 = api.auto_select(a32, b32, machine=base)
        check(choice0 == p0.algorithm.name,
              f"auto planned {p0.algorithm.name}, auto_select says {choice0}")
        out = p0(a32, b32)
        err, share, ok = compare(out, el["oracle"], el["scale"], TOL_F32_DEEP)
        del out
        (real,) = obs.drift_records()
        log(f"  auto on {base.name}: {p0.algorithm.name} (scores in us "
            f"{us(scores0)}); traced multiply max_abs_err {err:.3e}, {share:.3g} of its "
            f"allowance; its drift record: predicted "
            f"{real['predicted_s'] * 1e3:.4f} ms for {a32.g ** 2} modelled "
            f"cards, measured {real['measured_s'] * 1e3:.3f} ms on this one")
        check(ok, f"the auto plan ({p0.algorithm.name}) disagrees with the "
              "oracle")
        obs.reset_drift()
        plans = [p0] + [api.plan_matmul(a32, b32, algorithm=alg)
                        for alg in FIT_SERIES if alg != p0.algorithm.name]
        for plan in plans:
            record_straggler_drift(plan, factor=ELASTIC["factor"],
                                   n=ELASTIC["records"], machine=base)
        rp = ElasticReplanner(machine=base,
                              config=ReplanConfig(drift_ratio=2.0))
        trips = rp.should_replan()
        log(f"  trips: {trips}")
        check(bool(trips), "8x straggler drift did not trip the replanner")
        t0 = time.perf_counter()
        res = rp.replan(a32, b32, trips=trips)
        replan_s = time.perf_counter() - t0
        choice1, scores1 = api.auto_select(a32, b32, machine=res.machine)
        check(choice1 == res.algorithm == res.plan.algorithm.name,
              f"the replan chose {res.algorithm} and built "
              f"{res.plan.algorithm.name}; auto_select says {choice1}")
        out = res.plan(a32, b32)
        err2, share2, ok2 = compare(out, el["oracle"], el["scale"],
                                    TOL_F32_DEEP)
        del out
        events = obs.events()
    finally:
        api.set_drift_machine(None)
        obs.disable()
    m = res.machine
    log(f"  replan: {p0.algorithm.name} -> {res.algorithm} (scores in us "
        f"{us(scores1)}), evicted {res.evicted} plans, {replan_s * 1e3:.1f} ms of host "
        f"time (refit {span_ms(events, 'replan.refit')[0]:.1f} ms); the fit "
        f"of the injected records (a model of the stacked executor's "
        f"straggler, not of the H100): net_bw {m.net_bw:.4e} B/s, "
        f"hop_latency {m.hop_latency:.4e} s over {res.fit_diag['n_used']} "
        f"of {res.fit_diag['n_records']} records (series "
        f"{[p.algorithm.name for p in plans]}, rank "
        f"{res.fit_diag['rank']}); replanned multiply max_abs_err "
        f"{err2:.3e}, {share2:.3g} of its allowance")
    check(res.fit_diag["rank"] == 2,
          f"the fit's rows have rank {res.fit_diag['rank']}: the injected "
          "series do not determine net_bw and hop_latency")
    check(res.evicted > 0, "the replan evicted no plan")
    check(ok2, f"the replanned plan ({res.algorithm}) disagrees with the "
          "oracle")
    check(dataclasses.astuple(H100_SXM) == preset,
          "the fit was written into the H100 preset")
    return {"before": p0.algorithm.name, "after": res.algorithm,
            "scores_before_ms": {k: v * 1e3 for k, v in scores0.items()},
            "scores_after_ms": {k: v * 1e3 for k, v in scores1.items()},
            "evicted": res.evicted, "replan_host_ms": replan_s * 1e3,
            "fit": res.fit_diag, "max_abs_err": err2}


def elastic_recovery(el: dict) -> dict:
    """steal3d at g 3 (``validate="fast"``), against the oracle; the seeded
    loss of 5 of its 9 devices; ``recover_from_loss`` onto g 2, with no
    floating-point data copied to the host; the recovered multiply against
    the oracle, B1's launches and the blocks it multiplied (counted on the
    card) against the recovered plan's real pairs; the recovery's host
    time by span and the recovered multiply's device time."""
    from repro_torch import obs
    from repro_torch.analysis.op_lint import host_transfers
    from repro_torch.core import api
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    from repro_torch.runtime.faultinject import DeviceLoss
    from repro_torch.runtime.replan import ElasticReplanner
    a3, b3 = el["a3"], el["b3"]
    p3 = api.plan_matmul(a3, b3, algorithm="steal3d", validate="fast")
    out = p3(a3, b3)
    err, share, ok = compare(out, el["oracle"], el["scale"], TOL_F32_DEEP)
    del out
    check(ok, "steal3d at g 3 disagrees with the oracle")
    loss = DeviceLoss(ELASTIC["devices"], ELASTIC["lost"],
                      seed=ELASTIC["seed"])
    obs.reset_all()
    obs.enable(clear=True)
    try:
        rec, to_host = host_transfers(lambda: ElasticReplanner()
                                      .recover_from_loss(a3, b3,
                                                         loss.survivors()))
        torch.cuda.synchronize()
        events = obs.events()
    finally:
        obs.disable()
    spans = {name: sum(span_ms(events, name)) for name in (
        "replan.recover", "replan.evict", "replan.reshard", "replan.lpt",
        "replan.coverage", "plan_build", "plan_build.validate")}
    log(f"  loss of {loss.lost()}: survivors {loss.survivors()} -> g "
        f"{rec.g}, evicted {rec.evicted}; moved items "
        f"{rec.assignment.n_moved}; host ms by span "
        f"{ {k: round(v, 1) for k, v in spans.items()} }; floating-point "
        f"copies to the host: {to_host or 'none'}")
    check(rec.g == 2 and rec.evicted > 0, "recovery did not shrink to g 2")
    check(not to_host, f"recovery copied data to the host: {to_host}")
    before = bsr_spmm_cuda.launches
    out, multiplied = counted_blocks(lambda: rec.plan(rec.a, rec.b))
    launches = bsr_spmm_cuda.launches - before
    err2, share2, ok2 = compare(out, el["oracle"], el["scale"], TOL_F32_DEEP)
    del out
    real = rec.plan._steal.real_pairs
    want = rec.g * int(rec.a.counts.sum())
    log(f"  recovered multiply: B1 {launches} launch(es), {multiplied} "
        f"blocks multiplied (counted on the card), the plan's real pairs "
        f"{real} (g x A's real blocks {want}); max_abs_err {err2:.3e}, "
        f"{share2:.3g} of its allowance")
    check(launches == len(rec.plan._steal.segments) and multiplied == real
          == want, "the recovered multiply's B1 blocks differ from the "
          "plan's real pairs")
    check(ok2, "the recovered multiply disagrees with the oracle")
    ms = time_ms(lambda: rec.plan(rec.a, rec.b), reps=3)
    log(f"  recovered multiply: {ms:.2f} ms on the card (CUDA events, mean "
        f"of 3)")
    return {"survivors": loss.survivors(), "g": rec.g,
            "evicted": rec.evicted, "host_ms": spans,
            "recovered_ms": ms, "blocks_multiplied": multiplied,
            "real_pairs": real, "max_abs_err": err2,
            "preloss_max_abs_err": err}


def elastic_serving(gate_tokens: dict) -> dict:
    """A second float32 run of the serving gate's four OLMoE-1B-7B
    requests through ``ServeEngine(sparse=True, replanner=
    ElasticReplanner())``: 8x straggler drift on the engine's cached
    plans after the first prefill; the engine drains and refits once, and
    its tokens equal the gate's."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.faultinject import record_straggler_drift
    from repro_torch.runtime.replan import ElasticReplanner
    cfg16 = get_config(SERVE["arch"])
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32")
    model = tf.init_params(cfg16, seed=SERVE["seed"], device=DEVICE)
    prompts = serve_prompts(cfg16)
    api.clear_plan_cache()
    obs.reset_all()
    rp = ElasticReplanner()
    eng = serve_engine(model, cfg32, prompts, replanner=rp)
    admit, injected = eng._admit, []

    def admit_then_drift(req):
        admit(req)
        if not injected:
            plans = {p.algorithm.name: p for p in api._PLAN_CACHE.values()}
            for plan in plans.values():
                record_straggler_drift(plan, factor=ELASTIC["factor"],
                                       n=ELASTIC["records"])
            injected.extend(sorted(plans))

    eng._admit = admit_then_drift
    try:
        t0 = time.perf_counter()
        results = eng.run()
        run_s = time.perf_counter() - t0
    finally:
        api.set_drift_machine(None)
    snap = obs.registry().snapshot()
    equal = {rid: results[rid].tolist() == gate_tokens[rid]
             for rid in gate_tokens}
    log(f"  drift injected on {injected} after the first prefill; replans "
        f"{eng.replans} (serve.replan_s "
        f"{snap.get('serve.replan_s', {}).get('mean', float('nan')):.3f} s), "
        f"plans evicted {snap.get('replan.plans_evicted', 0)}; run "
        f"{run_s:.1f} s; tokens equal to the gate's: {equal}")
    check(eng.replans == 1 and snap.get("serve.replans") == 1
          and snap.get("replan.refits") == 1,
          f"the engine replanned {eng.replans} times")
    check(all(equal.values()), "the replanned run's tokens differ from the "
          "gate's")
    del model, eng
    free()
    return {"replans": 1, "injected": injected, "run_s": run_s,
            "evicted": snap.get("replan.plans_evicted", 0)}


def selftest_subprocess() -> dict:
    """``python -m repro_torch.launch.selftest --check all --g 3`` on the
    card, as a subprocess whose exit code is checked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--check",
         "all", "--g", "3"], env=env, cwd=str(ROOT), capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    n_ok = sum(1 for ln in lines if "[ok]" in ln)
    failed = [ln for ln in lines if "[FAIL]" in ln]
    log(f"  selftest --check all --g 3: exit {proc.returncode} in "
        f"{secs:.1f} s, {n_ok} checks ok, failed {failed or 'none'}; last "
        f"line: {lines[-1] if lines else proc.stderr[-2000:]}")
    check(proc.returncode == 0 and lines and lines[-1] == "SELFTEST PASSED",
          f"the selftest failed: {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return {"exit": proc.returncode, "checks_ok": n_ok, "s": secs}


def elastic_phase(sparse_h, gate_tokens: dict) -> dict:
    """Phase 13 at the SpMM cell's full width, with every launch count
    set to 0 before each part and read after it."""
    from repro_torch.core.api import DistBSR, DistDense
    a_np, a32, a16, b_np, b32, b16 = main_path_operands(DEVICE)
    del a16, b16
    a3 = DistBSR.from_dense(a_np, g=ELASTIC["steal_g"],
                            block_size=SPMM["block_size"], device=DEVICE)
    b3 = DistDense.for_rhs(b_np, a3)
    a_dense = torch.from_numpy(a_np).to(DEVICE)
    del a_np
    b_t = torch.from_numpy(b_np).to(DEVICE)
    el = {"a32": a32, "b32": b32, "a3": a3, "b3": b3, "sparse": sparse_h,
          "oracle": a_dense @ b_t, "scale": a_dense.abs() @ b_t.abs()}
    del a_dense, b_t
    res, launches = {}, {}
    for part, fn in (("validation", elastic_validation),
                     ("replan", elastic_replan),
                     ("recovery", elastic_recovery)):
        log(f"-- {part}")
        reset_counts()
        res[part] = fn(el)
        launches[part] = read_counts()
        log(f"  launches: {launches[part]}")
    del el
    free()
    log("-- serving with the real replanner (float32, OLMoE-1B-7B)")
    reset_counts()
    res["serving"] = elastic_serving(gate_tokens)
    launches["serving"] = read_counts()
    log(f"  launches: {launches['serving']}")
    for part in ("validation", "replan", "recovery", "serving"):
        check(launches[part]["bsr_spmm"] > 0,
              f"phase 13's {part} launched no B1")
    check(launches["validation"]["bsr_pair_accumulate"] > 0
          and launches["serving"]["bsr_pair_accumulate"] > 0,
          "phase 13 launched no B2")
    log("-- the selftest entry point")
    res["selftest"] = selftest_subprocess()
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# phase 14: the recurrent, SSM and frontend families
# ---------------------------------------------------------------------------
def ssd_exponents(cfg, model, step: int) -> list:
    """One untimed forward of ``model`` (no gradients) on the training
    batch of ``step``, with ``ssm._ssd_chunked`` wrapped so that each call
    records, on the card, the largest ``A dt (chunk - 1)`` it is given and
    the largest exponent the reference's unmasked decay ``exp(cs_i - cs_j)``
    would take above the diagonal (the most ``A dt`` summed over a chunk
    after its first step).  The wrap is undone before this returns, so no
    timed or profiled step runs it.  Returns the two maxima."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import ssm, transformer as tf
    m = MAMBA_TRAIN
    orig = ssm._ssd_chunked
    seen = torch.zeros(2, device=DEVICE)

    def observed(xh, bmat, cmat, dt, a_log, chunk, **kw):
        adt = torch.exp(a_log.float()) * dt.float()             # [B,T,H]
        t = adt.shape[1]
        L = min(chunk, t)
        pad = (-t) % L
        per = torch.nn.functional.pad(adt, (0, 0, 0, pad)).reshape(
            adt.shape[0], -1, L, adt.shape[2])
        seen.copy_(torch.maximum(seen, torch.stack([
            adt.amax() * (L - 1), per[:, :, 1:].sum(2).amax()])))
        return orig(xh, bmat, cmat, dt, a_log, chunk, **kw)

    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in SyntheticLM(
        cfg, m["batch"], m["seq"], seed=m["seed"])(step).items()}
    ssm._ssd_chunked = observed
    try:
        with torch.no_grad():
            tf.forward(model, batch, cfg)
    finally:
        ssm._ssd_chunked = orig
    return seen.tolist()


def train_published_family(spec: dict, extra_checks=None,
                           before=None) -> dict:
    """``spec["arch"]`` at its published width and depth through
    ``train()``: bf16 compute over float32 parameters and AdamW state,
    remat on, no checkpoint.  Finite losses and gradient norms, each step's
    wall time, tokens (or frames) a second, peak memory; B1-B3 launch no
    time.  ``before(cfg, model)``, if given, reads the freshly initialised
    model (``train()``'s own ``init_params``) before the first step, out of
    the timed run; ``extra_checks(cfg, state, pre)`` reads the trained one
    after the profiled steps, ``pre`` what ``before`` returned."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tf
    cfg = get_config(spec["arch"])
    check(cfg.compute_dtype == "bfloat16" and cfg.remat,
          f"{cfg.name} is not the published configuration")
    free()
    torch.cuda.reset_peak_memory_stats()
    log(describe(cfg) + f": {exact_params(cfg)} parameters "
        f"({cfg.param_count()} by param_count())")
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=spec["seed"], device=DEVICE)
    init_s = time.perf_counter() - t0
    pre = {} if before is None else before(cfg, model)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = train(cfg, steps=spec["steps"], batch=spec["batch"],
                  seq=spec["seq"], lr=spec["lr"], seed=spec["seed"],
                  ckpt_dir=None, device=DEVICE, log_every=1, params=model)
    run_s = init_s + time.perf_counter() - t0
    del model
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in state["params"].parameters())
    check(n_params == exact_params(cfg), f"parameter count {n_params} "
          f"differs from {exact_params(cfg)}")
    check(not any(counts.values()), f"training launched a sparse kernel: "
          f"{counts}")
    losses, gnorms = np.asarray(state["losses"]), np.asarray(
        state["grad_norms"])
    check(len(losses) == spec["steps"] and np.isfinite(losses).all()
          and np.isfinite(gnorms).all(),
          f"{cfg.name}: non-finite loss or gradient norm: {losses}, {gnorms}")
    step_ms = [1e3 * x for x in state["step_s"]]
    warm_ms = statistics.median(step_ms[1:])
    tokens = spec["batch"] * spec["seq"]
    log(f"  {spec['steps']} steps of {spec['batch']} x {spec['seq']} in "
        f"{run_s:.1f} s (initialisation included); losses "
        f"{[round(float(x), 4) for x in losses]}; gradient norms "
        f"{[round(float(x), 4) for x in gnorms]}")
    log(f"  step wall ms (synchronised): {[round(x, 1) for x in step_ms]}; "
        f"median after the first {warm_ms:.1f} ms, "
        f"{tokens / (warm_ms / 1e3):.0f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB; launches {counts}")
    out = {"losses": losses.tolist(), "grad_norms": gnorms.tolist(),
           "step_ms": step_ms, "median_step_ms": warm_ms,
           "tokens_per_s": tokens / (warm_ms / 1e3), "peak_gb": peak_gb,
           "n_params": n_params, "run_s": run_s,
           "profile": train_profile(state["params"], state["opt"], cfg,
                                    spec)}
    if extra_checks is not None:
        out.update(extra_checks(cfg, state, pre))
    del state
    free()
    return out


def mamba_decode_check(cfg, state) -> dict:
    """The trained Mamba2-130m in float32 (TF32 off): a prefill of
    ``MAMBA_TRAIN["prefill"]`` tokens (a chunk and a padded part) and
    ``MAMBA_TRAIN["decode"]`` decode steps, whose logits equal the full
    forward's within ``DECODE_TOL`` (``tests/test_models_smoke.py``)."""
    import dataclasses as dc
    from repro_torch.models import lm, transformer as tf
    m = MAMBA_TRAIN
    cfg32 = dc.replace(cfg, compute_dtype="float32")
    model = state["params"]
    n = m["prefill"] + m["decode"]
    toks = torch.as_tensor(np.random.default_rng(m["seed"]).integers(
        0, cfg.vocab_size, (2, n)).astype(np.int32), device=DEVICE)
    with torch.no_grad():
        full, _, _ = tf.forward(model, {"tokens": toks}, cfg32)
    last, caches, pos = lm.prefill(model, {"tokens": toks[:, :m["prefill"]]},
                                   cfg32, n, torch.float32)
    step = lm.make_decode_step(cfg32)
    got, want = [last], [full[:, m["prefill"] - 1]]
    for t in range(m["prefill"], n):
        logits, caches = step(model, toks[:, t:t + 1], caches, pos)
        got.append(logits)
        want.append(full[:, t])
        pos = pos + 1
    got, want = torch.stack(got), torch.stack(want)
    err = (got - want).abs()
    share = (err / (DECODE_TOL * (1 + want.abs()))).max().item()
    log(f"  prefill {m['prefill']} + {m['decode']} decode steps against the "
        f"full forward (float32): max |diff| {err.max().item():.3e}, "
        f"{share:.3g} of the {DECODE_TOL} allowance")
    check(share <= 1.0, "Mamba decode steps leave the full forward's logits")
    return {"decode_max_abs_err": err.max().item(), "decode_share": share}


def mamba_published() -> dict:
    """Mamba2-130m trained at its published width and depth, the SSD's
    exponents read in an untimed forward before the first step and after
    the last; then its decode against its forward."""
    last = MAMBA_TRAIN["steps"] - 1
    res = train_published_family(
        MAMBA_TRAIN,
        before=lambda c, model: ssd_exponents(c, model, 0),
        extra_checks=lambda c, s, pre: {
            "ssd": ssd_report(c, pre, ssd_exponents(c, s["params"], last)),
            **mamba_decode_check(c, s)})
    first3, last3 = np.mean(res["losses"][:3]), np.mean(res["losses"][-3:])
    log(f"  mean of the first 3 losses {first3:.4f} -> last 3 {last3:.4f}")
    check(last3 < first3, f"Mamba2-130m's loss did not decrease: "
          f"{res['losses']}")
    return res


def ssd_report(cfg, first, after) -> dict:
    """The SSD's exponents read by :func:`ssd_exponents`: ``first`` with
    the initial model on step 0's batch, ``after`` with the trained one on
    the last step's batch."""
    adt, expo = max(first[0], after[0]), max(first[1], after[1])
    for label, (a, e) in (("initial model, step 0's batch", first),
                          ("trained model, the last step's batch", after)):
        log(f"  SSD (chunk {cfg.ssm.chunk}), {label}: largest A dt "
            f"(chunk - 1) {a:.2f}; largest exponent the reference's "
            f"unmasked decay would take {e:.2f}")
    log(f"  against float32's limit 88.72 the reference's gradient would "
        f"{'turn non-finite' if expo > 88.72 else 'stay finite'}")
    return {"max_adt_chunk": adt, "max_decay_exponent": expo,
            "first": first, "after": after,
            "reference_would_overflow": expo > 88.72}


def llava_decode() -> dict:
    """llava-next-mistral-7b at its published width and depth, weights in
    bf16: a timed
    ``lm.prefill`` of the patches and the text (finite logits), then one
    ``lm.greedy_decode`` of the new tokens, whose first token is the
    prefill's argmax."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.obs import sync_elapsed
    spec = LLAVA_DECODE
    cfg = get_config(spec["arch"])
    free()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, spec["seed"], dtype=torch.bfloat16)
    init_peak = phase_peak("llava initialisation (float32, then bf16)")
    rng = np.random.default_rng(spec["seed"])
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, spec["text"])).astype(np.int32),
        device=DEVICE),
        "patches": torch.as_tensor(rng.standard_normal(
            (1, cfg.num_patches, cfg.frontend_dim)).astype(np.float32),
            device=DEVICE)}
    t_in = cfg.num_patches + spec["text"]
    max_len = t_in + spec["new_tokens"]
    lm.prefill(model, batch, cfg, max_len, torch.float32)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, _, pos = lm.prefill(model, batch, cfg, max_len, torch.float32)
    prefill_s = sync_elapsed(t0, logits)
    check(tuple(logits.shape) == (1, cfg.vocab_size) and pos == t_in
          and bool(torch.isfinite(logits).all()),
          "llava's prefill logits are not finite logits of one position")
    t0 = time.perf_counter()
    toks = lm.greedy_decode(model, batch, cfg, spec["new_tokens"], max_len)
    decode_s = sync_elapsed(t0, toks)
    peak = phase_peak("llava prefill and greedy decode")
    check(tuple(toks.shape) == (1, spec["new_tokens"])
          and int(toks[0, 0]) == int(logits.argmax()),
          "llava's greedy decode does not start from the prefill's argmax")
    log(f"  prefill of {cfg.num_patches} patches + {spec['text']} tokens: "
        f"{prefill_s * 1e3:.1f} ms wall (warm); greedy_decode of "
        f"{spec['new_tokens']} tokens (prefill included) {decode_s:.2f} s; "
        f"tokens {toks[0].tolist()}; peak device memory {peak:.2f} GB "
        f"(initialisation {init_peak:.2f} GB)")
    del model
    free()
    return {"prefill_ms": prefill_s * 1e3, "greedy_s": decode_s,
            "tokens": toks[0].tolist(), "peak_gb": peak,
            "init_peak_gb": init_peak}


def recurrent_phase() -> dict:
    """Phase 14: RecurrentGemma-2B served at its published width and depth
    (the float32 gate, the bf16 run, B1 and B2 at its shapes), Mamba2-130m
    and hubert-xlarge trained, llava-next-mistral-7b decoded."""
    from repro_torch.core import api
    api.clear_plan_cache()
    free()
    log(f"  device memory allocated at the start (what earlier phases "
        f"hold): {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    out = {}
    log("-- RecurrentGemma-2B through ServeEngine(sparse=True): B2 and B1 "
        "in its 8 local-attention layers (window 2048, above max_len "
        f"{SERVE['max_len']}: the window prunes no block here)")
    out["serve"] = serving_phase(RECURRENT_SERVE)
    log("-- Mamba2-130m trained (published size)")
    out["mamba"] = mamba_published()
    log("-- hubert-xlarge trained (published width)")
    out["hubert"] = train_published_family(HUBERT_TRAIN)
    log("-- llava-next-mistral-7b: greedy decode after its patches")
    out["llava"] = llava_decode()
    return out


# ---------------------------------------------------------------------------
# Phase 15: the schedules on a process grid, 4 ranks on the card
# ---------------------------------------------------------------------------
# (label, dtype, algorithm, wire, overlap) of the SpMM cell's multiplies on
# the ranks: ring_c at both types, wires and overlaps, then the other five
GRID_DENSE = tuple(
    (f"ring_c {str(dt)[6:]} {wire} overlap={ov}", dt, "ring_c", wire, ov)
    for dt in (torch.float32, torch.bfloat16) for wire in ("padded", "packed")
    for ov in ("on", "off")) + tuple(
    (f"{alg} float32", torch.float32, alg, "auto", "auto")
    for alg in ("summa_bcast", "summa_ag", "ring_a", "ring_c_bidir",
                "steal3d"))
GRID_SPARSE = ("ring_c", "summa_ag", "summa_bcast")
GRID = dict(g=2, backend="gloo", timeout_s=420, reps=2)


def grid_body_bytes(alg: str, plan, g: int) -> float:
    """What a rank sends in one multiply's body, from the plan's cost dict
    (tests/test_torch_grid.py holds the same relation on the CPU): the
    rings and ``summa_bcast`` (g - 1) x ``net_bytes_per_step`` (g - 1
    shifts, or a root's tile to g - 1 peers), ``summa_ag`` g x it,
    ``ring_a`` (g - 1) x it + one C tile (C's last hop home), steal3d the
    dict's one dispatch."""
    net = plan.cost_model()["net_bytes_per_step"]
    if alg in ("ring_c", "ring_c_bidir", "summa_bcast"):
        return (g - 1) * net
    if alg == "summa_ag":
        return g * net
    if alg == "ring_a":
        geom = plan.geom
        return (g - 1) * net + geom.tm * geom.tn * geom.out_dtype.itemsize
    return net


def tile_sums(blocks: torch.Tensor, chunk: int = 1 << 24) -> tuple:
    """An exact fingerprint of a tile of integer-valued blocks: its nonzero
    count, sum and position-weighted sum, in float64 (exact below 2^53),
    taken ``chunk`` elements at a time (a sparse C tile is 1.9 GB)."""
    x = blocks.reshape(-1)
    nz, total, weighted = 0, 0.0, 0.0
    for lo in range(0, x.numel(), chunk):
        part = x[lo:lo + chunk].double()
        w = (torch.arange(lo, lo + part.numel(), device=x.device) % 997
             + 1).double()
        nz += int(torch.count_nonzero(part).item())
        total += float(part.sum().item())
        weighted += float((part * w).sum().item())
    return nz, total, weighted


def host_tiled(t):
    """A TiledBSR's copy in host memory, its host layout kept."""
    h = dataclasses.replace(t, blocks=t.blocks.cpu(), rows=t.rows.cpu(),
                            cols=t.cols.cpu(), counts=t.counts.cpu())
    h.host_layout = t.host()
    return h


def grid_expected(tmp: Path, device) -> dict:
    """The stacked executor's results for phase 15's multiplies, written
    for the ranks: the operands in host memory (one file, which each rank
    maps) and, per rank, its C tiles with their |A| @ |B| scales (dense
    outputs) and its C tile's structure fingerprint and sums (sparse)."""
    from repro_torch.core import api
    from repro_torch.core.api import DistBSR
    from repro_torch.core.bsr import rmat_matrix
    g = GRID["g"]
    a_np, a32, a16, b_np, b32, b16 = main_path_operands(device)
    a_dense = torch.from_numpy(a_np).to(device)
    del a_np
    b_t = torch.from_numpy(b_np).to(device)
    scales = {torch.float32: a_dense.abs() @ b_t.abs(),
              torch.bfloat16: a_dense.abs() @ b_t.bfloat16().float().abs()}
    del a_dense, b_t
    handles = {torch.float32: (a32, b32), torch.bfloat16: (a16, b16)}
    tm, tn = a32.tile_shape[0], b32.tile_shape[1]
    per_rank = [{"dense": {}, "sparse": {}} for _ in range(g * g)]
    stacked = {}
    for label, dtype, alg, wire, overlap in GRID_DENSE:
        a_h, b_h = handles[dtype]
        kw = dict(algorithm=alg, wire=wire)
        out, blocks = counted_blocks(lambda: api.matmul(a_h, b_h, **kw))
        stacked[label] = {"blocks_multiplied": blocks}
        for r in range(g * g):
            i, j = divmod(r, g)
            sl = (slice(i * tm, (i + 1) * tm), slice(j * tn, (j + 1) * tn))
            per_rank[r]["dense"][label] = {
                "tile": out[sl].cpu(), "scale": scales[dtype][sl].cpu()}
        del out
    ops = {"a": host_tiled(a32.tiled), "b": b_np}
    del a32, a16, b32, b16, handles, scales
    free()
    cfg = SPARSE
    t0 = time.perf_counter()
    s_np = rmat_matrix(cfg["scale"], cfg["edgefactor"], seed=cfg["seed"])
    s_h = DistBSR.from_dense(s_np, g=g, block_size=cfg["block_size"],
                             device=device)
    del s_np
    ops["s"] = host_tiled(s_h.tiled)
    for alg in GRID_SPARSE:
        c, pairs = counted(lambda: api.matmul(s_h, s_h, algorithm=alg,
                                              output="sparse"),
                           kernel_wrappers()["bsr_pair_accumulate"])
        stacked[f"{alg} sparse"] = {"pairs_multiplied": pairs}
        fp = c.grid_structure().fingerprint
        for r in range(g * g):
            i, j = divmod(r, g)
            per_rank[r]["sparse"][alg] = {
                "fingerprint": fp, "sums": tile_sums(c.tiled.blocks[i, j])}
        del c
    del s_h
    free()
    paths = {"ops": str(tmp / "ops.pt"),
             "expected": [str(tmp / f"expected{r}.pt")
                          for r in range(g * g)]}
    torch.save(ops, paths["ops"])
    for r in range(g * g):
        torch.save(per_rank[r], paths["expected"][r])
    log(f"  the stacked executor's results and the operands written for the "
        f"ranks in {time.perf_counter() - t0:.1f} s (sparse cell and files)")
    return {"paths": paths, "stacked": stacked}


def grid_busy_ms(ex, plan, a_h, b_h, kernel: str):
    """This rank's device time in ``kernel`` over one multiply of ``plan``
    (``torch.profiler``), or None where the trace holds fewer of its
    launches than the wrappers counted."""
    from repro_torch.core import api
    from repro_torch.obs import sync_elapsed
    before = read_counts()
    ex.barrier()
    with torch.profiler.profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        sync_elapsed(t0, api._result_tensor(plan(a_h, b_h)))
    launched = sum(v - before[k] for k, v in read_counts().items())
    events = [e for e in device_events(prof) if e[0] == kernel]
    return sum(e[2] - e[1] for e in events) / 1e3 \
        if len(events) == launched else None


def grid_rank_b1(ex, plan32, a32, b32) -> dict:
    """B1 at a rank's one-tile SpMM shape (its first ring step) against
    its plain version, bound and library yardsticks, while the other
    ranks wait."""
    from repro_torch.core import api
    from repro_torch.core.dist import placement_index
    g = ex.g
    placed = api._rank_tree(a32, api.SKEW_ROWS, False, ex)
    blocks, rows, cols = (placed[k][None] for k in ("blocks", "rows",
                                                    "cols"))
    dense = api._densify_b(api._rank_tree(b32, api.SKEW_COLS, False, ex),
                           plan32.geom, ex)["dense"][None]
    held = int(plan32.step_maps()[0][0][0][ex.position])
    table = plan32._rank_table(a32, (held,), 0)
    nbr = plan32.geom.a_nbr
    label = f"one-tile SpMM (a rank of the {g}x{g} grid) float32"
    b1 = kernel_case(blocks, rows, cols, dense, nbr, TOL_F32_DEEP, label,
                     table=table, reps=10)
    real = a32.pool_lists(False).take(
        placement_index(api.SKEW_ROWS, g)[[held]]).real
    b1.update(b1_yardsticks(blocks, rows, cols, dense, nbr, real,
                            TOL_F32_DEEP, label))
    b1["shape"] = {"T": 1, "S": blocks.shape[1], "bs": blocks.shape[-1],
                   "n": dense.shape[-1]}
    return b1


def grid_rank_b2(ex, plan_s, s_h) -> dict:
    """B2 at a rank's one-tile sparse-output shape (its first ring step)
    against its plain version, bound and cuSPARSE ``CSR @ CSR``."""
    from repro_torch.core import api
    from repro_torch.core.dist import placement_tiles
    g = ex.g
    a0 = api._rank_tree(s_h, api.SKEW_ROWS, True, ex, True)["blocks"][None]
    b0 = api._rank_tree(s_h, api.SKEW_COLS, True, ex, True)["blocks"][None]
    st = plan_s._pairs[0]
    real_p = plan_s._pair_real[:, :, 0].reshape(g * g, -1)[
        ex.position:ex.position + 1]
    b2 = pair_acc_case(a0, b0, st["pa"], st["pb"], st["ps"],
                       plan_s.geom.c_store, "one-tile sparse output (a rank "
                       f"of the {g}x{g} grid) float32", real_p,
                       table=st["table"], reps=5)
    tiles = [tuple(int(x) for x in placement_tiles(pl, g)[ex.i, ex.j])
             for pl in (api.SKEW_ROWS, api.SKEW_COLS)]
    csr_a = blockdiag_csr(s_h.tiled, tiles[:1]).to(a0.device)
    csr_b = blockdiag_csr(s_h.tiled, tiles[1:]).to(a0.device)
    b2["library_ms"] = csr_yardstick(csr_a, csr_b, ops_sum(a0, b0, st),
                                     "B2 one-tile step 0 float32")
    b2["shape"] = {"T": 1, "P": int(st["pa"].shape[1]),
                   "bs": a0.shape[-1], "slots": plan_s.geom.c_store}
    return b2


def grid_rank(ex, spec: dict) -> dict:
    """Phase 15 on one rank: the SpMM cell's multiplies and the sparse
    cell's sparse outputs through ``mesh=``, each rank's C tile held
    against the stacked executor's, the blocks and pairs its launches
    multiplied against its tables', its bytes against the cost model; the
    slowest rank's wall per multiply, the rank's host staging and
    transport time.  Returns the rank's figures (checks raise)."""
    from repro_torch.core import api
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.obs import sync_elapsed
    t_start = time.perf_counter()
    g, dev = ex.g, ex.device
    ops = torch.load(spec["ops"], mmap=True, weights_only=False)
    want = torch.load(spec["expected"][ex.rank], weights_only=False)
    t16 = dataclasses.replace(ops["a"], blocks=ops["a"].blocks.to(
        torch.bfloat16))
    t16.host_layout = ops["a"].host_layout
    a32, a16 = DistBSR(ops["a"]), DistBSR(t16)
    b32 = DistDense.for_rhs(ops["b"], a32, device="cpu")
    b16 = DistDense.for_rhs(torch.from_numpy(ops["b"]).bfloat16(), a16,
                            device="cpu")
    s_h = DistBSR(ops["s"])
    handles = {torch.float32: (a32, b32), torch.bfloat16: (a16, b16)}
    wrappers = kernel_wrappers()
    b1w, b2w = wrappers["bsr_spmm"], wrappers["bsr_pair_accumulate"]
    out = {"rank": ex.rank, "transport": ex.transport, "dense": {},
           "sparse": {}, "setup_s": time.perf_counter() - t_start}
    reset_counts()

    def timed(plan, a_h, b_h):
        """The slowest rank's wall of one multiply (started together),
        with this rank's staging and transport host time."""
        ex.barrier()
        t0 = time.perf_counter()
        res = plan(a_h, b_h)
        local = sync_elapsed(t0, api._result_tensor(res))
        return (ex.max_over_ranks(local) * 1e3, ex.stage_s * 1e3,
                ex.wait_s * 1e3)

    for label, dtype, alg, wire, overlap in GRID_DENSE:
        a_h, b_h = handles[dtype]
        plan = api.plan_matmul(a_h, b_h, algorithm=alg, wire=wire,
                               overlap=overlap, mesh=ex)
        b1w.table_blocks = 0
        res, blocks = counted_blocks(lambda: plan(a_h, b_h))
        table_blocks = b1w.table_blocks
        body, place = ex.bytes_sent("body"), ex.bytes_sent("place")
        exp = want["dense"][label]
        tile = exp["tile"].to(dev)
        step = BF16_STEP if dtype == torch.bfloat16 else 0.0
        err, share, ok = compare(res.tile, tile, exp["scale"].to(dev),
                                 TOL_F32_DEEP, step)
        equal = bool(torch.equal(res.tile, tile))
        del res, tile
        check(ok, f"rank {ex.rank}, {label}: its C tile disagrees with the "
              f"stacked executor's (max_abs_err {err:.3e})")
        check(blocks == table_blocks, f"rank {ex.rank}, {label}: B1 "
              f"multiplied {blocks} blocks, its tables' real ones are "
              f"{table_blocks}")
        expect = grid_body_bytes(alg, plan, g)
        check(abs(body - expect) <= 1e-9 * expect, f"rank {ex.rank}, "
              f"{label}: sent {body} bytes in the body, the cost model's "
              f"relation gives {expect}")
        times = [timed(plan, a_h, b_h) for _ in range(GRID["reps"])]
        out["dense"][label] = {
            "max_abs_err": err, "share_of_tolerance": share,
            "equal_to_stacked": equal, "blocks_multiplied": blocks,
            "body_bytes": body, "place_bytes": place,
            "overlap_body": plan.geom.overlap, "wire": plan.wire,
            "wall_ms": [t[0] for t in times],
            "stage_ms": [t[1] for t in times],
            "wait_ms": [t[2] for t in times]}
    out["dense_s"] = time.perf_counter() - t_start
    plan32 = api.plan_matmul(a32, b32, algorithm="ring_c", wire="padded",
                             overlap="off", mesh=ex)
    out["B1 busy_ms"] = grid_busy_ms(ex, plan32, a32, b32, "spmm_kernel")
    # the main path's launches, before the kernel checks launch more
    launches = read_counts()
    ex.barrier()
    if ex.rank == 0:
        out["kernels"] = {"bsr_spmm": grid_rank_b1(ex, plan32, a32, b32)}
    ex.barrier()
    # the dense cells' placed tiles, plans and tables leave the card
    del plan32, plan, a_h, b_h, a32, a16, b32, b16, handles, t16
    api.clear_plan_cache()
    free()
    out["dense_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for alg in GRID_SPARSE:
        plan = api.plan_matmul(s_h, s_h, algorithm=alg, output="sparse",
                               mesh=ex)
        b2w.table_pairs = 0
        res, pairs = counted(lambda: plan(s_h, s_h), b2w)
        table_pairs = b2w.table_pairs
        exp = want["sparse"][alg]
        fp = res.grid_structure().fingerprint
        sums = tile_sums(res._local["blocks"])
        del res
        check(fp == exp["fingerprint"] and sums == tuple(exp["sums"]),
              f"rank {ex.rank}, sparse {alg}: its C tile is not the "
              f"stacked executor's (structure {fp == exp['fingerprint']}, "
              f"sums {sums} vs {exp['sums']})")
        check(pairs == table_pairs, f"rank {ex.rank}, sparse {alg}: B2 "
              f"multiplied {pairs} pairs, its tables' real ones are "
              f"{table_pairs}")
        body = ex.bytes_sent("body")
        expect = grid_body_bytes(alg, plan, g)
        check(abs(body - expect) <= 1e-9 * expect, f"rank {ex.rank}, "
              f"sparse {alg}: sent {body} bytes in the body, the cost "
              f"model's relation gives {expect}")
        times = [timed(plan, s_h, s_h) for _ in range(GRID["reps"])]
        out["sparse"][alg] = {
            "pairs_multiplied": pairs, "body_bytes": body,
            "wall_ms": [t[0] for t in times],
            "stage_ms": [t[1] for t in times],
            "wait_ms": [t[2] for t in times]}
        del plan
        free()
    plan_s = api.plan_matmul(s_h, s_h, algorithm="ring_c", output="sparse",
                             mesh=ex)
    out["B2 busy_ms"] = grid_busy_ms(ex, plan_s, s_h, s_h, "pair_kernel")
    out["launches"] = {k: v + launches[k] for k, v in read_counts().items()}
    ex.barrier()
    if ex.rank == 0:
        out["kernels"]["bsr_pair_accumulate"] = grid_rank_b2(ex, plan_s,
                                                             s_h)
    ex.barrier()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["rank_s"] = time.perf_counter() - t_start
    return out


def grid_phase(card: str) -> dict:
    """Phase 15: the schedules on a 2x2 process grid of ranks sharing the
    one card, through launch/grid.py with the gloo transport (each rank
    stages its tiles through pinned host memory).  The stacked executor's
    results come first; the parent then frees its card memory and spawns
    the ranks, which run :func:`grid_rank`."""
    import tempfile

    import chip_smoke     # the ranks import the rank function by this name
    from repro_torch.core import api
    from repro_torch.core.dist import make_grid_mesh
    from repro_torch.launch.grid import run_grid
    api.clear_plan_cache()
    free()
    t0 = time.perf_counter()
    g = GRID["g"]
    try:
        make_grid_mesh(g, backend="nccl", device_type="cuda")
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "Duplicate GPU detected" in refused,
          f"make_grid_mesh({g}, backend='nccl') on {torch.cuda.device_count()}"
          " card(s) did not refuse")
    log(f"  make_grid_mesh({g}, backend='nccl') refused at once: {refused}")
    with tempfile.TemporaryDirectory() as tmp:
        expected = grid_expected(Path(tmp), torch.device(DEVICE))
        free()
        torch.cuda.synchronize()
        log(f"  parent: device memory allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB before the ranks "
            f"start; stacked results in {time.perf_counter() - t0:.1f} s")
        t_ranks = time.perf_counter()
        ranks = run_grid(g, chip_smoke.grid_rank, expected["paths"],
                         backend=GRID["backend"], device=DEVICE,
                         timeout_s=GRID["timeout_s"])
        ranks_s = time.perf_counter() - t_ranks
    stacked = expected["stacked"]
    log(f"  {len(ranks)} ranks on {torch.cuda.device_count()} card(s), "
        f"transport {ranks[0]['transport']}, {ranks_s:.1f} s of ranks "
        f"(setup {max(r['setup_s'] for r in ranks):.1f} s); {card}")
    res = {"transport": ranks[0]["transport"], "ranks_s": ranks_s,
           "nccl_refusal": refused, "dense": {}, "sparse": {},
           "peak_gb": [r["peak_gb"] for r in ranks]}
    for label, *_ in GRID_DENSE:
        rs = [r["dense"][label] for r in ranks]
        blocks = sum(r["blocks_multiplied"] for r in rs)
        want = stacked[label]["blocks_multiplied"]
        check(blocks == want, f"{label}: the ranks' B1 launches multiplied "
              f"{blocks} blocks, the stacked plan's {want}")
        wall = [statistics.median(x) for x in zip(*(r["wall_ms"]
                                                      for r in rs))]
        res["dense"][label] = {
            "wall_ms": statistics.median(rs[0]["wall_ms"]),
            "blocks_multiplied": blocks,
            "equal_to_stacked": [r["equal_to_stacked"] for r in rs],
            "max_share_of_tolerance": max(r["share_of_tolerance"]
                                          for r in rs),
            "body_bytes": [r["body_bytes"] for r in rs],
            "stage_ms": [statistics.median(r["stage_ms"]) for r in rs],
            "wait_ms": [statistics.median(r["wait_ms"]) for r in rs],
            "overlap_body": rs[0]["overlap_body"], "wire": rs[0]["wire"]}
        d = res["dense"][label]
        log(f"  {label} [{d['wire']}, split step {d['overlap_body']}]: "
            f"wall {d['wall_ms']:.1f} ms (slowest rank, runs {wall}); "
            f"body bytes per rank {d['body_bytes']}; host staging "
            f"{[round(x, 1) for x in d['stage_ms']]} ms and transport wait "
            f"{[round(x, 1) for x in d['wait_ms']]} ms by rank; B1 blocks "
            f"{blocks} (= stacked); C tiles equal to stacked "
            f"{d['equal_to_stacked']}, worst {d['max_share_of_tolerance']:.3g}"
            " of the allowance")
    for alg in GRID_SPARSE:
        rs = [r["sparse"][alg] for r in ranks]
        pairs = sum(r["pairs_multiplied"] for r in rs)
        want = stacked[f"{alg} sparse"]["pairs_multiplied"]
        check(pairs == want, f"sparse {alg}: the ranks' B2 launches "
              f"multiplied {pairs} pairs, the stacked plan's {want}")
        res["sparse"][alg] = {
            "wall_ms": statistics.median(rs[0]["wall_ms"]),
            "pairs_multiplied": pairs,
            "body_bytes": [r["body_bytes"] for r in rs],
            "stage_ms": [statistics.median(r["stage_ms"]) for r in rs],
            "wait_ms": [statistics.median(r["wait_ms"]) for r in rs]}
        d = res["sparse"][alg]
        log(f"  sparse-output {alg} (R-MAT scale {SPARSE['scale']}, packed): "
            f"wall "
            f"{d['wall_ms']:.1f} ms (slowest rank); B2 pairs {pairs} (= "
            f"stacked); C tiles equal to stacked; body bytes per rank "
            f"{d['body_bytes']}; staging {[round(x, 1) for x in d['stage_ms']]}"
            f" ms, transport wait {[round(x, 1) for x in d['wait_ms']]} ms")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    check(launches["bsr_spmm"] > 0 and launches["bsr_pair_accumulate"] > 0,
          f"the ranks did not launch B1 and B2: {launches}")
    res["launches"] = launches
    res["busy_ms"] = {k: [r[k] for r in ranks] for k in (
        "B1 busy_ms", "B2 busy_ms")}
    res["dense_peak_gb"] = [r["dense_peak_gb"] for r in ranks]
    res["kernels"] = ranks[0]["kernels"]
    res["s"] = time.perf_counter() - t0
    log(f"  launches on the ranks (all of them): {launches}; busy time by "
        f"rank in one multiply (B1: ring_c float32 padded, B2: ring_c "
        f"sparse): {res['busy_ms']} ms; peak device memory by rank, dense "
        f"cells {[round(x, 2) for x in res['dense_peak_gb']]} GB, sparse "
        f"cell {[round(x, 2) for x in res['peak_gb']]} GB; ranks' time "
        f"{[round(r['rank_s'], 1) for r in ranks]} s (dense cells "
        f"{[round(r['dense_s'], 1) for r in ranks]} s); phase 15 wall "
        f"{res['s']:.1f} s; {card}.  One card shared by 4 ranks over gloo: "
        "no NVLink time")
    return res


# ---------------------------------------------------------------------------
# phase 16: the LM stack sharded over ranks sharing the card
# ---------------------------------------------------------------------------
# (a) OLMoE-1B-7B at its published width and depth, bf16, the expert ring
# on a (data 1, model 4) mesh: one batch of 2 x 512 tokens; the capacity
# factor doubles from the published 1.25 until the dense path drops none
LM_RING = dict(arch="olmoe-1b-7b", mesh=(1, 4), batch=2, seq=512, seed=0)
# ... and one float32 train step through the ring on the same mesh (its
# backward rides the hops back): OLMoE-1B-7B at its published width, its
# depth cut to 4 of 16 layers (~1.9e9 parameters; a rank ~8 GB), remat as
# published, against one process's dense_onehot step, at a capacity factor
# doubled from the published one until the dense path drops none
LM_RING_TRAIN = dict(arch="olmoe-1b-7b", layers=4, mesh=(1, 4), steps=1,
                     batch=2, seq=512, lr=3e-4, seed=0)
# (b) Qwen2.5-3B at its published width, its depth cut to 4 of 36 layers
# (full depth is ~49 GB of float32 parameters, gradients and moments summed
# over the ranks, before activations and 4 CUDA contexts), 3 float32 steps
# on a (2, 2) mesh
LM_TRAIN = dict(arch="qwen2.5-3b", layers=4, mesh=(2, 2), steps=3, batch=4,
                seq=512, lr=3e-4, seed=0)
# ... and served on a (1, 4) mesh: a prefill of 2 x 512 tokens into a
# cache of 520 slots (split by sequence: 4 divides it), then 3 decode steps
LM_SERVE = dict(mesh=(1, 4), batch=2, prompt=512, steps=3, max_len=520,
                seed=1)
# each rank's peak over the same 3 steps when this cell ran the ZeRO-3
# program (every parameter gathered whole), on an H100 80GB HBM3, 700 W
LM_TRAIN_ZERO3_PEAK_GB = 9.43
# each 16b cell's peak a rank when the step gathered the rank's whole model
# slice before it ran (the tensor-parallel program before FSDP went layer
# by layer), on an H100 80GB HBM3, 700 W: Qwen's and OLMoE's must now be
# lower; the others are printed beside theirs
LM_SLICE_PEAK_GB = {"qwen2.5-3b": 5.11, "olmoe-1b-7b": 13.55,
                    "mamba2-130m": 1.19, "recurrentgemma-2b": 8.51,
                    "llava-next-mistral-7b": 6.86}
# ... and the tensor-parallel program of the recurrent, SSM and frontend
# families, which ran ZeRO-3 before it (every parameter gathered whole), in
# a world of 4 ranks of their own, float32 on the same (2, 2) mesh:
# Mamba2-130m at its published width and depth, 3 steps; RecurrentGemma-2B
# at its published width, its depth cut to one "rrl" group of 3 of 26
# layers (~0.23e9 layer parameters and the tied 256000 x 2560 embedding,
# ~3.6 GB; one process ~15 GB of parameters, gradients and moments and ~2
# GB a float32 logits tensor, a rank ~7-8 GB), 3 steps; both then served on
# (1, 4) as Qwen is; llava-next-mistral-7b at its published width, 2 of 32
# layers (~0.72e9 parameters), 1 step of the published 1152 patches and 512
# tokens a row.  hubert-xlarge's cell (4 of 48 layers, 2 steps: 0.9 and
# 0.7 s) is cut, and llava's second step, to keep the phase's growth near
# 150 s: Mamba's step makes ~550 host-staged collectives (13.7-17.8 s a step
# over gloo), so the four cells took 158 s on an H100 80GB HBM3, 700 W; the
# CPU tests and the dry run hold hubert
LM_FAMILIES = (
    dict(arch="mamba2-130m", layers=None, mesh=(2, 2), steps=3, batch=4,
         seq=512, lr=3e-4, seed=0, serve=True, psum=False),
    dict(arch="recurrentgemma-2b", layers=3, mesh=(2, 2), steps=3, batch=4,
         seq=512, lr=3e-4, seed=0, serve=True, psum=False),
    dict(arch="llava-next-mistral-7b", layers=2, mesh=(2, 2), steps=1,
         batch=4, seq=1152 + 512, lr=3e-4, seed=0, psum=False))
# ... and the tensor-parallel program of a MoE model: OLMoE-1B-7B at its
# published width, its depth cut to 4 of 16 layers (~1.9e9 parameters,
# 7.5 GB in float32).  One process holds ~32 GB (parameters, gradients,
# moments), freed before the ranks start; a rank its 1.9 GB shard, 3.8 GB
# of moments, 1.9 GB of shard gradients and one layer's ~0.9 GB model
# slice gathered at a time.  3 float32 steps on (2, 2) with
# one dispatch group over both batch shards (a token's slot counts the
# other shard's tokens), the capacity factor lowered from the published
# 1.25 until the first batch drops tokens (no compressed_psum: the other
# two cells hold it); then served on (1, 4) as Qwen is, at a capacity
# factor doubled from the published one until the prefill drops none
LM_MOE = dict(arch="olmoe-1b-7b", layers=4, mesh=(2, 2), steps=3, batch=4,
              seq=512, lr=3e-4, seed=0, groups=1, psum=False)
# (c) steal3d at the SpMM cell on a 3x3 grid of 9 ranks, the seeded loss of
# 5 and recovery onto the survivors' 2x2 (phase 13's loss)
LM_RECOVERY = dict(g=3, devices=9, lost=5, seed=0)
# phase 17: the dry run's production cells (on a fake 16x16 world) and the
# examples run on the card in children, with the kernels each must launch
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
                ("mamba2-130m", "long_500k"))
DRYRUN_PEAK_TOL = 0.10
EXAMPLES = {"torch_quickstart": ([], ("bsr_spmm",)),
            "torch_graph_square": ([], ("bsr_spmm", "bsr_pair_accumulate")),
            "torch_spgemm_graph": ([], ("bsr_spmm",)),
            "torch_serve_decode": (["--sparse"],
                                   ("bsr_spmm", "bsr_pair_accumulate")),
            "torch_train_lm": ([], ())}
EXAMPLE_TIMEOUT_S = 300
LM_TIMEOUT_S = 420
# the sharded step's parameters against one process: the norm of the
# difference over a rank's shards within this share of their norm.  A
# zero-initialised norm scale, whose few elements move by lr a step, may
# part further where a gradient lies within rounding of zero and Adam steps
# it the other way (see the training gate above), so the worst tensor is
# printed, not held
TOL_SHARDED_PARAMS = 1e-4
# the sharded MoE step's share of dropped token-expert assignments (summed
# over the layers) against one process's: a routing near-tie may flip a
# few of a step's assignments once the parameters part by rounding (a
# step of the OLMoE cell makes 4 x 16,384 of them, 6.1e-5 each a layer)
TOL_MOE_DROPPED = 1e-3


def lm_ring_cfg(capacity_factor: float, dtype: str, impl: str):
    from repro_torch.configs import get_config
    cfg = get_config(LM_RING["arch"])
    return dataclasses.replace(
        cfg, compute_dtype=dtype, moe_impl=impl,
        moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def lm_ring_expected(tmp: Path) -> dict:
    """The single process's OLMoE-1B-7B on phase 16a's batch: the capacity
    factor at which the dense path drops no token (doubled from the
    published one), the float32 and bf16 dense logits, and the bf16 path's
    distance from the float32 one (written for the ranks)."""
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    cf = get_config(LM_RING["arch"]).moe.capacity_factor   # the published
    cfg = lm_ring_cfg(cf, "float32", "dense_onehot")
    toks = torch.from_numpy(np.random.default_rng(LM_RING["seed"]).integers(
        0, cfg.vocab_size, (LM_RING["batch"], LM_RING["seq"]),
        dtype=np.int64)).to(DEVICE)
    model = tf.init_params(cfg, seed=LM_RING["seed"], device=DEVICE)
    with torch.no_grad():
        while True:
            cfg32 = lm_ring_cfg(cf, "float32", "dense_onehot")
            logits32, _, aux = tf.forward(model, {"tokens": toks}, cfg32)
            dropped = float(aux["dropped"])
            log(f"  16a: capacity factor {cf}: the float32 dense path "
                f"drops {dropped:.4g} of its token-expert assignments "
                "(summed over the layers)")
            if dropped == 0.0:
                break
            cf *= 2
        model = model.to(torch.bfloat16)
        logits16, _, aux16 = tf.forward(
            model, {"tokens": toks}, lm_ring_cfg(cf, "bfloat16",
                                                 "dense_onehot"))
    del model
    free()
    noise = float((logits16.float() - logits32).abs().max())
    path = tmp / "lm_ring.pt"
    torch.save({"tokens": toks.cpu(), "logits16": logits16.float().cpu(),
                "logits32": logits32.cpu(), "noise": noise, "cf": cf}, path)
    del logits16, logits32
    log(f"  16a: single process, dense path: bf16 logits within {noise:.4g} "
        f"of float32 (bf16 drops {float(aux16['dropped']):.4g}); capacity "
        f"factor {cf}; {time.perf_counter() - t0:.1f} s")
    return {"path": str(path), "cf": cf, "noise": noise}


def lm_ring_train_cfg(cf: float, impl: str):
    """16a's train cell's config: float32, its depth cut, capacity factor
    ``cf``, MoE layer ``impl``."""
    cfg = lm_train_cfg(LM_RING_TRAIN)
    return dataclasses.replace(cfg, moe_impl=impl, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def lm_ring_train_expected(tmp: Path) -> dict:
    """16a's train cell in one process: the capacity factor at which the
    dense path drops no token of the cell's first batch (doubled from the
    published one), and the float32 dense_onehot step there (written for
    the ranks)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    cell = LM_RING_TRAIN
    cf = lm_train_cfg(cell).moe.capacity_factor            # the published
    model = tf.init_params(lm_ring_train_cfg(cf, "dense_onehot"),
                           seed=cell["seed"], device=DEVICE)
    raw = SyntheticLM(model.cfg, cell["batch"], cell["seq"],
                      seed=cell["seed"])(0)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in raw.items()}
    with torch.no_grad():
        while True:
            dropped = float(lm.loss_fn(model, batch, lm_ring_train_cfg(
                cf, "dense_onehot"))[1]["dropped"])
            if dropped == 0.0:
                break
            cf *= 2
    del model, batch
    free()
    cfg = lm_ring_train_cfg(cf, "dense_onehot")
    one = lm_one_process(cell, tmp / "lm_ring_train.pt", cfg=cfg)
    log(f"  16a: single process: {describe(cfg)}, {one['n_params']} "
        f"parameters, capacity factor {cf} (no drop), loss "
        f"{[round(v, 6) for v in one['losses']]}, step wall "
        f"{[round(v, 3) for v in one['step_s']]} s, peak "
        f"{one['peak_gb']:.2f} GB; {time.perf_counter() - t0:.1f} s")
    return {"path": one["path"], "cf": cf, "n_params": one["n_params"],
            "ref_peak_gb": one["peak_gb"]}


def lm_train_cfg(cell: dict = LM_TRAIN, cf: float = None):
    """A 16b cell's config, float32; a MoE cell's at capacity factor
    ``cf`` with its dispatch groups."""
    from repro_torch.configs import get_config
    cfg = get_config(cell["arch"])
    cfg = dataclasses.replace(cfg, n_layers=cell["layers"] or cfg.n_layers,
                              compute_dtype="float32")
    if cf is None:
        return cfg
    return dataclasses.replace(
        cfg, moe_dispatch_groups=cell["groups"],
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def lm_train_cell(cell: dict = LM_TRAIN):
    from repro_torch.configs import Shape
    return Shape(f"train_{cell['batch']}x{cell['seq']}", "train",
                 cell["seq"], cell["batch"])


def lm_serve_tokens(cfg=None):
    return torch.from_numpy(np.random.default_rng(LM_SERVE["seed"]).integers(
        0, (cfg or lm_train_cfg()).vocab_size,
        (LM_SERVE["batch"], LM_SERVE["prompt"] + LM_SERVE["steps"]),
        dtype=np.int64))


def lm_serve_expected(cfg) -> dict:
    """One process's ``lm.prefill`` and decode steps of a cut model
    (float32 caches): the logits of each."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    toks = lm_serve_tokens(cfg).to(DEVICE)
    n = LM_SERVE["prompt"]
    model = tf.init_params(cfg, seed=LM_TRAIN["seed"], device=DEVICE)
    logits, caches, pos = lm.prefill(model, {"tokens": toks[:, :n]}, cfg,
                                     LM_SERVE["max_len"], torch.float32)
    out = [logits.cpu()]
    step = lm.make_decode_step(cfg)
    for t in range(n, n + LM_SERVE["steps"]):
        logits, caches = step(model, toks[:, t:t + 1], caches, pos)
        pos = pos + 1
        out.append(logits.cpu())
    del model, caches
    free()
    return out


def lm_one_process(cell: dict, path: Path, cfg=None, **extra) -> dict:
    """One process's float32 steps of ``cell`` (losses, gradient norms,
    dropped shares, the final parameters), saved with ``extra`` to
    ``path`` for the ranks."""
    from repro_torch.launch.train import train
    cfg = cfg or lm_train_cfg(cell)
    torch.cuda.reset_peak_memory_stats()
    st = train(cfg, steps=cell["steps"], batch=cell["batch"],
               seq=cell["seq"], lr=cell["lr"], seed=cell["seed"],
               device=DEVICE, log_every=0)
    torch.save({"losses": st["losses"], "grad_norms": st["grad_norms"],
                "dropped": st["dropped"],
                "params": {n: p.detach().cpu() for n, p in
                           st["params"].named_parameters()}, **extra}, path)
    n = sum(p.numel() for p in st["params"].parameters())
    out = {"path": str(path), "n_params": n, "losses": st["losses"],
           "step_s": st["step_s"], "dropped": st["dropped"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del st
    free()
    return out


def lm_train_expected(tmp: Path) -> dict:
    """One process's 3 float32 steps of the cut Qwen2.5-3B, its prefill and
    decode steps, and the dry run of one rank's step on the (2, 2) mesh
    (written for the ranks)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cfg = lm_train_cfg()
    pred = dryrun.run_cell(LM_TRAIN["arch"], lm_train_cell().name, "single",
                           verbose=False, cfg=cfg, shape=lm_train_cell(),
                           mesh_shape=LM_TRAIN["mesh"])
    check(pred["status"] == "ok" and pred["program"] == "fsdp_tp",
          f"16b: the dry run of the (2, 2) cell: {pred.get('status')} "
          f"{pred.get('program')} {pred.get('error')}")
    one = lm_one_process(LM_TRAIN, tmp / "lm_train.pt",
                         serve=lm_serve_expected(cfg))
    log(f"  16b: single process: {describe(cfg)}, {one['n_params']} "
        f"parameters, losses {[round(v, 5) for v in one['losses']]}, step "
        f"walls {[round(v, 3) for v in one['step_s']]} s")
    log(f"  16b: the dry run of a rank's Qwen step on (2, 2): product flops "
        f"{pred['hlo_stats']['dot_flops']:.6e}, peak "
        f"{pred['peak_bytes'] / 1e9:.3f} GB; {time.perf_counter() - t0:.1f} s")
    return {"path": one["path"], "n_params": one["n_params"],
            "dot_flops": pred["hlo_stats"]["dot_flops"],
            "peak_bytes": pred["peak_bytes"]}


def lm_family_expected(tmp: Path, cell: dict) -> dict:
    """A family cell of 16b: the dry run of one rank's step on the (2, 2)
    mesh, one process's float32 steps and (where the cell is served) its
    prefill and decode steps (written for the ranks)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cfg = lm_train_cfg(cell)
    with dryrun.fake_world(cell["mesh"]) as mesh:
        pred = dryrun.record_cell(cfg, lm_train_cell(cell), mesh, DEVICE)
    flops = pred["stats"].dot_flops
    peak = pred["memory"]["argument_size_in_bytes"] \
        + pred["memory"]["temp_size_in_bytes"]
    del pred
    extra = {"serve": lm_serve_expected(cfg)} if cell.get("serve") else {}
    one = lm_one_process(cell, tmp / f"lm_{cell['arch']}.pt", cfg=cfg,
                         **extra)
    log(f"  16b: single process: {describe(cfg)}, {one['n_params']} "
        f"parameters, losses {[round(v, 5) for v in one['losses']]}, step "
        f"walls {[round(v, 3) for v in one['step_s']]} s, peak "
        f"{one['peak_gb']:.2f} GB; the dry run of a rank's step on (2, 2): "
        f"product flops {flops:.6e}, peak {peak / 1e9:.3f} GB; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"path": one["path"], "n_params": one["n_params"],
            "dot_flops": flops, "peak_bytes": peak,
            "ref_peak_gb": one["peak_gb"]}


def lm_moe_capacities() -> tuple:
    """16b's MoE capacity factors, from the single process's forward at
    the cell's width and depth: for training, the published one lowered by
    0.25 until the first batch drops tokens; for serving, doubled until
    the prefill drops none."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    cell = LM_MOE
    cf = lm_train_cfg(cell).moe.capacity_factor            # the published
    model = tf.init_params(lm_train_cfg(cell, cf), seed=cell["seed"],
                           device=DEVICE)
    raw = SyntheticLM(lm_train_cfg(cell, cf), cell["batch"], cell["seq"],
                      seed=cell["seed"])(0)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in raw.items()}
    with torch.no_grad():
        train_cf = cf
        while True:
            dropped = float(lm.loss_fn(model, batch,
                                       lm_train_cfg(cell, train_cf))[1]
                            ["dropped"])
            log(f"  16b: OLMoE capacity factor {train_cf}: the first batch "
                f"drops {dropped:.4g} (summed over the layers)")
            if dropped > 0 or train_cf <= 0.25:
                break
            train_cf -= 0.25
        toks = lm_serve_tokens(model.cfg)[:, :LM_SERVE["prompt"]].to(DEVICE)
        serve_cf = cf
        while True:
            cfg = dataclasses.replace(lm_train_cfg(cell, serve_cf),
                                      moe_dispatch_groups=1)
            dropped = float(tf.forward(model, {"tokens": toks}, cfg)[2]
                            ["dropped"])
            if dropped == 0.0:
                break
            serve_cf *= 2
    del model
    free()
    return train_cf, serve_cf


def lm_moe_expected(tmp: Path) -> dict:
    """16b's MoE cell: its capacity factors, the dry run of one rank's step
    on the (2, 2) mesh (the cell's own dispatch groups), one process's 3
    float32 steps and its prefill and decode steps at the serving
    capacity (written for the ranks)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    train_cf, serve_cf = lm_moe_capacities()
    cfg = lm_train_cfg(LM_MOE, train_cf)
    with dryrun.fake_world(LM_MOE["mesh"]) as mesh:
        pred = dryrun.record_cell(cfg, lm_train_cell(LM_MOE), mesh, DEVICE)
    flops = pred["stats"].dot_flops
    peak = pred["memory"]["argument_size_in_bytes"] \
        + pred["memory"]["temp_size_in_bytes"]
    del pred
    one = lm_one_process(LM_MOE, tmp / "lm_moe.pt", cfg=cfg,
                         serve=lm_serve_expected(lm_train_cfg(LM_MOE,
                                                              serve_cf)))
    log(f"  16b: single process: {describe(cfg)}, {one['n_params']} "
        f"parameters, capacity factor {train_cf}, losses "
        f"{[round(v, 5) for v in one['losses']]}, dropped "
        f"{[round(v, 5) for v in one['dropped']]} (summed over the layers), "
        f"step walls {[round(v, 3) for v in one['step_s']]} s, peak "
        f"{one['peak_gb']:.2f} GB; serving capacity factor {serve_cf}")
    log(f"  16b: the dry run of a rank's OLMoE step on (2, 2): product flops "
        f"{flops:.6e}, peak {peak / 1e9:.3f} GB; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"path": one["path"], "n_params": one["n_params"], "cf": train_cf,
            "serve_cf": serve_cf, "dot_flops": flops, "peak_bytes": peak,
            "ref_dropped": one["dropped"], "ref_peak_gb": one["peak_gb"]}


def lm_recovery_expected(tmp: Path) -> dict:
    """The stacked recovery of phase 13 at the SpMM cell (g 3 -> 2): each
    survivor's padded C tile, the plan's findings under ``validate="fast"``
    and its real pairs; the operands in host memory for the ranks."""
    from repro_torch import analysis
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.core.bsr import rmat_matrix
    from repro_torch.runtime.faultinject import DeviceLoss
    from repro_torch.runtime.replan import ElasticReplanner
    t0 = time.perf_counter()
    a_np = rmat_matrix(SPMM["scale"], 8, seed=SPMM["seed"])
    b_np = np.random.default_rng(SPMM["seed"]).standard_normal(
        (a_np.shape[1], SPMM["width"])).astype(np.float32)
    a3 = DistBSR.from_dense(a_np, g=LM_RECOVERY["g"],
                            block_size=SPMM["block_size"], device=DEVICE)
    del a_np
    b3 = DistDense.for_rhs(b_np, a3)
    loss = DeviceLoss(LM_RECOVERY["devices"], LM_RECOVERY["lost"],
                      seed=LM_RECOVERY["seed"])
    rec = ElasticReplanner().recover_from_loss(a3, b3, loss.survivors())
    c = rec.plan(rec.a, rec.b)
    findings = [str(f) for f in analysis.check_plan(rec.plan, rec.a, rec.b)]
    g, (tm, tn) = rec.g, (rec.a.tile_shape[0], rec.b.tile_shape[1])
    padded = c.new_zeros((tm * g, tn * g))
    padded[:c.shape[0], :c.shape[1]] = c
    tiles = {p: padded[(p // g) * tm:(p // g + 1) * tm,
                       (p % g) * tn:(p % g + 1) * tn].cpu()
             for p in range(g * g)}
    path = tmp / "lm_recovery.pt"
    torch.save({"a": host_tiled(a3.tiled), "b": b_np, "tiles": tiles,
                "findings": findings, "survivors": loss.survivors(),
                "real_pairs": rec.plan._steal.real_pairs,
                "oracle_max": float(c.abs().max())}, path)
    log(f"  16c: stacked recovery of the loss of {loss.lost()}: survivors "
        f"{loss.survivors()} -> g {g}, real pairs "
        f"{rec.plan._steal.real_pairs}, findings {findings or 'none'}; "
        f"{time.perf_counter() - t0:.1f} s")
    del a3, b3, rec, c, padded
    free()
    return {"path": str(path)}


def lm_ring_rank(dev, spec: dict) -> dict:
    """Phase 16a on one rank of the (1, 4) mesh: OLMoE-1B-7B built layer by
    layer, this rank's 16 experts a layer and the rest whole, in bf16; one
    forward with the expert ring against the single process's dense bf16
    logits; the ring's hops."""
    from repro_torch.launch.mesh import make_mesh, mesh_comm, set_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import MODEL_AXIS, P
    from repro_torch.models.sharded import ShardedModel
    mesh = make_mesh(LM_RING["mesh"], ("data", MODEL_AXIS), device_type="cuda")
    ref = torch.load(spec["ring"]["path"], weights_only=False)
    cfg = lm_ring_cfg(ref["cf"], "bfloat16", "ring")
    # the experts over the model axis, everything else whole
    specs = {n: P(MODEL_AXIS, None, None) if ".moe.w_" in n else P()
             for n in tf.param_specs(cfg)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ShardedModel.init(cfg, mesh, seed=LM_RING["seed"], device=dev,
                              specs=specs, dtype=torch.bfloat16).local
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    local_experts = model.layers[0].moe.w_gate.shape[0]
    comm = mesh_comm(mesh, dev)
    comm.reset_counters()
    moe.reset_ring_stats()
    toks = ref["tokens"].to(dev)
    comm.all_reduce(torch.zeros(1, device=dev), ("data", MODEL_AXIS))
    t0 = time.perf_counter()
    with torch.no_grad(), set_mesh(mesh):
        logits, _, aux = tf.forward(model, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hops = {k: int(v) for k, v in moe.ring_stats.items()}
    err16 = float((logits - ref["logits16"].to(dev)).abs().max())
    err32 = float((logits - ref["logits32"].to(dev)).abs().max())
    finite = bool(torch.isfinite(logits).all())
    del model, logits
    free()
    return {"param_bytes": nbytes, "local_experts": local_experts,
            "init_s": init_s, "wall_s": wall, "hops": hops,
            "max_abs_err_vs_dense_bf16": err16,
            "max_abs_err_vs_dense_f32": err32, "finite": finite,
            "noise": ref["noise"], "dropped": float(aux["dropped"]),
            "stage_s": comm.stage_s, "wait_s": comm.wait_s,
            "sent_bytes": comm.sent,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def lm_ring_train_rank(dev, spec: dict) -> dict:
    """Phase 16a's train step on one rank of the (1, 4) mesh:
    ``train(mesh=)`` of the cut OLMoE-1B-7B with ``moe_impl="ring"`` from
    the single process's init cut to this rank's shards; its loss and
    gradient norm against the single process's dense_onehot step
    (``spec["ring_train"]``), the ring's hops forward (the recomputation
    included) and backward, and the assignments its capacity dropped."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    cell = LM_RING_TRAIN
    mesh = make_mesh(cell["mesh"], ("data", "model"), device_type="cuda")
    ref = torch.load(spec["ring_train"]["path"], mmap=True,
                     weights_only=False)
    cfg = lm_ring_train_cfg(spec["ring_train"]["cf"], "ring")
    torch.cuda.reset_peak_memory_stats()
    moe.reset_ring_stats()
    st = train(cfg, steps=cell["steps"], batch=cell["batch"],
               seq=cell["seq"], lr=cell["lr"], seed=cell["seed"],
               device=dev, log_every=0, mesh=mesh)
    torch.cuda.synchronize()
    comm = st["params"].comm
    out = {"program": st["params"].program, "losses": st["losses"],
           "grad_norms": st["grad_norms"], "ref_losses": ref["losses"],
           "ref_grad_norms": ref["grad_norms"], "dropped": st["dropped"],
           "ref_dropped": ref["dropped"], "step_s": st["step_s"],
           "hops": moe.ring_stats["hops"],
           "backward_hops": moe.ring_stats["backward_hops"],
           "ring_dropped": int(moe.ring_stats["dropped"]),
           "param_bytes": st["params"].local_bytes(),
           "sent_bytes": comm.sent, "collectives": comm.collectives,
           "stage_s": comm.stage_s, "wait_s": comm.wait_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del st, ref
    free()
    dist.barrier()
    return out


def lm_train_rank(dev, spec: dict, cell: dict = LM_TRAIN,
                  key: str = "train") -> dict:
    """Phase 16b on one rank of the (2, 2) mesh: ``train(mesh=)`` for 3
    float32 steps of ``cell`` from the single process's init cut to this
    rank's shards; losses, gradient norms, dropped shares and shards
    against the single process's (``spec[key]["path"]``); the rank's
    parameter and moment bytes against its sanitized shards';
    ``compressed_psum`` over the data axis on one step's gradients (where
    the cell asks); one more step recorded on the card."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (local_chunk, make_mesh, mesh_comm,
                                         shard_bytes)
    from repro_torch.launch.train import train
    mesh = make_mesh(cell["mesh"], ("data", "model"), device_type="cuda")
    ref = torch.load(spec[key]["path"], mmap=True, weights_only=False)
    cfg = lm_train_cfg(cell, spec[key].get("cf"))
    torch.cuda.reset_peak_memory_stats()
    sent0 = mesh_comm(mesh, dev).sent
    calls0 = mesh_comm(mesh, dev).collectives
    st = train(cfg, steps=cell["steps"], batch=cell["batch"],
               seq=cell["seq"], lr=cell["lr"], seed=cell["seed"],
               device=dev, log_every=0, mesh=mesh)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sm = st["params"]
    steps_sent = sm.comm.sent - sent0
    step_collectives = (sm.comm.collectives - calls0) / cell["steps"]
    d2 = w2 = 0.0
    worst = (0.0, "")
    for n, p in sm.local_named().items():
        want = local_chunk(ref["params"][n], sm.placements[n], mesh).to(dev)
        diff = (p.detach() - want).float()
        d2 += float(diff.square().sum())
        w2 += float(want.float().square().sum())
        rel = float(diff.norm() / want.float().norm().clamp_min(1e-30))
        worst = max(worst, (rel, n))
    want_bytes = sum(shard_bytes(sm.shapes[n], p.dtype, sm.placements[n],
                                 mesh) for n, p in sm.local_named().items())
    moments = sum(t.numel() * t.element_size() for k in ("mu", "nu")
                  for t in st["opt"][k].values())
    whole = sum(int(np.prod(s)) * 4 for s in sm.shapes.values())
    out = {}
    if cell.get("psum", True):
        out.update(lm_psum_check(sm, cfg, cell, mesh, dev))
    out.update({"program": sm.program, "losses": st["losses"],
                "grad_norms": st["grad_norms"], "ref_losses": ref["losses"],
                "ref_grad_norms": ref["grad_norms"], "step_s": st["step_s"],
                "dropped": st["dropped"], "ref_dropped": ref["dropped"],
                "param_bytes": sm.local_bytes(), "want_bytes": want_bytes,
                "moment_bytes": moments, "whole_bytes": whole,
                "param_rel": (d2 / w2) ** 0.5, "worst_tensor_rel": worst[0],
                "worst_tensor": worst[1], "stage_s": sm.comm.stage_s,
                "wait_s": sm.comm.wait_s, "sent_bytes": sm.comm.sent,
                "steps_sent_bytes": steps_sent, "peak_gb": peak_gb,
                "step_collectives": step_collectives})
    del st, sm
    free()
    # one more step of the same cell, recorded on the card as the dry run
    # records its fakes
    rec = dryrun.record_cell(cfg, lm_train_cell(cell), mesh, dev,
                             fake=False, transport=True, seed=cell["seed"])
    out["dot_flops"] = rec["stats"].dot_flops
    del rec
    free()
    dist.barrier()
    return out


def lm_psum_check(sm, cfg, cell: dict, mesh, dev) -> dict:
    """``compressed_psum`` over the data axis on one step's gradients of
    this rank (its shard of the batch and its model slice, before the
    data-axis sum: what each unit's gather hands ``MeshComm.sum_group`` in
    the backward, captured for this check): within one int8 step of the
    exact float32 sum, the residual exact."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import sharded
    from repro_torch.optim import ErrorFeedbackState, compressed_psum
    from repro_torch.optim.compression import compress_int8, decompress_int8
    raw = SyntheticLM(cfg, cell["batch"], cell["seq"], seed=cell["seed"])(0)
    batch = sharded.place_batch({k: torch.as_tensor(v, device=dev)
                                 for k, v in raw.items()}, mesh)
    captured, sum_group = [], sm.comm.sum_group

    def capture(grads, placements, axes):
        captured.extend(g.detach().clone() for g in grads)
        return sum_group(grads, placements, axes)

    sm.comm.sum_group = capture
    try:
        with sm.running(train=True):
            total, _ = sharded._local_loss(sm.local, batch, cfg, sm.comm,
                                           ["data"])
            total.backward()
    finally:
        del sm.comm.sum_group
    del total
    sm.take_grads()
    grads = {str(i): g for i, g in enumerate(captured)}
    del captured
    t0 = time.perf_counter()
    with set_mesh(mesh):
        summed, ef = compressed_psum(grads, "data",
                                     ErrorFeedbackState.init(grads))
    psum_s = time.perf_counter() - t0
    worst_share, resid_ok = 0.0, True
    for n, g in grads.items():
        exact = sm.comm.all_reduce(g.float(), ["data"])
        q, s = compress_int8(g.float())
        step = sm.comm.all_reduce(s.reshape(1), ["data"])   # sum of scales
        err = float((summed[n] - exact).abs().max())
        worst_share = max(worst_share, err / float(step))
        resid_ok &= bool(torch.equal(ef.residual[n],
                                     g.float() - decompress_int8(q, s)))
    del grads, summed, ef
    return {"psum_int8_step_share": worst_share, "psum_resid_ok": resid_ok,
            "psum_s": psum_s}


def lm_serve_rank(dev, spec: dict, key: str = "train",
                  cell: dict = LM_TRAIN) -> dict:
    """Phase 16b's serving on one rank of the (1, 4) mesh: a cut model
    (``cell``'s: Qwen2.5-3B, OLMoE-1B-7B at its serving capacity,
    Mamba2-130m, RecurrentGemma-2B) from the seeded init,
    ``sharded_prefill`` of 2 x 512 tokens into the rank's cache shards
    (an attention cache split by sequence, a recurrent state by channel
    or head) and 3 decode steps; the logits' largest distance from the
    single process's (``spec[key]["path"]``), relative to 1 + |theirs|."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharded
    mesh = make_mesh(LM_SERVE["mesh"], ("data", "model"), device_type="cuda")
    want = torch.load(spec[key]["path"], mmap=True,
                      weights_only=False)["serve"]
    cfg = lm_train_cfg(cell, spec[key].get("serve_cf"))
    sm = sharded.ShardedModel.init(cfg, mesh, seed=LM_TRAIN["seed"],
                                   device=dev)
    caches, placements = sharded.cache_shards(
        cfg, LM_SERVE["batch"], LM_SERVE["max_len"], mesh, torch.float32,
        device=dev)
    del caches
    toks = sharded.place_batch({"tokens": lm_serve_tokens(cfg).to(dev)},
                               mesh)["tokens"]
    n = LM_SERVE["prompt"]
    torch.cuda.reset_peak_memory_stats()
    sm.comm.reset_counters()
    t0 = time.perf_counter()
    logits, caches, pos = sharded.sharded_prefill(
        sm, {"tokens": toks[:, :n]}, cfg, LM_SERVE["max_len"], placements,
        cache_dtype=torch.float32)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    got = [logits]
    step = sharded.make_sharded_decode_step(cfg)
    for t in range(n, n + LM_SERVE["steps"]):
        t0 = time.perf_counter()
        logits, caches = step(sm, toks[:, t:t + 1], caches, placements, pos)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        pos = pos + 1
        got.append(logits)
    errs = [float(((g - w.to(dev)).abs() / (1 + w.to(dev).abs())).max())
            for g, w in zip(got, want)]
    return {"program": sm.program, "errs": errs, "walls_s": walls,
            "cache_shard": {k: list(v.shape) for k, v in caches[0].items()},
            "cache_placements": str(placements[0]),
            "finite": all(bool(torch.isfinite(g).all()) for g in got),
            "sent_bytes": sm.comm.sent, "stage_s": sm.comm.stage_s,
            "wait_s": sm.comm.wait_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def lm_rank(dev, spec: dict) -> dict:
    """Phases 16a and 16b on one of the 4 ranks (one world, seven
    meshes)."""
    t0 = time.perf_counter()
    ring = lm_ring_rank(dev, spec)
    ring["rank_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring_train = lm_ring_train_rank(dev, spec)
    ring_train["rank_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    train = lm_train_rank(dev, spec)
    train["rank_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    serve = lm_serve_rank(dev, spec)
    serve["rank_s"] = time.perf_counter() - t2
    t3 = time.perf_counter()
    moe = lm_train_rank(dev, spec, LM_MOE, "moe")
    moe["rank_s"] = time.perf_counter() - t3
    t4 = time.perf_counter()
    moe_serve = lm_serve_rank(dev, spec, "moe", LM_MOE)
    moe_serve["rank_s"] = time.perf_counter() - t4
    return {"ring": ring, "ring_train": ring_train, "train": train,
            "serve": serve, "moe": moe, "moe_serve": moe_serve}


def lm_family_rank(dev, spec: dict) -> dict:
    """Phase 16b's family cells on one of their 4 ranks: each cell's train
    steps on (2, 2) and, where it is served, its serving on (1, 4)."""
    out = {}
    for cell in LM_FAMILIES:
        t0 = time.perf_counter()
        out[cell["arch"]] = lm_train_rank(dev, spec, cell, cell["arch"])
        out[cell["arch"]]["rank_s"] = time.perf_counter() - t0
        if cell.get("serve"):
            t0 = time.perf_counter()
            sv = lm_serve_rank(dev, spec, cell["arch"], cell)
            sv["rank_s"] = time.perf_counter() - t0
            out[cell["arch"] + "/serve"] = sv
    return out


def survivor_b1_case(plan, captured) -> dict:
    """B1 at a survivor rank's shapes (its recovered steal3d segment: the
    pools its body gathered, the rank's pair lists, B as one flat tile)
    against its plain version: CUDA-event times of both, the error within
    ``TOL_F32_DEEP`` of |A| @ |B|, the bound from the real blocks."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    args, kw = captured
    a_p, b_p, pa, pb, ps = args
    n_slots, table = kw["n_slots"], kw["table"]

    def kernel():
        return kops.steal_pair_accumulate(a_p, b_p, pa, pb, ps,
                                          n_slots=n_slots, impl="cuda",
                                          table=table)

    def plain(a=a_p, b=b_p):
        return ref.steal_pair_accumulate_raw_ref(a, b, pa, pb, ps, n_slots)

    got, want = kernel(), plain()
    scale = plain(a_p.abs(), b_p.abs())
    err, share, ok = compare(got, want, scale, TOL_F32_DEEP)
    check(ok, f"B1 at the survivor's steal3d shape disagrees with its "
          f"plain version (max_abs_err {err:.3e})")
    ms = time_ms(kernel, reps=5)
    plain_ms = time_ms(plain, reps=2)
    bs, n = a_p.shape[-1], b_p.shape[-1]
    real = table.real_blocks
    b_rows = int(torch.unique(pb[torch.as_tensor(
        np.asarray(plan._steal.segments[0]["real"]), device=pb.device)]
    ).numel())
    nbytes = real * bs * bs * a_p.element_size() \
        + b_rows * bs * n * b_p.element_size() \
        + got.numel() * got.element_size()
    flops = 2 * real * bs * bs * n
    peak_bytes, peak_ops = peaks()
    t_bytes, t_ops = nbytes / peak_bytes * 1e3, flops / peak_ops[
        b_p.dtype] * 1e3
    return {"max_abs_err": err, "share_of_tolerance": share, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "real_blocks": real, "bytes": nbytes,
            "real_flops": flops,
            "shape": {"pairs": int(pa.shape[1]), "pool": list(a_p.shape),
                      "b": list(b_p.shape), "slots": n_slots}}


def lm_recovery_rank(ex, spec: dict) -> dict:
    """Phase 16c on one rank of the 3x3 grid: ``recover_from_loss`` on the
    ranks (the old owners send their blocks; a new 2x2 grid over the
    survivors; steal3d rebuilt under ``validate="fast"``), then on each
    survivor the recovered multiply: its C tile against the stacked
    recovery's (bit for bit), B1's launches and the blocks it multiplied
    (counted on the card) against the plan's real pairs, the verifier's
    findings on the rank plan against the stacked plan's; the recovery's
    host ms by span."""
    from repro_torch import analysis, obs
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.replan import ElasticReplanner
    ops = torch.load(spec["recovery"]["path"], mmap=True, weights_only=False)
    a3 = DistBSR(ops["a"])
    b3 = DistDense.for_rhs(ops["b"], a3, device="cpu")
    ex.reset_counters()
    obs.reset_all()
    obs.enable(clear=True)
    ex.barrier()
    t0 = time.perf_counter()
    try:
        rec = ElasticReplanner().recover_from_loss(a3, b3, ops["survivors"],
                                                   mesh=ex)
        events = obs.events()
    finally:
        obs.disable()
    recover_s = time.perf_counter() - t0
    spans = {name: sum(span_ms(events, name)) for name in (
        "replan.recover", "replan.evict", "replan.mesh", "replan.reshard",
        "replan.lpt", "replan.coverage", "plan_build",
        "plan_build.validate")}
    out = {"rank": ex.rank, "g": rec.g, "host_ms": spans,
           "recover_s": recover_s, "reshard_bytes": ex.bytes_sent("place"),
           "survivor": rec.plan is not None, "launches": 0}
    if rec.plan is None:
        return out
    plan = rec.plan
    reset_counts()
    res, blocks = counted_blocks(lambda: plan(rec.a, rec.b))
    launches = read_counts()["bsr_spmm"]
    want = ops["tiles"][plan.executor.position].to(res.tile.device)
    equal = bool(torch.equal(res.tile, want))
    err = float((res.tile - want).abs().max())
    real = plan._steal.real_pairs
    findings = [str(f) for f in analysis.check_rank_plan(plan, rec.a,
                                                         rec.b)]
    check(equal, f"rank {ex.rank}: its recovered C tile is not the stacked "
          f"recovery's (max_abs_err {err:.3e})")
    check(launches == len(plan._steal.segments) and blocks == real,
          f"rank {ex.rank}: B1 launched {launches} time(s) and multiplied "
          f"{blocks} blocks, the plan's real pairs are {real}")
    check(findings == ops["findings"], f"rank {ex.rank}: the verifier's "
          f"findings {findings} differ from the stacked plan's "
          f"{ops['findings']}")
    new = plan.executor          # the survivors' grid; the rest have left
    new.barrier()
    t0 = time.perf_counter()
    plan(rec.a, rec.b)
    torch.cuda.synchronize()
    local = time.perf_counter() - t0
    out.update(position=new.position, launches=launches,
               blocks_multiplied=blocks, real_pairs=real, equal=equal,
               findings=findings, wall_ms=new.max_over_ranks(local) * 1e3)
    # the B1 call of one more multiply (a collective: every survivor runs
    # it), kept for position 0's kernel case while the others wait
    captured = []
    orig = kops.steal_pair_accumulate

    def capture(*args, **kw):
        captured.append((args, kw))
        return orig(*args, **kw)

    kops.steal_pair_accumulate = capture
    try:
        plan(rec.a, rec.b)
    finally:
        kops.steal_pair_accumulate = orig
    if new.position == 0:
        out["kernel"] = survivor_b1_case(plan, captured[0])
    del captured
    new.barrier()
    return out


def lm_checks(lm: list, spec: dict, res: dict, card: str) -> None:
    """Phase 16a's and 16b's checks and readings over the 4 ranks'
    results (into ``res``)."""
    # (a) the expert ring
    ring = [r["ring"] for r in lm]
    noise, cf = spec["ring"]["noise"], spec["ring"]["cf"]
    hops_want = 4 * sum(1 for k in lm_ring_cfg(cf, "bfloat16", "ring")
                        .pattern)
    for r, x in enumerate(ring):
        check(x["finite"], f"16a rank {r}: non-finite logits")
        check(x["hops"]["hops"] == hops_want, f"16a rank {r}: the ring made "
              f"{x['hops']['hops']} hops, R x MoE layers is {hops_want}")
        check(x["max_abs_err_vs_dense_bf16"] <= 2 * noise, f"16a rank {r}: "
              f"logits {x['max_abs_err_vs_dense_bf16']:.4g} from the dense "
              f"bf16 path's, over twice its noise {noise:.4g}")
        check(x["local_experts"] == 16, f"16a rank {r}: "
              f"{x['local_experts']} experts a layer")
    res["ring"] = {"capacity_factor": cf, "noise": noise, "ranks": ring,
                   "hops_per_rank": hops_want}
    # (a) a train step through the ring against one process's dense step
    rt = [r["ring_train"] for r in lm]
    cell, rs = LM_RING_TRAIN, spec["ring_train"]
    units = cell["steps"] * cell["layers"] * cell["mesh"][1]
    remat = lm_ring_train_cfg(rs["cf"], "ring").remat
    for r, x in enumerate(rt):
        for got, want, what in ((x["losses"], x["ref_losses"], "loss"),
                                (x["grad_norms"], x["ref_grad_norms"],
                                 "gradient norm")):
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            check(len(got) == cell["steps"] and rel <= TOL_TRAIN_GATE,
                  f"16a ring train rank {r}: {what} {got} against one "
                  f"process's dense_onehot {want}")
        check(x["program"] == "fsdp_tp" and x["ring_dropped"] == 0
              and max(x["ref_dropped"]) == 0,
              f"16a ring train rank {r}: program {x['program']}, the ring "
              f"dropped {x['ring_dropped']} assignments, the dense path "
              f"{x['ref_dropped']}")
        check(x["hops"] == units * (2 if remat else 1)
              and x["backward_hops"] == units,
              f"16a ring train rank {r}: {x['hops']} forward hops (R a "
              f"layer, again in the recomputation: {units * (1 + remat)}) "
              f"and {x['backward_hops']} backward ({units})")
    res["ring_train"] = {"ranks": rt, **cell, **rs}
    log(f"  16a OLMoE-1B-7B at full width, depth cut to {cell['layers']} of "
        f"16 layers ({rs['n_params']} parameters), float32, one train step "
        f"through the expert ring on (data 1, model 4), capacity factor "
        f"{rs['cf']}: loss {rt[0]['losses']} (one process's dense_onehot "
        f"{rt[0]['ref_losses']}), gradient norm {rt[0]['grad_norms']} (one "
        f"process {rt[0]['ref_grad_norms']}); hops a rank forward "
        f"{[x['hops'] for x in rt]} (the recomputation's included), "
        f"backward {[x['backward_hops'] for x in rt]}, dropped "
        f"{[x['ring_dropped'] for x in rt]}; step wall "
        f"{[[round(t, 2) for t in x['step_s']] for x in rt]} s; bytes sent "
        f"{[x['sent_bytes'] for x in rt]} in "
        f"{[x['collectives'] for x in rt]} collectives; staging "
        f"{[round(x['stage_s'], 1) for x in rt]} s, waits "
        f"{[round(x['wait_s'], 1) for x in rt]} s; peak "
        f"{[round(x['peak_gb'], 2) for x in rt]} GB a rank (one process "
        f"{rs['ref_peak_gb']:.2f}); {card}")
    log(f"  16a OLMoE-1B-7B bf16, expert ring on (data 1, model 4): capacity "
        f"factor {cf}; each rank {ring[0]['local_experts']} experts a layer, "
        f"parameter bytes {[x['param_bytes'] for x in ring]}; hops per rank "
        f"{[x['hops']['hops'] for x in ring]} (= 4 x 16 MoE layers); logits "
        f"vs the dense bf16 path "
        f"{[round(x['max_abs_err_vs_dense_bf16'], 4) for x in ring]}"
        f" (bound 2 x {noise:.4g}), vs float32 "
        f"{[round(x['max_abs_err_vs_dense_f32'], 4) for x in ring]}; forward "
        f"wall {[round(x['wall_s'], 2) for x in ring]} s, staging "
        f"{[round(x['stage_s'], 2) for x in ring]} s, transfer waits "
        f"{[round(x['wait_s'], 2) for x in ring]} s, bytes sent "
        f"{[x['sent_bytes'] for x in ring]}; init "
        f"{[round(x['init_s'], 1) for x in ring]} s; peak memory "
        f"{[round(x['peak_gb'], 2) for x in ring]} GB; {card}")
    # (b) the sharded train steps of the tensor-parallel program
    tr = [r["train"] for r in lm]
    mo = [r["moe"] for r in lm]
    for cell, key, ranks in ((LM_TRAIN, "train", tr), (LM_MOE, "moe", mo)):
        lm_train_checks(cell, ranks, spec[key])
    for r, x in enumerate(mo):
        check(min(x["dropped"]) > 0 and min(x["ref_dropped"]) > 0
              and max(abs(a - b) for a, b in zip(x["dropped"],
                                                 x["ref_dropped"]))
              <= TOL_MOE_DROPPED,
              f"16b OLMoE rank {r}: dropped shares {x['dropped']} against "
              f"one process's {x['ref_dropped']} (each must be > 0)")
    sv = [r["serve"] for r in lm]
    ms = [r["moe_serve"] for r in lm]
    for what, ranks in (("Qwen", sv), ("OLMoE", ms)):
        lm_serve_checks(what, ranks)
    res["train"] = {"ranks": tr, "cut": f"{LM_TRAIN['layers']} of 36 layers",
                    "dry_run_dot_flops": spec["train"]["dot_flops"],
                    "dry_run_peak_bytes": spec["train"]["peak_bytes"],
                    "zero3_peak_gb": LM_TRAIN_ZERO3_PEAK_GB}
    res["serve"] = {"ranks": sv, **LM_SERVE}
    res["moe"] = {"ranks": mo, "serve_ranks": ms, **LM_MOE,
                  **{k: spec["moe"][k] for k in (
                      "cf", "serve_cf", "dot_flops", "peak_bytes",
                      "n_params", "ref_peak_gb")}}
    log(f"  16b Qwen2.5-3B at full width, depth cut to {LM_TRAIN['layers']} of"
        f" 36 layers, float32 on (2, 2): losses {tr[0]['losses']} (one "
        f"process {tr[0]['ref_losses']}); parameter shards within "
        f"{max(x['param_rel'] for x in tr):.3g} of one process's (norm over "
        f"the rank's shards; worst tensor "
        f"{max((x['worst_tensor_rel'], x['worst_tensor']) for x in tr)}); "
        f"bytes "
        f"per rank: parameters {[x['param_bytes'] for x in tr]} of "
        f"{tr[0]['whole_bytes']}, moments {[x['moment_bytes'] for x in tr]};"
        f" step walls {[[round(s, 2) for s in x['step_s']] for x in tr]} s; "
        f"staging {[round(x['stage_s'], 1) for x in tr]} s, waits "
        f"{[round(x['wait_s'], 1) for x in tr]} s, bytes sent "
        f"{[x['sent_bytes'] for x in tr]}, collectives a step "
        f"{[x['step_collectives'] for x in tr]}; compressed_psum within "
        f"{max(x['psum_int8_step_share'] for x in tr):.3g} of one int8 step "
        f"in {[round(x['psum_s'], 2) for x in tr]} s; peak over the 3 "
        f"steps {[round(x['peak_gb'], 2) for x in tr]} GB a rank (the "
        f"whole-slice gather's {LM_SLICE_PEAK_GB['qwen2.5-3b']} GB, the "
        f"ZeRO-3 step's {LM_TRAIN_ZERO3_PEAK_GB} GB; the dry run's "
        f"{spec['train']['peak_bytes'] / 1e9:.2f}); product flops a rank "
        f"{[x['dot_flops'] for x in tr]} (dry run "
        f"{spec['train']['dot_flops']:.6e}); {card}")
    log(f"  16b the same model on (data 1, model 4): prefill of "
        f"{LM_SERVE['batch']} x {LM_SERVE['prompt']} tokens and "
        f"{LM_SERVE['steps']} decode steps, cache shard "
        f"{sv[0]['cache_shard']} ({sv[0]['cache_placements']}); logits "
        f"within {max(max(x['errs']) for x in sv):.3g} of one process's "
        f"(relative to 1 + |theirs|, bound {TOL_TRAIN_GATE}); walls "
        f"{[[round(w, 3) for w in x['walls_s']] for x in sv]} s; bytes "
        f"sent {[x['sent_bytes'] for x in sv]}; peak "
        f"{[round(x['peak_gb'], 2) for x in sv]} GB; {card}")
    m = spec["moe"]
    log(f"  16b OLMoE-1B-7B at full width, depth cut to {LM_MOE['layers']} "
        f"of 16 layers ({m['n_params']} parameters), float32 on (2, 2), the "
        f"tensor-parallel program (experts over model, one dispatch group "
        f"over both batch shards), capacity factor {m['cf']}: losses "
        f"{mo[0]['losses']} (one process {mo[0]['ref_losses']}), gradient "
        f"norms {mo[0]['grad_norms']} (one process "
        f"{mo[0]['ref_grad_norms']}), dropped {mo[0]['dropped']} (one "
        f"process {mo[0]['ref_dropped']}); parameter shards within "
        f"{max(x['param_rel'] for x in mo):.3g} of one process's (worst "
        f"tensor {max((x['worst_tensor_rel'], x['worst_tensor']) for x in mo)}"
        f"); bytes per rank: parameters {[x['param_bytes'] for x in mo]} of "
        f"{mo[0]['whole_bytes']}, moments {[x['moment_bytes'] for x in mo]}; "
        f"step walls {[[round(s, 2) for s in x['step_s']] for x in mo]} s; "
        f"bytes sent over the 3 steps {[x['steps_sent_bytes'] for x in mo]};"
        f" staging {[round(x['stage_s'], 1) for x in mo]} s, waits "
        f"{[round(x['wait_s'], 1) for x in mo]} s; peak "
        f"{[round(x['peak_gb'], 2) for x in mo]} GB a rank (the whole-slice "
        f"gather's {LM_SLICE_PEAK_GB['olmoe-1b-7b']}; the dry run's "
        f"{m['peak_bytes'] / 1e9:.2f}; one process {m['ref_peak_gb']:.2f}); "
        f"collectives a step {[x['step_collectives'] for x in mo]}; "
        f"product flops a rank {[x['dot_flops'] for x in mo]} (dry run "
        f"{m['dot_flops']:.6e}); {card}")
    log(f"  16b the same OLMoE on (data 1, model 4) at capacity factor "
        f"{m['serve_cf']}: prefill of {LM_SERVE['batch']} x "
        f"{LM_SERVE['prompt']} tokens and {LM_SERVE['steps']} decode steps, "
        f"cache shard {ms[0]['cache_shard']}; logits within "
        f"{max(max(x['errs']) for x in ms):.3g} of one process's (relative "
        f"to 1 + |theirs|, bound {TOL_TRAIN_GATE}); walls "
        f"{[[round(w, 3) for w in x['walls_s']] for x in ms]} s; bytes sent "
        f"{[x['sent_bytes'] for x in ms]}; peak "
        f"{[round(x['peak_gb'], 2) for x in ms]} GB; {card}")


def lm_train_checks(cell: dict, ranks: list, spec: dict) -> None:
    """A 16b train cell's checks over its ranks: losses and gradient norms
    within ``TOL_TRAIN_GATE`` of one process's, the shards within
    ``TOL_SHARDED_PARAMS``, the bytes the sanitized shards', the
    ``compressed_psum`` check where the cell runs it, the program
    ``"fsdp_tp"`` and the product flops the dry run's (2, 2) cell's."""
    for r, x in enumerate(ranks):
        what_cell = f"16b {cell['arch']} rank {r}"
        for got, want, what in ((x["losses"], x["ref_losses"], "loss"),
                                (x["grad_norms"], x["ref_grad_norms"],
                                 "gradient norm")):
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            check(len(got) == cell["steps"] and rel <= TOL_TRAIN_GATE,
                  f"{what_cell}: {what}es {got} against one process's "
                  f"{want}")
        check(x["param_rel"] <= TOL_SHARDED_PARAMS, f"{what_cell}: its "
              f"parameter shards are {x['param_rel']:.3g} (norm) from one "
              "process's")
        check(x["param_bytes"] == x["want_bytes"] < x["whole_bytes"]
              and x["moment_bytes"] == 2 * x["param_bytes"],
              f"{what_cell}: {x['param_bytes']} parameter and "
              f"{x['moment_bytes']} moment bytes, its sanitized shards "
              f"{x['want_bytes']}")
        check(not cell.get("psum", True) or (
            x["psum_int8_step_share"] <= 1.0 and x["psum_resid_ok"]),
            f"{what_cell}: compressed_psum "
            f"{x.get('psum_int8_step_share', 0):.3g} int8 steps from the "
            f"float32 sum (residual exact {x.get('psum_resid_ok')})")
        check(x["program"] == "fsdp_tp", f"{what_cell}: the step ran "
              f"{x['program']}, not fsdp_tp")
        check(x["dot_flops"] == spec["dot_flops"], f"{what_cell}: "
              f"{x['dot_flops']} product flops on the card, the dry run's "
              f"(2, 2) cell {spec['dot_flops']}")
        was = LM_SLICE_PEAK_GB[cell["arch"]]
        check(cell["arch"] not in ("qwen2.5-3b", "olmoe-1b-7b")
              or x["peak_gb"] < was, f"{what_cell}: peak {x['peak_gb']:.2f} "
              f"GB, not under the whole-slice gather's {was} GB")


def lm_serve_checks(what: str, ranks: list) -> None:
    """A 16b serving cell's checks: the program, finite logits within
    ``TOL_TRAIN_GATE`` of one process's."""
    for r, x in enumerate(ranks):
        check(x["program"] == "fsdp_tp" and x["finite"]
              and max(x["errs"]) <= TOL_TRAIN_GATE,
              f"16b {what} rank {r}: the (1, 4) prefill and decode logits "
              f"{x['errs']} (relative to 1 + |one process's|) over "
              f"{TOL_TRAIN_GATE}; program {x['program']}")


def lm_family_checks(fam: list, spec: dict, res: dict, card: str) -> None:
    """Phase 16b's family cells: each checked as Qwen's, its readings
    printed and kept (into ``res["families"]``)."""
    res["families"] = {}
    for cell in LM_FAMILIES:
        arch = cell["arch"]
        ranks = [r[arch] for r in fam]
        lm_train_checks(cell, ranks, spec[arch])
        m = spec[arch]
        kept = {"ranks": ranks, **cell, **{k: m[k] for k in (
            "dot_flops", "peak_bytes", "n_params", "ref_peak_gb")}}
        log(f"  16b {arch} at its published width, "
            f"{cell['layers'] or 'all its'} layers ({m['n_params']} "
            f"parameters), float32 on (2, 2), the tensor-parallel program: "
            f"losses {ranks[0]['losses']} (one process "
            f"{ranks[0]['ref_losses']}), gradient norms "
            f"{ranks[0]['grad_norms']} (one process "
            f"{ranks[0]['ref_grad_norms']}); parameter shards within "
            f"{max(x['param_rel'] for x in ranks):.3g} of one process's "
            f"(worst tensor "
            f"{max((x['worst_tensor_rel'], x['worst_tensor']) for x in ranks)}"
            f"); bytes per rank: parameters "
            f"{[x['param_bytes'] for x in ranks]} of "
            f"{ranks[0]['whole_bytes']}; step walls "
            f"{[[round(t, 2) for t in x['step_s']] for x in ranks]} s; bytes "
            f"sent over the steps {[x['steps_sent_bytes'] for x in ranks]}; "
            f"staging {[round(x['stage_s'], 1) for x in ranks]} s, waits "
            f"{[round(x['wait_s'], 1) for x in ranks]} s; peak "
            f"{[round(x['peak_gb'], 2) for x in ranks]} GB a rank (the "
            f"whole-slice gather's {LM_SLICE_PEAK_GB[arch]}; the dry "
            f"run's {m['peak_bytes'] / 1e9:.2f}; one process "
            f"{m['ref_peak_gb']:.2f}); collectives a step "
            f"{[x['step_collectives'] for x in ranks]}; product flops a rank "
            f"{[x['dot_flops'] for x in ranks]} (dry run "
            f"{m['dot_flops']:.6e})"
            + (f"; compressed_psum within "
               f"{max(x['psum_int8_step_share'] for x in ranks):.3g} of one "
               f"int8 step" if cell.get("psum", True) else "")
            + f"; {card}")
        if cell.get("serve"):
            sv = [r[arch + "/serve"] for r in fam]
            lm_serve_checks(arch, sv)
            kept["serve_ranks"] = sv
            log(f"  16b the same {arch} on (data 1, model 4): prefill of "
                f"{LM_SERVE['batch']} x {LM_SERVE['prompt']} tokens and "
                f"{LM_SERVE['steps']} decode steps, layer 0's cache shard "
                f"{sv[0]['cache_shard']} ({sv[0]['cache_placements']}); "
                f"logits within {max(max(x['errs']) for x in sv):.3g} of one "
                f"process's (relative to 1 + |theirs|, bound "
                f"{TOL_TRAIN_GATE}); walls "
                f"{[[round(w, 3) for w in x['walls_s']] for x in sv]} s; "
                f"bytes sent {[x['sent_bytes'] for x in sv]}; peak "
                f"{[round(x['peak_gb'], 2) for x in sv]} GB; {card}")
        res["families"][arch] = kept


def lm_phase(card: str) -> dict:
    """Phase 16: the LM stack on ranks sharing the one card over gloo
    (host-staged): (a) OLMoE-1B-7B with the expert ring on a (1, 4) mesh,
    (b) the tensor-parallel train steps of Qwen2.5-3B and OLMoE-1B-7B on a
    (2, 2) mesh and their serving on (1, 4), all in one world of 4 ranks,
    then in a second world the family cells (``LM_FAMILIES``: Mamba2-130m,
    RecurrentGemma-2B, llava-next-mistral-7b) likewise, and
    (c) recovery from 9 ranks onto their survivors' 2x2.
    The single process's results come first (written for the ranks)."""
    import tempfile

    import chip_smoke     # the ranks import the rank functions by this name
    from repro_torch.core import api
    from repro_torch.launch.grid import run_grid, run_ranks
    api.clear_plan_cache()
    free()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spec = {"ring": lm_ring_expected(tmp)}
        spec["ring_train"] = lm_ring_train_expected(tmp)
        spec["train"] = lm_train_expected(tmp)
        spec["moe"] = lm_moe_expected(tmp)
        spec["recovery"] = lm_recovery_expected(tmp)
        for cell in LM_FAMILIES:
            spec[cell["arch"]] = lm_family_expected(tmp, cell)
        free()
        ref_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        lm = run_ranks(4, chip_smoke.lm_rank, spec, device=DEVICE,
                       timeout_s=LM_TIMEOUT_S)
        lm_s = time.perf_counter() - t1
        res = {"single_process_s": ref_s, "lm_ranks_s": lm_s}
        lm_checks(lm, spec, res, card)
        t1 = time.perf_counter()
        fam = run_ranks(4, chip_smoke.lm_family_rank, spec, device=DEVICE,
                        timeout_s=LM_TIMEOUT_S)
        res["family_ranks_s"] = fam_s = time.perf_counter() - t1
        lm_family_checks(fam, spec, res, card)
        t2 = time.perf_counter()
        rec = run_grid(LM_RECOVERY["g"], chip_smoke.lm_recovery_rank, spec,
                       backend="gloo", device=DEVICE,
                       timeout_s=LM_TIMEOUT_S)
        rec_s = time.perf_counter() - t2
    res["recovery_ranks_s"] = rec_s
    # (c) recovery
    surv = [r for r in rec if r["survivor"]]
    check(len(surv) == 4 and all(r["g"] == 2 for r in rec),
          f"16c: {len(surv)} survivor ranks on the new grid")
    launches = sum(r["launches"] for r in rec)
    check(launches > 0 and all(r["launches"] > 0 for r in surv),
          f"16c: B1 did not launch on every survivor: "
          f"{[r['launches'] for r in surv]}")
    kern = next(r["kernel"] for r in surv if "kernel" in r)
    spans = rec[0]["host_ms"]
    res["recovery"] = {"ranks": rec, "launches": launches, "kernel": kern}
    log(f"  16c steal3d at the SpMM cell, 9 ranks -> the survivors' 2x2: "
        f"survivor ranks {[r['rank'] for r in surv]}; C tiles bit-equal to "
        f"the stacked recovery's {[r['equal'] for r in surv]}; B1 launches "
        f"{[r['launches'] for r in surv]}, blocks multiplied "
        f"{[r['blocks_multiplied'] for r in surv]} (= real pairs "
        f"{[r['real_pairs'] for r in surv]}); findings "
        f"{[r['findings'] for r in surv]}; reshard bytes sent by rank "
        f"{[r['reshard_bytes'] for r in rec]}; recovery host ms by span "
        f"(slowest rank) "
        f"{ {k: round(max(r['host_ms'][k] for r in rec), 1) for k in spans} };"
        f" recovered multiply wall {surv[0]['wall_ms']:.1f} ms; B1 at a "
        f"survivor's shape {kern['ms']:.3f} ms (plain {kern['plain_ms']:.3f},"
        f" bound {kern['bound_ms']:.3f} by {kern['bound_by']}); {card}")
    res["s"] = time.perf_counter() - t0
    log(f"  phase 16 wall {res['s']:.1f} s (single process {ref_s:.1f} s, "
        f"4 ranks {lm_s:.1f} s, the families' 4 ranks {fam_s:.1f} s, 9 "
        f"ranks {rec_s:.1f} s)")
    return res


def lm_record(lm: dict) -> dict:
    """Phase 16c's entry of the ``{"kernels": [...]}`` line: B1 at a
    survivor rank's recovered steal3d shape, with the launches of every
    rank's recovered multiply."""
    k = lm["recovery"]["kernel"]
    return {"name": "bsr_spmm (recovered steal3d, a survivor rank)",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/"
            "bsr_spmm.cu", "replaces": "src/repro/kernels/bsr_spmm.py:55",
            "launches": lm["recovery"]["launches"], "dtype": "float32",
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
            "shape": k["shape"], "kernel": "bsr_spmm", "transport":
            "gloo (host-staged)"}


# ---------------------------------------------------------------------------
# phase 17: the dry run against one real step, production cells, examples
# ---------------------------------------------------------------------------
def dryrun_gate() -> dict:
    """Phase 17a, before the published training run: the dry run of its
    cell (``TRAIN``: Qwen2.5-3B, bf16 over float32 state, remat) on one
    rank, printed; then the same program on the card, recorded the same
    way.  Parameter and moment bytes must be equal, product flops equal,
    and the predicted peak within ``DRYRUN_PEAK_TOL`` of the real step's
    ``max_memory_allocated`` (less what was allocated before it: the
    state is built inside the measured window)."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.launch import dryrun
    t = TRAIN
    cfg = get_config(t["arch"])
    shape = Shape(f"train_{t['batch']}x{t['seq']}", "train", t["seq"],
                  t["batch"])
    t0 = time.perf_counter()
    pred = dryrun.run_cell(t["arch"], shape.name, "single", cfg=cfg,
                           shape=shape, mesh_shape=(1, 1))
    pred_s = time.perf_counter() - t0
    check(pred["status"] == "ok", f"the dry run of {t['arch']} "
          f"{shape.name} failed: {pred.get('error')}\n"
          f"{pred.get('traceback')}")
    args, flops = pred["arguments"], pred["hlo_stats"]["dot_flops"]
    log(f"  prediction (FakeTensorMode, one rank, {pred_s:.1f} s): "
        f"parameters {args['params'] / 1e9:.3f} GB, moments "
        f"{args['moments'] / 1e9:.3f} GB, batch {args['batch']} B; "
        f"temporaries {pred['memory_analysis']['temp_size_in_bytes'] / 1e9:.3f}"
        f" GB; peak {pred['peak_bytes'] / 1e9:.3f} GB; product flops "
        f"{flops:.6e}")
    free()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with dryrun.fake_world((1, 1)) as mesh:
        real = dryrun.record_cell(cfg, shape, mesh, DEVICE, fake=False,
                                  seed=t["seed"])
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    real_peak = torch.cuda.max_memory_allocated() - before
    ra, real_flops = real["arguments"], real["stats"].dot_flops
    state_pred, state_real = (args["params"] + args["moments"],
                              ra["params"] + ra["moments"])
    miss = (pred["peak_bytes"] - real_peak) / real_peak
    log(f"  the same step on the card ({real_s:.1f} s, state built "
        f"inside): parameters and moments {state_real / 1e9:.3f} GB "
        f"(predicted {state_pred / 1e9:.3f}); product flops "
        f"{real_flops:.6e}; max_memory_allocated {real_peak / 1e9:.3f} GB "
        f"over {before / 1e9:.3f} GB allocated before, the recorder's own "
        f"peak {(real['memory']['argument_size_in_bytes'] + real['memory']['temp_size_in_bytes']) / 1e9:.3f} GB; "
        f"predicted peak {pred['peak_bytes'] / 1e9:.3f} GB, off by "
        f"{100 * miss:+.2f} % (allowed {100 * DRYRUN_PEAK_TOL:.0f} %)")
    check(state_pred == state_real, f"predicted parameter and moment bytes "
          f"{state_pred} differ from the real {state_real}")
    check(flops == real_flops, f"predicted product flops {flops} differ "
          f"from the real step's {real_flops}")
    check(abs(miss) <= DRYRUN_PEAK_TOL, f"the predicted peak misses the "
          f"real one by {100 * miss:+.2f} %")
    del real
    free()
    return {"prediction": {k: pred[k] for k in (
        "arguments", "memory_analysis", "hlo_stats", "roofline",
        "peak_bytes", "fits", "compile_seconds")},
        "real": {"arguments": ra, "dot_flops": real_flops,
                 "peak_bytes": real_peak, "allocated_before": before,
                 "s": real_s},
        "peak_miss": miss, "prediction_s": pred_s}


def example_child(name: str) -> None:
    """Run ``examples/<name>.py`` on the card in this (child) process with
    B1's and B2's counters on; print its counts as one ``EXAMPLE_COUNTS``
    JSON line and exit with the example's code."""
    import runpy
    sys.path.insert(0, str(ROOT / "src"))
    extra, _ = EXAMPLES[name]
    blocks, pairs = serve_counters_on()
    reset_counts()
    mod = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                         run_name="example")
    rc = mod["main"](["--device", DEVICE, *extra])
    counts = {"launches": read_counts(), **serve_counters_off(blocks, pairs)}
    print("EXAMPLE_COUNTS " + json.dumps(counts), flush=True)
    sys.exit(rc)


def start_examples() -> dict:
    """Start every example's child (phase 17c); they run while the dry
    run's production cells are traced."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return {name: subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.example_child({name!r})"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in EXAMPLES}


def finish_examples(procs: dict) -> dict:
    """Wait for every example's child: each must exit 0 with its own
    correctness line, launch the kernels ``EXAMPLES`` names, and each
    kernel multiply exactly its tables' real blocks or pairs."""
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            check(False, f"{name} ran past {EXAMPLE_TIMEOUT_S} s")
        lines = stdout.strip().splitlines()
        counts = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                  if ln.startswith("EXAMPLE_COUNTS ")]
        shown = [ln for ln in lines if not ln.startswith("EXAMPLE_COUNTS ")]
        check(proc.returncode == 0 and len(counts) == 1,
              f"{name} exited {proc.returncode}: {stdout[-3000:]}"
              f"{stderr[-3000:]}")
        c = counts[0]
        log(f"  {name}: exit 0, \"{shown[-1]}\"; launches "
            f"{c['launches']}; B1 blocks {c['blocks_multiplied']} of its "
            f"tables' {c['table_blocks']} real, B2 pairs "
            f"{c['pairs_multiplied']} of {c['table_pairs']}")
        for kernel in EXAMPLES[name][1]:
            check(c["launches"][kernel] > 0, f"{name} launched no {kernel}")
        check(c["blocks_multiplied"] == c["table_blocks"]
              and c["pairs_multiplied"] == c["table_pairs"],
              f"{name}: a kernel multiplied other than its tables' real "
              f"blocks or pairs: {c}")
        out[name] = {"last_line": shown[-1], **c}
    return out


def dryrun_phase() -> dict:
    """Phase 17b and 17c: the production cells on a fake 16 x 16 world,
    each ``ok``, while the examples run on the card in children."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    procs = start_examples()
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, "single")
        check(rec["status"] == "ok", f"dry run {arch} {shape}: "
              f"{rec.get('error')}\n{rec.get('traceback')}")
        cells[f"{arch} {shape}"] = {k: rec[k] for k in (
            "n_chips", "compile_seconds", "arguments", "memory_analysis",
            "hlo_stats", "roofline", "peak_bytes", "fits")}
    examples = finish_examples(procs)
    secs = time.perf_counter() - t0
    log(f"  phase 17b/17c wall {secs:.1f} s")
    return {"cells": cells, "examples": examples, "s": secs}


def record(name: str, source: str, replaces: str, launches: int,
           kres: dict, extra: dict) -> dict:
    """One entry of the ``{"kernels": [...]}`` line: float32 numbers at the
    top, bf16 ones under ``bf16``."""
    f32, b16 = kres[torch.float32], kres[torch.bfloat16]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "dtype": "float32"}
    rec.update({k: f32.get(k) for k in keys})
    rec.update(extra)
    rec["bf16"] = {k: b16.get(k) for k in keys + (
        "bytes", "path", "share_of_bound", "library_bsr_ms") if k in b16}
    return rec


def serve_records(serve: dict, model: str = "serving"):
    """The serving shapes' entries of the ``{"kernels": [...]}`` line, with
    the launches of the bf16 serving run: B1's counted by product where it
    launches (``bsr_spmm_cuda.by_shape``), B2's by its wrapper.  ``model``
    names the run in the entries (phase 11's OLMoE: "serving")."""
    pub, kern = serve["published"], serve["kernels"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def rec(name, kernel, source, replaces, launches, res):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "dtype": res["shape"]["dtype"] if "shape" in res
                else "float32", **{k: res.get(k) for k in keys},
                **{k: res[k] for k in ("real_blocks", "real_pairs",
                                       "real_flops", "bytes", "path",
                                       "library_bsr_ms", "shape")
                   if k in res}, "kernel": kernel}

    b1src = "src/repro_torch/kernels/csrc/bsr_spmm.cu"
    b1 = [rec(f"bsr_spmm ({model} {label} shape)", "bsr_spmm", b1src,
              "src/repro/kernels/bsr_spmm.py:55",
              pub["b1_by_product"][key], kern[key])
          for key, label in (("dispatch", "MoE dispatch"),
                             ("combine", "MoE combine"), ("pv", "P @ V"))
          if key in kern]
    b2 = rec(f"bsr_pair_accumulate ({model} scores shape)",
             "bsr_pair_accumulate",
             "src/repro_torch/kernels/csrc/bsr_pair.cu",
             "src/repro/kernels/bsr_spmm.py:165",
             pub["launches"]["bsr_pair_accumulate"], kern["scores"])
    check(sum(r["launches"] for r in b1) == pub["launches"]["bsr_spmm"],
          "the serving shapes' B1 launches do not add up to the run's")
    return b1, b2


def grid_records(grid: dict) -> list:
    """Phase 15's entries of the ``{"kernels": [...]}`` line: B1 and B2 at
    a rank's one-tile shapes, with the launches of every rank's run."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    out = []
    for kernel, name, source, replaces in (
            ("bsr_spmm", "bsr_spmm (rank one-tile SpMM shape)",
             "src/repro_torch/kernels/csrc/bsr_spmm.cu",
             "src/repro/kernels/bsr_spmm.py:55"),
            ("bsr_pair_accumulate",
             "bsr_pair_accumulate (rank one-tile sparse-output shape)",
             "src/repro_torch/kernels/csrc/bsr_pair.cu",
             "src/repro/kernels/bsr_spmm.py:165")):
        res = grid["kernels"][kernel]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": grid["launches"][kernel],
                    "dtype": "float32", **{k: res.get(k) for k in keys},
                    "shape": res["shape"], "kernel": kernel,
                    "transport": grid["transport"]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 1
    # a fixed cuBLAS workspace, which the training phase's resume check
    # needs under deterministic algorithms (PyTorch's default size on
    # Hopper), set before the first product creates the handle's
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.api import NATURAL, DistBSR, DistDense, plan_matmul
    from repro_torch.core.bsr import rmat_matrix
    from repro_torch.runtime.device import strict_fp32

    strict_fp32()
    device = torch.device(DEVICE)
    t_start = time.perf_counter()
    log("== environment")
    card = environment()
    log("== build")
    build_s = build_kernels()

    log("== kernels vs plain versions, small cases")
    small_kernel_cases(device)
    pair_small_cases(device)
    phase_peak("small kernel cases")

    log("== dense-output path (ring_c SpMM and SpGEMM, B1)")
    a_np, a32, a16, b_np, b32, b16 = main_path_operands(device)
    a14_np = rmat_matrix(SPGEMM["scale"], 8, seed=SPGEMM["seed"])
    a14 = DistBSR.from_dense(a14_np, g=SPGEMM["g"],
                             block_size=SPGEMM["block_size"], device=device)
    # R-MAT 1.0 is exact in bf16: the bf16 handle casts the blocks
    a14_16 = DistBSR(dataclasses.replace(
        a14.tiled, blocks=a14.tiled.blocks.to(torch.bfloat16)))
    log(f"SpGEMM operand: R-MAT scale {SPGEMM['scale']}, bs "
        f"{SPGEMM['block_size']}, g {SPGEMM['g']}: real blocks per tile "
        f"{a14.counts.cpu().numpy().ravel().tolist()}, capacity "
        f"{a14.capacity}, store capacity {a14.tiled.store_capacity}")
    kres = main_path_kernel_cases([
        ("SpMM", torch.float32, a32, b32), ("SpMM", torch.bfloat16, a16, b16),
        ("SpGEMM", torch.float32, a14, a14),
        ("SpGEMM", torch.bfloat16, a14_16, a14_16)])
    del a14_16
    phase_peak("B1 main-path kernel cases")
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
    del a_dense, a_abs, b_t, b_t16
    a14_dense = torch.from_numpy(a14_np).to(device)
    del a14_np
    oracle_gemm = a14_dense @ a14_dense
    scale_gemm = a14_dense.abs() @ a14_dense.abs()
    del a14_dense
    # on the single-stream executor overlap="auto" is the bulk body of "off"
    check(plan_matmul(a32, b32, overlap="auto").geom
          == plan_matmul(a32, b32, overlap="off").geom,
          "overlap='auto' does not resolve to the bulk body")
    check(plan_matmul(a32, b32, wire="packed").wire == "packed",
          "wire='packed' did not pack the SpMM operand")
    torch.cuda.synchronize()

    reset_counts()                  # counts of this path's run only
    e2e = {}
    for label, a_h, b_h, oracle, scale, tol, overlap, wire in (
            ("SpMM float32 g=2", a32, b32, oracle32, scale32, TOL_F32_DEEP,
             "auto", "auto"),
            ("SpMM bfloat16 g=2", a16, b16, oracle16, scale16,
             TOL_F32_DEEP + a16.g * BF16_ROUND, "auto", "auto"),
            ("SpMM float32 g=2", a32, b32, oracle32, scale32, TOL_F32_DEEP,
             "auto", "packed"),
            (f"SpMM float32 g={SPMM_G3}", a3, b3, oracle32, scale32,
             TOL_F32_DEEP, "on", "auto"),
            (f"SpMM float32 g={SPMM_G3}", a3, b3, oracle32, scale32,
             TOL_F32_DEEP, "off", "auto"),
            ("SpGEMM float32 g=2", a14, a14, oracle_gemm, scale_gemm,
             TOL_F32_SMALL, "auto", "auto")):
        e2e[f"{label} overlap={overlap} wire={wire}"] = e2e_case(
            label, a_h, b_h, oracle, scale, tol, overlap, wire=wire)
    dense_counts = read_counts()
    launches = {shape: sum(v["launches"] for k, v in e2e.items()
                           if k.startswith(shape)) for shape in
                ("SpMM", "SpGEMM")}
    log(f"  launches on the dense-output path: {dense_counts} (B1: "
        f"{launches['SpMM']} at the SpMM shapes, {launches['SpGEMM']} at "
        f"SpGEMM's); B1 blocks multiplied "
        f"{sum(v['blocks_multiplied'] for v in e2e.values())} in the "
        f"counted multiplies, all real")
    check(dense_counts["bsr_spmm"] == sum(launches.values())
          and min(launches.values()) > 0,
          "the dense-output path did not launch bsr_spmm at both shapes")
    b1_paths = dict(kernel_wrappers()["bsr_spmm"].paths)
    log(f"  B1 launches by path on the dense-output path: {b1_paths}")
    # SpMM on the element path, the SpGEMM's B left sparse (sparse-B path)
    check(b1_paths == {"elements": launches["SpMM"], "blocks": 0,
                       "sparse_b": launches["SpGEMM"]},
          f"a dense-output launch at the cells' fill took another path "
          f"({b1_paths})")
    breakdown = {
        "SpMM float32": device_breakdown(
            a32, b32, "SpMM float32", operands=(
                a32.placed(NATURAL)["blocks"], b32.data,
                b32.placed(NATURAL)["dense"])),
        "SpMM float32 packed": device_breakdown(
            a32, b32, "SpMM float32 wire=packed", wire="packed", operands=(
                a32.packed_wire(NATURAL)["blocks"], a32.tiled.blocks,
                b32.data, b32.placed(NATURAL)["dense"])),
        "SpGEMM float32": device_breakdown(a14, a14, "SpGEMM float32")}
    for name in ("SpMM float32", "SpMM float32 packed"):
        bd = breakdown[name]
        check(not bd["operand_copies"]
              and not bd["rolls"],
              f"{name}: the multiply rolls or gathers an operand "
              f"({bd['operand_copies']})")
    # B1's NaN pass on finite B, against the multiply of each main-path
    # cell (g launches a multiply, each followed by its pass).  The element
    # path's pass reads every B chunk a real block reads, once: it is held
    # to that read (within 3 x its time at the HBM peak, two small
    # launches included), and its share of the multiply is recorded.
    flag_share = {}
    for shape, key in (("SpMM", "SpMM float32 g=2 overlap=auto wire=auto"),
                       ("SpGEMM",
                        "SpGEMM float32 g=2 overlap=auto wire=auto")):
        nf = kres[(shape, torch.float32)]["nonfinite"]
        flag_ms, read_ms = nf["flag_ms"], nf["flag_read_ms"]
        flag_share[shape] = SPMM["g"] * flag_ms / e2e[key]["ms"]
        log(f"  B1's NaN pass on finite B at the {shape} cell: "
            f"{SPMM['g']} x {flag_ms * 1e3:.1f} us a multiply of "
            f"{e2e[key]['ms']:.2f} ms, {100 * flag_share[shape]:.3f} %; "
            f"{flag_ms / read_ms:.2f} x one read of its B chunks")
        check(flag_ms <= 3 * read_ms, f"B1's NaN pass takes "
              f"{flag_ms * 1e3:.1f} us a launch at the {shape} shape, "
              f"{flag_ms / read_ms:.2f} x one read of its B chunks")
    dense_peak = phase_peak("dense-output path")

    ops = {"a32": a32, "b32": b32, "a16": a16, "b16": b16, "a3": a3,
           "b3": b3, "a14": a14, "oracle32": oracle32, "scale32": scale32,
           "oracle16": oracle16, "scale16": scale16,
           "oracle_gemm": oracle_gemm, "scale_gemm": scale_gemm,
           "ring_c": e2e["SpMM float32 g=2 overlap=auto wire=auto"]}
    log("== steal3d (the paper's SS3.4 work stealing, through B1)")
    steal = steal3d_phase(ops)
    ops["steal3d"] = steal["e2e"]["SpMM float32 g=2 overlap=off wire=auto"]
    steal_peak = phase_peak("steal3d")
    log("== other schedules (summa_bcast, summa_ag, ring_a, ring_c_bidir; "
        "algorithm='auto' over all six)")
    other = other_schedules(ops)
    other_peak = phase_peak("other schedules")
    log("== obs: one traced multiply")
    traced = obs_phase(a32, b32)
    b1 = [record(f"bsr_spmm ({shape} shape)",
                 "src/repro_torch/kernels/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:55",
                 launches[shape] + other["launches"][shape],
                 {dt: kres[(shape, dt)] for dt in (torch.float32,
                                                   torch.bfloat16)},
                 {"shape": kres[(shape, torch.float32)]["shape"],
                  **{k: kres[(shape, torch.float32)][k] for k in (
                      "flops", "real_flops", "stored_flops", "bytes",
                      "real_blocks", "stored_blocks", "blocks_multiplied",
                      "workspace_bytes", "share_of_bound",
                      "library_bsr_ms", "path")},
                  "nonfinite": kres[(shape, torch.float32)]["nonfinite"],
                  "nan_pass_share_of_multiply": flag_share[shape]})
          for shape in ("SpMM", "SpGEMM")]
    # steal3d's pair lists launch the block path (at both cells' shapes)
    blocks_key = "SpMM block path"
    b1.append(record(
        "bsr_spmm (SpMM shape, block path)",
        "src/repro_torch/kernels/csrc/bsr_spmm.cu",
        "src/repro/kernels/bsr_spmm.py:55",
        steal["launches"]["SpMM"] + steal["launches"]["SpGEMM"],
        {dt: kres[(blocks_key, dt)] for dt in (torch.float32,
                                               torch.bfloat16)},
        {"shape": kres[(blocks_key, torch.float32)]["shape"],
         **{k: kres[(blocks_key, torch.float32)][k] for k in (
             "flops", "real_flops", "stored_flops", "bytes", "real_blocks",
             "stored_blocks", "blocks_multiplied", "workspace_bytes",
             "share_of_bound", "path")}}))
    del kres, a32, a16, b32, b16, a3, b3, a14, a_h, b_h, ops
    del oracle, scale
    del oracle32, scale32, oracle16, scale16, oracle_gemm, scale_gemm
    free()

    log("== B1's sparse-B path at the square cell's shape")
    b1.append(sparse_b_square(device))
    phase_peak("sparse-B square")
    free()

    log("== sparse-output path (ring_c, output='auto', B2)")
    sparse = sparse_path(device)
    free()
    log("== chained cube (spgemm_bench configuration)")
    cube_counts = chained_cube(device)
    phase_peak("chained cube")
    free()
    log("== dense-tile SpGEMM entry point (ops.bsr_pair_matmul, B3)")
    tile = pair_tile_path(device)
    free()
    log("== serving (OLMoE-1B-7B through ServeEngine(sparse=True), B1 and "
        "B2)")
    serve = serving_phase()
    log("== training (train(): the smoke gate against the CPU, resume, "
        "Qwen2.5-3B at its published size)")
    training = training_phase()
    log("== elastic replanning and the static verifier (SpMM cell, "
        "OLMoE-1B-7B serving, the selftest)")
    t13 = time.perf_counter()
    elastic = elastic_phase(sparse.pop("a_h"), serve["gate"]["tokens"])
    elastic["s"] = time.perf_counter() - t13
    elastic_peak = phase_peak("elastic replanning")
    log("== recurrent, SSM and frontend families (RecurrentGemma-2B served, "
        "Mamba2-130m and hubert-xlarge trained, llava-next-mistral-7b "
        "decoded)")
    t14 = time.perf_counter()
    recurrent = recurrent_phase()
    recurrent["s"] = time.perf_counter() - t14
    log("== process grid: the schedules on 4 ranks sharing the card (gloo, "
        "host-staged), B1 and B2 on every rank")
    grid = grid_phase(card)
    log("== the LM stack on ranks sharing the card (gloo, host-staged): "
        "OLMoE-1B-7B's expert ring, Qwen2.5-3B's sharded train step, "
        "recovery from 9 ranks with B1 on every survivor")
    lm = lm_phase(card)
    log("== the dry run on a fake 16x16 world of H100 ranks (three "
        "production cells) and the five examples on the card")
    dry = dryrun_phase()

    # phase 13's launches outside serving run at the SpMM cell's and the
    # sparse path's shapes
    el13 = {k: sum(elastic["launches"][p][k] for p in (
        "validation", "replan", "recovery")) for k in ("bsr_spmm",
                                                       "bsr_pair_accumulate")}
    b1[0]["launches"] += el13["bsr_spmm"]
    b1[0]["elastic_launches"] = el13["bsr_spmm"]
    carry = sparse["carry"]
    b2 = record("bsr_pair_accumulate",
                "src/repro_torch/kernels/csrc/bsr_pair.cu",
                "src/repro/kernels/bsr_spmm.py:165",
                sparse["launches"] + el13["bsr_pair_accumulate"],
                sparse["kernel"], {
                    "elastic_launches": el13["bsr_pair_accumulate"],
                    **{k: sparse["kernel"][torch.float32][k] for k in (
                        "real_flops", "pair_flops", "bytes", "real_pairs",
                        "pairs", "pairs_multiplied", "workspace_bytes",
                        "path")},
                    "main_path_pairs_multiplied": sparse["pairs_multiplied"],
                    "accumulate_step1": {
                        "ms": carry[torch.float32]["ms"],
                        "bf16_ms": carry[torch.bfloat16]["ms"],
                        "bound_ms": carry[torch.float32]["bound_ms"],
                        "bf16_bound_ms": carry[torch.bfloat16]["bound_ms"],
                        "real_pairs": carry[torch.float32]["real_pairs"],
                        "pairs_multiplied":
                            carry[torch.float32]["pairs_multiplied"],
                        "visited_slots":
                            carry[torch.float32]["visited_slots"]}})
    b3 = record("bsr_pair_matmul", "src/repro_torch/kernels/csrc/bsr_pair.cu",
                "src/repro/kernels/bsr_spmm.py:115", tile["launches"],
                tile["kernel"], {k: tile["kernel"][torch.float32][k] for k
                                 in ("real_flops", "pair_flops", "bytes",
                                     "real_pairs", "pairs",
                                     "pairs_multiplied", "path")})
    # the examples run at their own shapes: their launches stand beside
    # the rows' counts, not in them
    ex_launches = {k: sum(e["launches"][k] for e in dry["examples"].values())
                   for k in ("bsr_spmm", "bsr_pair_accumulate")}
    b1[0]["examples_launches"] = ex_launches["bsr_spmm"]
    b2["examples_launches"] = ex_launches["bsr_pair_accumulate"]
    b1_serve, b2_serve = serve_records(serve)
    b1_rg, b2_rg = serve_records(recurrent["serve"], "recurrentgemma")
    log(json.dumps({"build_s": build_s, "e2e": e2e, "breakdown": breakdown,
                    "sparse_output": {k: sparse[k] for k in (
                        "e2e_ms", "symbolic_s", "plan_rest_s",
                        "c_store_bytes", "workspace_bytes", "breakdown",
                        "peak_gb")},
                    "cube_launches": cube_counts,
                    "other_schedules": {k: other[k] for k in (
                        "e2e", "launches", "auto", "bidir_split_ms")},
                    "other_breakdown": other["breakdown"],
                    "steal3d": {k: steal[k] for k in ("e2e", "launches",
                                                      "breakdown")},
                    "obs": traced,
                    "sparse_summa": sparse["summa"],
                    "peak_gb": {"dense_output": dense_peak,
                                "steal3d": steal_peak,
                                "other_schedules": other_peak,
                                "sparse_output": sparse["peak_gb"],
                                "elastic": elastic_peak,
                                "dense_tile": tile["peak_gb"]},
                    "serving": {k: serve[k] for k in ("gate",
                                                      "published")},
                    "training": training,
                    "elastic": elastic,
                    "recurrent": {"serving": {k: recurrent["serve"][k] for k
                                              in ("gate", "published")},
                                  **{k: recurrent[k] for k in (
                                      "mamba", "hubert", "llava", "s")}},
                    "grid": {k: v for k, v in grid.items()
                             if k != "kernels"},
                    "lm": lm,
                    "dryrun": dry,
                    "card": card,
                    "total_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [*b1, b2, b3, *b1_serve, b2_serve, *b1_rg,
                                b2_rg, *grid_records(grid),
                                lm_record(lm)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
