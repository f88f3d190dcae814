"""Plan-based public API of the port.

Port of ``repro/core/api.py``:

* :class:`DistBSR` / :class:`DistDense` — distributed-matrix handles
  wrapping a :class:`~repro_torch.core.bsr.TiledBSR` / a grid-padded dense
  tensor, with a cache of placements (the paper's ``k_offset`` skew is
  materialised at most once per operand and placement), and for sparse
  handles their structure, fingerprint and packed wire layout.
* :func:`plan_matmul` -> :class:`MatmulPlan` — geometry, placement needs,
  the schedule body and its plan-time constants (pair lists, consume
  maps), cached in an LRU plan cache.  ``plan.cost_model()`` gives the
  per-step network volume and flops that feed ``core/roofline.py``.
* :func:`matmul` — sparse x dense (SpMM), sparse x sparse (SpGEMM) and
  dense x dense through :data:`REGISTRY` (an :class:`AlgorithmRegistry`).
  SpGEMM gives a dense output (B densified once per multiply) or, with
  ``output="sparse"`` / ``"auto"``, a :class:`DistBSR`: a host-side
  symbolic phase (:func:`symbolic_spgemm`) predicts C's block structure and
  the numeric phase accumulates block products straight into its packed
  slots, so chained multiplies never densify.  ``wire="packed"`` moves only
  each tile's real blocks (``core/wire.py``).

The schedules (see the body docstrings): ``summa_bcast`` / ``summa_ag``,
the bulk-synchronous baselines; ``ring_c`` / ``ring_a``, the paper's
stationary-C and stationary-A rings with placement-time ``k_offset``
skew; ``ring_c_bidir``, a stationary-C ring whose output column halves
ride opposite directions; ``steal3d``, the static realisation of the
paper's SS3.4 locality-aware work stealing (a plan-time LPT assignment of
the (i, k, j) work grid, ``core/steal3d.py``, run as per-device pair
lists with moved-tile and owner-reduction rounds).  ``algorithm="auto"``
scores every registered schedule with the alpha-beta-gamma cost model
(:func:`auto_select`, on
:data:`~repro_torch.core.roofline.H100_SXM` unless told otherwise) and
builds the cheapest.  The scores describe the g x g grid of cards the
schedules are written for, not the one-card stand-in below, which moves
no tile.

Where the JAX package runs the body under ``shard_map`` on a device mesh,
the port runs it on a :class:`~repro_torch.core.executor.StackedExecutor`:
the g x g tiles live stacked on one card, and each step's local multiply
is one batched kernel launch.  A ring shift, a broadcast or an all-gather
becomes a tile map: the kernel reads each step's tiles where they lie.
With ``mesh=`` the same schedules run on a process grid, one tile per
rank (:class:`~repro_torch.core.executor.GroupExecutor`): the JAX bodies
step by step, their exchanges point-to-point and collective calls of
``torch.distributed`` (see "Bodies on a process grid" below).

Observability (``repro_torch.obs``): with tracing on, plan builds record
``plan_build.*`` spans and each multiply a ``multiply.<algorithm>`` span
and a drift record (measured seconds, synchronised, beside the cost
model's prediction on :func:`set_drift_machine`'s machine); with tracing
off a multiply reads no clock and waits for nothing.  The plan caches
report through the metrics registry (``plan_caches``).

Static verification (``repro_torch.analysis``): ``plan_matmul(validate=
"fast"|"full")`` and :meth:`MatmulPlan.validate` prove a plan's metadata
(and, with ``"full"``, the ops of one multiply) before it is handed back.

Also here: :func:`invalidate_plans` (keyed cache eviction),
:func:`reshard` (re-tiling a handle onto another grid) and
:func:`validate_mesh` (the executors' grid check).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs as _obs
from ..kernels import ops as kops
from ..kernels.bsr_pair import pair_table
from ..kernels.bsr_spmm import PoolLists, SpmmTable
from ..kernels.bsr_spmm import spmm_table as _spmm_table
from ..runtime.device import as_tensor, resolve_device, strict_fp32
from . import roofline as _roofline
from . import schedule as _schedule
from . import steal3d as _steal3d
from . import symbolic as _symbolic
from . import wire as _wire
from .bsr import TiledBSR
from .dist import (place_b_for_stationary_a, skew_bsr, skew_dense, tileize,
                   unskew_c_rows, untileize)
from .executor import GroupExecutor, StackedExecutor, _Ready
from .grid import ProcessGrid, bucket_capacity, ceil_div, pad_to_multiple
from .symbolic import (SymbolicProduct, predicted_density,  # re-export
                       symbolic_spgemm)
from .wire import PackedOperand, wire_capacity              # re-export

__all__ = [
    "NATURAL", "SKEW_ROWS", "SKEW_COLS", "STATIONARY_A", "PLACEMENTS",
    "DistMatrix", "DistBSR", "DistDense",
    "Algorithm", "AlgorithmRegistry", "REGISTRY", "register_algorithm",
    "algorithms", "sparse_algorithms", "auto_select", "recommended_balance",
    "MatmulPlan", "plan_matmul", "matmul",
    "SymbolicProduct", "symbolic_spgemm", "predicted_density",
    "PackedOperand", "wire_capacity", "SPARSE_OUTPUT_DENSITY_THRESHOLD",
    "add_trace_hook", "remove_trace_hook", "set_drift_machine",
    "clear_plan_cache", "plan_cache_size", "cache_stats",
    "invalidate_plans", "reshard", "reshard_on_grid",
    "validate_mesh",
]

# Placement states a DistMatrix can hold (the paper's directory remaps).
NATURAL = "natural"            # tile (i, j) at grid position (i, j)
SKEW_ROWS = "skew_rows"        # position (i, j) holds tile (i, (i+j)%g)
SKEW_COLS = "skew_cols"        # position (i, j) holds tile ((i+j)%g, j)
STATIONARY_A = "stationary_a"  # position (i, j) holds tile (j, (i+j)%g)
PLACEMENTS = (NATURAL, SKEW_ROWS, SKEW_COLS, STATIONARY_A)


@dataclasses.dataclass(frozen=True)
class _Geom:
    """Static geometry of a plan, threaded to the schedule body."""
    g: int
    tm: int           # local C tile rows
    tn: int           # local C tile cols
    a_nbr: int        # block-rows per A tile (0 => dense A)
    b_nbr: int        # block-rows per B tile (0 => dense B)
    b_nbc: int        # block-cols per B tile (0 => dense B)
    impl: Optional[str]
    out_dtype: torch.dtype
    overlap: bool = False
    # split-step body (plan_matmul(overlap="on")): step t+2's ring shift is
    # issued before step t's accumulate
    c_store: int = 0  # packed C slots per tile (sparse-output plans only)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Local tile math on the stacked grid (operand trees hold only tensors)
# ---------------------------------------------------------------------------
def _densify_b(b: Dict, geom: _Geom, ex: StackedExecutor) -> Dict:
    """Densify a sparse B tile grid once, before the ring steps."""
    if "dense" in b:
        return b
    d = kops.densify(ex.batch(b["blocks"]), ex.batch(b["rows"]),
                     ex.batch(b["cols"]), n_block_rows=geom.b_nbr,
                     n_block_cols=geom.b_nbc)
    return {"dense": ex.unbatch(d)}


@dataclasses.dataclass(frozen=True)
class _Steps:
    """What a dense-output body asks its plan for at a ring step: B1's work
    table for a step's tile maps (None where the plain version runs) and a
    host tile map as an index tensor on the executor's device (cached)."""
    table: Optional[Callable[[np.ndarray, np.ndarray], SpmmTable]]
    device_map: Callable[[np.ndarray], torch.Tensor]


def _local_mm(a: Dict, b: Dict, a_map: np.ndarray, b_map: np.ndarray,
              steps: _Steps, c: Optional[torch.Tensor], geom: _Geom,
              ex: StackedExecutor) -> torch.Tensor:
    """Every output tile's local product of one step, in one batched call.

    Output tile p multiplies A tile ``a_map[p]`` by B tile ``b_map[p]`` of
    the placed stacks, read where they lie.  Step 0 (``c`` None) returns a
    fresh ``[g*g, tm, tn]`` C; later steps add into ``c`` in place, the
    step's product rounded to C's type first (the JAX body's ``c + ...``).
    """
    b_pool = ex.batch(b["dense"])    # the body pre-densifies sparse B
    if "dense" in a:
        a_pool = ex.batch(a["dense"])
        out = c if c is not None else torch.empty(
            (geom.g * geom.g, geom.tm, b_pool.shape[-1]),
            dtype=geom.out_dtype, device=ex.device)
        for p, (i, j) in enumerate(zip(a_map.tolist(), b_map.tolist())):
            # summed in float32, as the JAX package's preferred_element_type
            prod = torch.matmul(a_pool[i].float(), b_pool[j].float())
            if c is None:
                out[p] = prod
            else:
                out[p] += prod.to(geom.out_dtype)
        return out
    return kops.bsr_spmm_raw(
        ex.batch(a["blocks"]), ex.batch(a["rows"]), ex.batch(a["cols"]),
        b_pool, n_block_rows=geom.a_nbr, impl=geom.impl, a_map=a_map,
        b_map=b_map, table=steps.table and steps.table(a_map, b_map), out=c)


# ---------------------------------------------------------------------------
# Step maps: which placed tiles each output tile reads at each step
# ---------------------------------------------------------------------------
# A schedule's steps, as the stacked executor runs them: per step, one
# ``(a_map, b_map)`` pair per kernel launch (two for ring_c_bidir), where
# output tile p reads A tile ``a_map[p]`` and B tile ``b_map[p]`` of the
# placed stacks (host numpy, ``[g*g]``).  A ring ``ppermute`` composes a
# map (:meth:`StackedExecutor.shift_map`), a SUMMA broadcast or all-gather
# picks row k or column k: no tile moves.
def _ring_steps(a, b, geom: _Geom, shift: Callable, sign: int = 1):
    """The (A, B) of each stationary-C ring step, in order: tile grids
    shifted by ``shift = ex.shift`` (the sparse-output body), or tile maps
    composed by ``shift = ex.shift_map`` (the dense-output bodies, whose
    kernel reads the placed stacks in place).

    A rides the ``col`` ring and B the ``row`` ring, each position
    receiving from its ``+sign`` neighbour.  The bulk body issues step
    t+1's shift before step t's multiply (paper SS3.3 prefetch); the
    split-step body (``geom.overlap``) keeps one more step in flight,
    issuing step t+2's shift before step t's multiply.  On one stream that
    only reorders the launches and keeps one more copy of each operand
    alive, and at g = 2 the two bodies issue the same launches.  The JAX
    bodies also shift after the last step, whose tiles nothing consumes;
    here that shift would copy the whole operand on the card, so the port
    makes g - 1 shifts per operand.
    """
    ahead = 2 if geom.overlap else 1
    queue = [(a, b)]            # the tiles of steps t, t+1, ... in order
    for t in range(geom.g):
        while len(queue) <= ahead and t + len(queue) < geom.g:
            a_q, b_q = queue[-1]
            queue.append((shift(a_q, "col", sign), shift(b_q, "row", sign)))
        yield queue.pop(0)


def _ring_maps(geom: _Geom, ex: StackedExecutor, sign: int = 1):
    """The (A, B) tile maps of each stationary-C ring step: g - 1
    compositions per operand (:meth:`StackedExecutor.shift_map`), no tile
    moved."""
    ident = ex.identity_map()
    return _ring_steps(ident, ident, geom, ex.shift_map, sign)


def _steps_ring_c(geom: _Geom, ex: StackedExecutor) -> list:
    return [((a_map, b_map),) for a_map, b_map in _ring_maps(geom, ex)]


def _steps_ring_c_bidir(geom: _Geom, ex: StackedExecutor) -> list:
    """Left half-panel on the +1 rings, right half-panel on the -1 rings."""
    return list(zip(_ring_maps(geom, ex, +1), _ring_maps(geom, ex, -1)))


def _steps_summa(geom: _Geom, ex: StackedExecutor) -> list:
    """Inner step k: position (i, j) reads A tile (i, k) and B tile (k, j)
    of the natural placements (the broadcast, or the all-gather's slot
    k, of A[:, k] along rows and B[k, :] along columns)."""
    g = geom.g
    i, j = np.divmod(ex.identity_map(), g)
    return [((i * g + k, k * g + j),) for k in range(g)]


def _ring_a_walk(geom: _Geom, ex: StackedExecutor) -> list:
    """``ring_a``'s steps with the accumulators kept in place, as
    ``(at, b_pos)`` per step.

    The JAX body's partial C tile rides one hop along the col ring after
    every step.  Here accumulator q stays at index q: ``ride[p]`` is the
    accumulator that grid position p holds, composed one ``shift_map``
    per hop, and at step t accumulator q takes the product of position
    ``at[q]`` (``at`` the inverse of ``ride``): its stationary A tile and
    the B tile that position holds after t row-ring shifts (``b_pos``).
    The JAX body's g-th hop brings every accumulator back to the position
    it started from, so the reindexing it stands for is the identity.
    """
    ident = ex.identity_map()
    ride, b_pos, steps = ident, ident, []
    for t in range(geom.g):
        if t:
            b_pos = ex.shift_map(b_pos, "row")
            ride = ex.shift_map(ride, "col")      # the partial C's hop
        steps.append((np.argsort(ride), b_pos))
    return steps


def _steps_ring_a(geom: _Geom, ex: StackedExecutor) -> list:
    return [((at, b_pos[at]),) for at, b_pos in _ring_a_walk(geom, ex)]


def _split_cols(b_pool: torch.Tensor, half: int) -> Tuple[torch.Tensor, ...]:
    """B's column half-panels as two contiguous stacks (B1 reads a
    contiguous B); ``half`` may be 0 (a zero-width left panel)."""
    return (b_pool[..., :half].contiguous(), b_pool[..., half:].contiguous())


# ---------------------------------------------------------------------------
# Dense-output bodies
# ---------------------------------------------------------------------------
def _stationary_c(a: Dict, b: Dict, maps: list, steps: _Steps, geom: _Geom,
                  ex: StackedExecutor) -> torch.Tensor:
    """C stays put; step t's single launch reads the tiles ``maps[t]``
    names.  Step 0 writes C fresh and later steps add into it in place (the
    JAX body's ``c + ...`` in the same dtype and order, without a zero fill
    or a new buffer per step)."""
    b = _densify_b(b, geom, ex)
    c = None
    for (a_map, b_map), in maps:
        c = _local_mm(a, b, a_map, b_map, steps, c, geom, ex)
    return ex.unbatch(c)


def _body_summa_bcast(a: Dict, b: Dict, steps: _Steps, geom: _Geom,
                      ex: StackedExecutor) -> torch.Tensor:
    """Bulk-synchronous SUMMA (paper SS2.2): a broadcast per inner step.

    On the stacked executor the broadcast of A[:, k] along rows and B[k, :]
    along columns is a tile map (:func:`_steps_summa`): no operand moves.
    Every position sums k = 0 .. g-1 in order, as the JAX scan does.
    """
    return _stationary_c(a, b, _steps_summa(geom, ex), steps, geom, ex)


def _body_summa_ag(a: Dict, b: Dict, steps: _Steps, geom: _Geom,
                   ex: StackedExecutor) -> torch.Tensor:
    """All-gather SUMMA: one up-front collective, g x the tile footprint.

    On one card the all-gather's slot k is the broadcast's step k, so this
    is ``summa_bcast``'s body (the same tile maps and launches); the stack
    is not copied to imitate the gather.  The two schedules differ in the
    cost model (``wire_amortized``) and in the g x footprint of the real
    collective on a grid of cards.
    """
    return _body_summa_bcast(a, b, steps, geom, ex)


def _body_ring_c(a: Dict, b: Dict, steps: _Steps, geom: _Geom,
                 ex: StackedExecutor) -> torch.Tensor:
    """Paper Alg 2 (stationary-C): skewed placement + neighbour ring shifts,
    composed as tile maps (no ``torch.roll``)."""
    return _stationary_c(a, b, _steps_ring_c(geom, ex), steps, geom, ex)


def _body_ring_a(a: Dict, b: Dict, steps: _Steps, geom: _Geom,
                 ex: StackedExecutor) -> torch.Tensor:
    """Paper Alg 1 (stationary-A): B rides the row ring, partial C rides
    the col ring back to its owner.

    Nothing moves on the card: A is read in place, B through its composed
    maps, and each accumulator stays where it was made, taking at every
    step the product of the position that holds it then
    (:func:`_ring_a_walk`), in the JAX order.  After the last hop every
    accumulator is home, and the epilogue unskews C's rows.
    """
    b = _densify_b(b, geom, ex)
    c = None
    for (a_map, b_map), in _steps_ring_a(geom, ex):
        c = _local_mm(a, b, a_map, b_map, steps, c, geom, ex)
    return ex.unbatch(c)


def _body_ring_c_bidir(a: Dict, b: Dict, steps: _Steps, geom: _Geom,
                       ex: StackedExecutor) -> torch.Tensor:
    """Bidirectional stationary-C ring: C split into column half-panels.

    The left half-panel (width ``tn // 2``) takes the full A tile and the
    left half of the dense B tile around the +1 rings (``k = i+j+t``), the
    right half-panel theirs around the -1 rings (``k = i+j-t``), both from
    ``ring_c``'s skewed placement: two launches a step.  B is split into
    two contiguous half stacks once per multiply (the JAX body slices it
    too) and C is concatenated once at the end.
    """
    b = _densify_b(b, geom, ex)
    halves = _split_cols(ex.batch(b["dense"]), geom.tn // 2)
    c = [None, None]
    for launches in _steps_ring_c_bidir(geom, ex):
        for h, (a_map, b_map) in enumerate(launches):
            c[h] = _local_mm(a, {"dense": ex.unbatch(halves[h])}, a_map,
                             b_map, steps, c[h], geom, ex)
    return ex.unbatch(torch.cat(c, dim=2))


# ---------------------------------------------------------------------------
# Sparse-output bodies (plan_matmul(output="sparse"))
# ---------------------------------------------------------------------------
# The numeric phase of symbolic/numeric SpGEMM: both operands stay in their
# stored (or packed) block form, only ``blocks`` moves (the pair lists
# encode all structure), and each step accumulates matched block products
# into the packed output slots the symbolic phase allocated.  No dense C
# tile and no densified B ever exist.
def _sparse_step(a_t: Dict, b_t: Dict, pairs: Dict,
                 c: Optional[torch.Tensor], geom: _Geom,
                 ex: StackedExecutor) -> torch.Tensor:
    """Every tile's pair products of one step, in one batched launch: a
    fresh float32 carry ([g*g, c_store, bs, bs]) when ``c`` is None, else
    added into ``c`` in place, each slot once (the JAX bodies' ``c +
    step`` without a step buffer).  Returns the carry."""
    return kops.bsr_pair_accumulate(
        ex.batch(a_t["blocks"]), ex.batch(b_t["blocks"]), pairs["pa"],
        pairs["pb"], pairs["ps"], n_slots=geom.c_store,
        out_dtype=torch.float32, impl=geom.impl, table=pairs.get("table"),
        acc=c)


def _sparse_body_ring_c(a: Dict, b: Dict, pairs, geom: _Geom,
                        ex: StackedExecutor) -> torch.Tensor:
    """Stationary-C ring with packed sparse output.

    Same placement and shifts as ``ring_c``; B rides the ring in block form
    (its densified tile never exists).  ``pairs[t]`` holds step t's
    ``[g*g, P]`` pair lists: on grid position (i, j) they index the tiles
    that position holds after t shifts, A[i, k] and B[k, j] with
    ``k = (i + j + t) % g``.  The carry is float32, written fresh by step 0
    (every slot once: its real sums, zeros where no real pair lands, so no
    zero fill of the whole store first), added into from step 1 on, and
    cast to the output dtype once at the end.
    """
    c = None
    for t, (a_t, b_t) in enumerate(_ring_steps(a, b, geom, ex.shift)):
        c = _sparse_step(a_t, b_t, pairs[t], c, geom, ex)
    return ex.unbatch(c.to(geom.out_dtype))


def _sparse_body_summa(a: Dict, b: Dict, pairs, geom: _Geom,
                       ex: StackedExecutor) -> torch.Tensor:
    """SUMMA (broadcast or all-gather) with packed sparse output.

    ``pairs[t]`` holds inner step t's ``[g*g, P]`` pair lists, which on
    position (i, j) index A[i, t] and B[t, j]; B2 reads each output tile's
    own A and B tile, so each step hands it those tile grids, gathered with
    ``index_select`` from the natural stacks (as the ``ring_c`` body hands
    it rolled grids).  The float32 carry is written fresh at step 0, added
    into after that, and cast once.
    """
    a_pool, b_pool = ex.batch(a["blocks"]), ex.batch(b["blocks"])
    take = lambda pool, tile_map: {"blocks": ex.unbatch(pool.index_select(
        0, torch.as_tensor(tile_map, device=ex.device)))}
    c = None
    for t, ((a_map, b_map),) in enumerate(_steps_summa(geom, ex)):
        c = _sparse_step(take(a_pool, a_map), take(b_pool, b_map), pairs[t],
                         c, geom, ex)
    return ex.unbatch(c.to(geom.out_dtype))


# ---------------------------------------------------------------------------
# Packed-wire dense-output bodies (plan_matmul(wire="packed"))
# ---------------------------------------------------------------------------
# A sparse A tile rides as a packed [wire_capacity, bs, bs] buffer (real
# blocks only, no rows/cols) and a sparse B tile likewise, densified per
# step by a gather; all structure lives in plan-time consume maps
# (core/wire.py), step t's maps in ``aux[t]`` as [g*g, ...] tensors.  As
# on the padded wire each step's tiles are read through tile maps over the
# placed packed stacks.
def _packed_a_mm(a_blocks: torch.Tensor, aux_t: Dict, a_map: np.ndarray,
                 b_map: np.ndarray, b_pool: torch.Tensor, steps: _Steps,
                 c: Optional[torch.Tensor], geom: _Geom, ex: StackedExecutor,
                 stream: str = "") -> torch.Tensor:
    """One packed local SpMM step: output tile p reads packed A tile
    ``a_map[p]`` in place, through its consume lists (``stream`` names
    ring_c_bidir's backward lists; the kernel reads through its table's
    pool slots, so no gather copy of A is made)."""
    return kops.bsr_spmm_raw(
        ex.batch(a_blocks), aux_t["a_rows" + stream],
        aux_t["a_cols" + stream], b_pool, n_block_rows=geom.a_nbr,
        impl=geom.impl, a_map=a_map, b_map=b_map,
        gidx=aux_t["a_gidx" + stream],
        table=steps.table and steps.table(a_map, b_map), out=c)


def _packed_b_dense(b_buf: torch.Tensor, dmap: torch.Tensor,
                    b_map: np.ndarray, steps: _Steps, geom: _Geom,
                    ex: StackedExecutor) -> torch.Tensor:
    """Each position's dense B tile of one step, gathered from packed B
    tile ``b_map[p]`` of the placed stack."""
    return kops.densify_packed(ex.batch(b_buf), dmap,
                               n_block_rows=geom.b_nbr,
                               n_block_cols=geom.b_nbc,
                               tile_map=steps.device_map(b_map))


def _packed_stationary_c(a: Dict, b: Dict, aux, maps: list, steps: _Steps,
                         geom: _Geom, ex: StackedExecutor) -> torch.Tensor:
    """:func:`_stationary_c` over packed wire buffers: A packed, B packed
    (densified per step by a gather) or densified once."""
    b_packed = "b_dmap" in aux[0]
    b0 = b if b_packed else _densify_b(b, geom, ex)
    ident = ex.identity_map()
    c = None
    for t, ((a_map, b_map),) in enumerate(maps):
        if b_packed:
            b_pool = _packed_b_dense(b0["blocks"], aux[t]["b_dmap"], b_map,
                                     steps, geom, ex)
            b_map = ident                  # one dense tile per position
        else:
            b_pool = ex.batch(b0["dense"])
        c = _packed_a_mm(a["blocks"], aux[t], a_map, b_map, b_pool, steps, c,
                         geom, ex)
    return ex.unbatch(c)


def _packed_body_summa(a: Dict, b: Dict, aux, steps: _Steps, geom: _Geom,
                       ex: StackedExecutor) -> torch.Tensor:
    """SUMMA (broadcast or all-gather) over packed wire buffers."""
    return _packed_stationary_c(a, b, aux, _steps_summa(geom, ex), steps,
                                geom, ex)


def _packed_body_ring_c(a: Dict, b: Dict, aux, steps: _Steps, geom: _Geom,
                        ex: StackedExecutor) -> torch.Tensor:
    """Stationary-C ring over packed wire buffers (paper Alg 2)."""
    return _packed_stationary_c(a, b, aux, _steps_ring_c(geom, ex), steps,
                                geom, ex)


def _packed_body_ring_a(a: Dict, b: Dict, aux, steps: _Steps, geom: _Geom,
                        ex: StackedExecutor) -> torch.Tensor:
    """Stationary-A ring with the sparse B packed: each step gathers every
    position's dense B tile from the packed stack it holds then, and each
    accumulator reads the one of its position (:func:`_body_ring_a`)."""
    c = None
    for t, (at, b_pos) in enumerate(_ring_a_walk(geom, ex)):
        b_pool = _packed_b_dense(b["blocks"], aux[t]["b_dmap"], b_pos, steps,
                                 geom, ex)
        c = _local_mm(a, {"dense": ex.unbatch(b_pool)}, at, at, steps, c,
                      geom, ex)
    return ex.unbatch(c)


def _packed_body_ring_c_bidir(a: Dict, b: Dict, aux, steps: _Steps,
                              geom: _Geom,
                              ex: StackedExecutor) -> torch.Tensor:
    """Bidirectional stationary-C ring, A packed in both directions.

    B's column half-panels need not be block-aligned, so B rides densified
    as in the padded body; only the A streams pack.
    """
    b = _densify_b(b, geom, ex)
    halves = _split_cols(ex.batch(b["dense"]), geom.tn // 2)
    c = [None, None]
    for t, launches in enumerate(_steps_ring_c_bidir(geom, ex)):
        for h, (a_map, b_map) in enumerate(launches):
            c[h] = _packed_a_mm(a["blocks"], aux[t], a_map, b_map, halves[h],
                                steps, c[h], geom, ex,
                                stream=("", "_bwd")[h])
    return ex.unbatch(torch.cat(c, dim=2))


# ---- per-schedule wire planners (consume-map construction) ----------------
def _wire_consume(aux: Dict, prefix: str, po: "_wire.PackedOperand",
                  tiles: np.ndarray, suffix: str = "") -> None:
    cons = _wire.schedule_consume(po, tiles)
    for k in ("gidx", "rows", "cols"):
        aux[f"{prefix}_{k}{suffix}"] = cons[k]


def _wire_planner_ring_c(a_po, b_po, geom: _Geom) -> Dict[str, np.ndarray]:
    """Consume maps of the packed ``ring_c`` body, ``[g, g, t, ...]``."""
    aux: Dict[str, np.ndarray] = {}
    if a_po is not None:
        _wire_consume(aux, "a", a_po, _wire.tiles_ring_c(geom.g))
    if b_po is not None:
        aux["b_dmap"] = _wire.schedule_dense_map(
            b_po, _wire.tiles_ring_c_b(geom.g))
    return aux


def _wire_planner_ring_c_bidir(a_po, b_po, geom: _Geom
                               ) -> Dict[str, np.ndarray]:
    aux: Dict[str, np.ndarray] = {}
    _wire_consume(aux, "a", a_po, _wire.tiles_ring_c(geom.g))
    _wire_consume(aux, "a", a_po, _wire.tiles_ring_c_bwd(geom.g), "_bwd")
    return aux


def _wire_planner_ring_a(a_po, b_po, geom: _Geom) -> Dict[str, np.ndarray]:
    return {"b_dmap": _wire.schedule_dense_map(
        b_po, _wire.tiles_ring_a_b(geom.g))}


def _summa_bases(g: int, wc: int) -> np.ndarray:
    """Flat base offset of inner step k's tile in an all-gathered pool."""
    return np.broadcast_to(np.arange(g, dtype=np.int64) * wc, (g, g, g))


def _wire_planner_summa_bcast(a_po, b_po, geom: _Geom
                              ) -> Dict[str, np.ndarray]:
    """Consume maps of the packed SUMMA bodies: A[i, k] and B[k, j] at
    inner step k, each read where it lies (the broadcast tile on a rank;
    the placed packed stack through the step's tile maps on the stacked
    executor, which serves ``summa_ag`` too)."""
    g = geom.g
    aux: Dict[str, np.ndarray] = {}
    if a_po is not None:
        _wire_consume(aux, "a", a_po, _wire.tiles_summa_a(g))
    if b_po is not None:
        aux["b_dmap"] = _wire.schedule_dense_map(b_po, _wire.tiles_summa_b(g))
    return aux


def _wire_planner_summa_ag(a_po, b_po, geom: _Geom) -> Dict[str, np.ndarray]:
    """Consume maps of the packed all-gather SUMMA on a process grid: the
    broadcast planner's plus ``k * wire_capacity`` (:func:`_summa_bases`),
    so inner step k's lists index the rank's gathered pool as one flat
    buffer (the JAX package's planner)."""
    g = geom.g
    aux: Dict[str, np.ndarray] = {}
    if a_po is not None:
        cons = _wire.schedule_consume(a_po, _wire.tiles_summa_a(g),
                                      _summa_bases(g, a_po.wire_capacity))
        for k in ("gidx", "rows", "cols"):
            aux[f"a_{k}"] = cons[k]
    if b_po is not None:
        aux["b_dmap"] = _wire.schedule_dense_map(
            b_po, _wire.tiles_summa_b(g),
            _summa_bases(g, b_po.wire_capacity))
    return aux


# ---------------------------------------------------------------------------
# steal3d: static 3D work-grid dispatch from the stealing equilibrium
# ---------------------------------------------------------------------------
def _steal_plan_for(a_h: "DistMatrix", b_h: "DistMatrix", geom: _Geom,
                    wire: str = "padded",
                    assignment=None) -> "_steal3d.StealPlan":
    """Memoised steal3d planner (LPT assignment + pair lists + rounds).

    ``auto_select`` scoring shares this cache with plan construction: the
    one full build per operand structure (and wire mode) also serves the
    cost entry, and is reused outright if steal3d wins.  An injected
    ``assignment`` bypasses the memo both ways: the plan is built fresh
    against it (``build_steal_plan`` runs its fail-fast checks) and never
    enters the cache.
    """
    skey = a_h.structure_key() if isinstance(a_h, DistBSR) else None
    if not (wire == "packed" and isinstance(a_h, DistBSR)):
        wire = "padded"      # dense A has no packable steal3d traffic
    if assignment is not None:
        with _obs.span("plan_build.steal", wire=wire, injected=True):
            return _steal3d.build_steal_plan(a_h, b_h, geom, wire=wire,
                                             overlap=geom.overlap,
                                             assignment=assignment)
    key = (a_h.abstract_key(), b_h.abstract_key(), skey, wire, geom.overlap)
    sp = _STEAL_CACHE.get(key)
    if sp is None:
        with _obs.span("plan_build.steal", wire=wire):
            sp = _steal3d.build_steal_plan(a_h, b_h, geom, wire=wire,
                                           overlap=geom.overlap)
        _STEAL_CACHE[key] = sp
    return sp


def _steal3d_cost(alg: "Algorithm", geom: _Geom, a_h: "DistMatrix",
                  b_h: "DistMatrix", wire: str = "padded"
                  ) -> Dict[str, float]:
    """``auto_select``'s cost entry: the simulated equilibrium as a score.

    The flop term is the realized LPT makespan (the pair capacity: block
    products on the most-loaded device, padding included), the byte term
    the panel gathers, moved tiles and owner reductions, packed to real
    blocks under ``wire="packed"``.
    """
    return dict(_steal_plan_for(a_h, b_h, geom, wire=wire).cost)


@dataclasses.dataclass(frozen=True)
class _StealDevice:
    """A steal3d plan as the stacked executor runs it: index maps into the
    placed stacks in place of the JAX body's collectives.

    ``segments`` holds one entry per B1 launch (two with ``overlap``: the
    own items, then the stolen ones): the ``[g*g, P]`` pair lists with the
    A entry a slot of the placed A stack (or of the packed buffers), the
    zero block a dummy slot, the B entry a bs-row chunk of the placed B
    stack as one flat tile (B tile * tk/bs + chunk), and the output slot;
    ``real`` (host numpy) leaves out the dummy and coverage pairs, and
    ``table`` is B1's table of them where the kernel runs.  Dense A: the A
    and B entries are placed tile indices.  ``rounds`` are the reduce
    rounds in the JAX order (row deltas, then column deltas): per round
    the flat accumulator each owner adds (padded), or the accumulator rows
    each owner adds and the own rows they land on (packed).
    """
    sparse_a: bool
    packed: bool
    n_out: int
    n_slots: int
    segments: Tuple[Dict, ...]
    rounds: Tuple[Tuple[torch.Tensor, ...], ...]

    @property
    def real_pairs(self) -> int:
        """Pair products B1 multiplies in one multiply (sparse A)."""
        return int(sum(int(s["real"].sum()) for s in self.segments))


def _steal_pool_tiles(splan: "_steal3d.StealPlan", g: int):
    """Per device (``[g*g, ...]``, device d = (r, c)), the placed tile of
    every A and B pool tile of the JAX body: A's row panel A[r, k] and the
    A tiles of each move round (what the source ``delta`` hops up the grid
    column gathers with ``amk<delta>``), then B's column panel B[k, c] and
    the B tiles of each move round (``bmk<delta>``)."""
    r, c = np.divmod(np.arange(g * g), g)
    aux = splan.aux
    a_tiles = [r[:, None] * g + np.arange(g)]
    for delta in splan.a_deltas:
        src_r = (r - delta) % g
        a_tiles.append(src_r[:, None] * g + aux[f"amk{delta}"][src_r, c])
    b_tiles = [np.arange(g)[None, :] * g + c[:, None]]
    for delta in splan.b_deltas:
        src_c = (c - delta) % g
        b_tiles.append(aux[f"bmk{delta}"][r, src_c] * g + src_c[:, None])
    return (np.concatenate(a_tiles, axis=1).astype(np.int64),
            np.concatenate(b_tiles, axis=1).astype(np.int64))


def _steal_device(splan: "_steal3d.StealPlan", a_h: "DistMatrix",
                  geom: _Geom, device: torch.device,
                  kernel: bool) -> _StealDevice:
    """Translate a StealPlan's pool-relative lists and rounds into index
    maps over the placed stacks (host numpy, once per plan)."""
    g, n_dev = geom.g, geom.g * geom.g
    aux = splan.aux
    sparse = splan.a_kind == "bsr"
    packed = splan.wire == "packed"
    a_tiles, b_tiles = _steal_pool_tiles(splan, g)
    if not sparse:
        a_flat, stride, zero = a_tiles, 1, 0
    elif packed:
        stride = splan.a_wire_capacity
        parts, off = [a_tiles[:, :g, None] * stride + np.arange(stride)], g
        for cap, rcap in zip(splan.a_move_cap, splan.a_round_cap):
            parts.append(a_tiles[:, off:off + cap, None] * stride
                         + np.arange(rcap))
            off += cap
        a_flat = np.concatenate([p.reshape(n_dev, -1) for p in parts], 1)
        zero = stride - 1            # tile 0's guaranteed-zero packed slot
    else:
        stride = splan.store_a
        a_flat = (a_tiles[:, :, None] * stride
                  + np.arange(stride)).reshape(n_dev, -1)
        zero = int(a_h.grid_structure().zero_slot[0, 0])
    # (lists, the pool index of the segment's zero block)
    names = (("pa0", "pb0", "ps0", g * stride),
             ("pa1", "pb1", "ps1", a_flat.shape[1])) if splan.overlap \
        else (("pa", "pb", "ps", a_flat.shape[1]),)
    segments = []
    for ka, kb, ks, z in names:
        pa, pb, ps = (aux[k].reshape(n_dev, -1).astype(np.int64)
                      for k in (ka, kb, ks))
        real = pa != z
        at = np.take_along_axis(a_flat, np.minimum(pa, a_flat.shape[1] - 1),
                                axis=1)
        pa_g = np.where(real, at, zero)
        if sparse:
            pos, chunk = np.divmod(pb, splan.b_chunks)
            pb_g = np.take_along_axis(b_tiles, pos, axis=1) * splan.b_chunks \
                + chunk
        else:
            pb_g = np.take_along_axis(b_tiles, pb, axis=1)
        as_dev = lambda x: torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.int32)).to(device)
        seg = {"pa": as_dev(pa_g), "pb": as_dev(pb_g), "ps": as_dev(ps),
               "real": real}
        if not sparse:
            seg["real_t"] = torch.from_numpy(real).to(device)
        elif kernel:
            seg["table"] = _spmm_table(pa_g, ps, pb_g, splan.n_slots,
                                       real=real,
                                       b_map=np.zeros(n_dev, np.int64),
                                       device=device)
        segments.append(seg)
    r, c = np.divmod(np.arange(n_dev), g)
    rounds = []
    for pre, deltas in (("r", splan.row_deltas), ("c", splan.col_deltas)):
        for delta in deltas:
            # the owner (r, c) receives from (r, c - delta) along its grid
            # row (row deltas) or from (r - delta, c) along its column
            src_r, src_c = (r, (c - delta) % g) if pre == "r" \
                else ((r - delta) % g, c)
            acc = (src_r * g + src_c) * splan.n_out \
                + aux[f"{pre}send{delta}"][src_r, src_c]
            if not packed:
                rounds.append((torch.from_numpy(acc).to(device),))
                continue
            # packed: the sender's listed block-rows land on the owner's
            # target rows; padding (target nbr, the JAX dummy row) dropped
            nbr = geom.a_nbr
            rows = acc[:, None] * nbr + aux[f"{pre}row{delta}"][src_r, src_c]
            tgt = aux[f"{pre}tgt{delta}"][r, c]
            keep = tgt != nbr
            dev_idx = np.broadcast_to(np.arange(n_dev)[:, None], tgt.shape)
            rounds.append(tuple(torch.from_numpy(np.ascontiguousarray(
                x[keep], dtype=np.int64)).to(device)
                for x in (rows, dev_idx, tgt)))
    return _StealDevice(sparse_a=sparse, packed=packed, n_out=splan.n_out,
                        n_slots=splan.n_slots, segments=tuple(segments),
                        rounds=tuple(rounds))


def _body_steal3d(a: Dict, b: Dict, st: _StealDevice, geom: _Geom,
                  ex: StackedExecutor) -> torch.Tensor:
    """Static realisation of the paper's SS3.4 locality-aware work stealing.

    Runs the plan-time LPT assignment of (i, k, j) items.  On a grid of
    devices each device gathers its A grid-row panel and B grid-column
    panel, receives the moved tiles of its off-owner items, accumulates
    its pair list and ships partial C tiles home.  On one card no tile
    moves: the pools and the move rounds are index maps into the placed
    stacks (:class:`_StealDevice`), so one B1 launch
    (``ops.steal_pair_accumulate``, output tile = device) computes every
    device's ``n_out`` partial tiles, reading A and B where they lie (two
    launches with ``overlap``, own items then stolen ones, the second
    added into the first).  The reduce rounds then add the partials into
    the owners in the JAX order: own tile, row deltas, column deltas (on
    the packed wire only the block-rows each sender's items can touch).
    Dense A takes the JAX package's einsum path as a plain PyTorch
    product.
    """
    c = _steal3d_partials(a, _densify_b(b, geom, ex)["dense"], st, geom,
                          ex)
    return ex.unbatch(_steal3d_reduce(c, st, geom).to(geom.out_dtype))


def _steal3d_partials(a: Dict, b_pool: torch.Tensor, st: _StealDevice,
                      geom: _Geom, ex: StackedExecutor) -> torch.Tensor:
    """Every device's ``n_out`` partial C tiles (``[g*g, n_out * tm,
    tn]``): B1 over the pair lists (sparse A), one launch a segment, the
    second added into the first; dense A as the JAX einsum."""
    if not st.sparse_a:
        return _steal3d_dense_partials(a, b_pool, st, geom, ex)
    blocks, c = a["blocks"], None
    for seg in st.segments:
        c = kops.steal_pair_accumulate(
            blocks.reshape(-1, *blocks.shape[-2:]),
            b_pool.reshape(-1, geom.tn), seg["pa"], seg["pb"], seg["ps"],
            n_slots=st.n_slots, impl=geom.impl, table=seg.get("table"),
            out=c)
    return c


def _steal3d_reduce(c: torch.Tensor, st: _StealDevice,
                    geom: _Geom) -> torch.Tensor:
    """The reduce rounds: each owner's own partial tile (``[g*g, tm, tn]``,
    a view of ``c``) plus the partials the rounds bring it, in the JAX
    order; on the packed wire only the listed block-rows."""
    n_dev, tm, tn = geom.g * geom.g, geom.tm, geom.tn
    c = c.view(n_dev, st.n_out, tm, tn)
    own = c[:, 0]
    if st.packed:
        nbr = geom.a_nbr
        rows = c.view(-1, tm // nbr, tn)
        own_rows = own.view(n_dev, nbr, tm // nbr, tn)
        for src, dev_idx, tgt in st.rounds:
            own_rows.index_put_((dev_idx, tgt), own_rows[dev_idx, tgt]
                                + rows.index_select(0, src))
    else:
        flat = c.view(-1, tm, tn)
        for (src,) in st.rounds:
            own.add_(flat.index_select(0, src))
    return own


def _steal3d_dense_partials(a: Dict, b_pool: torch.Tensor,
                            st: _StealDevice, geom: _Geom,
                            ex: StackedExecutor) -> torch.Tensor:
    """Dense A: every device's partial tiles as the JAX einsum computes
    them, float32 products of placed tiles summed by output slot (the
    padding pairs on the zero tile included)."""
    n_dev, tm, tn = geom.g * geom.g, geom.tm, geom.tn
    a_t, b_t = ex.batch(a["dense"]), ex.batch(b_pool)
    dev = torch.arange(n_dev, device=ex.device)[:, None]
    c = torch.zeros((n_dev, st.n_out * tm, tn), dtype=torch.float32,
                    device=ex.device)
    for seg in st.segments:
        a_sel = a_t[seg["pa"].long()]
        a_sel = torch.where(seg["real_t"][..., None, None], a_sel,
                            torch.zeros((), dtype=a_sel.dtype,
                                        device=ex.device))
        prods = torch.matmul(a_sel.float(), b_t[seg["pb"].long()].float())
        c.view(-1, tm, tn).index_add_(
            0, (dev * st.n_out + seg["ps"].long()).reshape(-1),
            prods.reshape(-1, tm, tn))
    return c


# ---------------------------------------------------------------------------
# Bodies on a process grid: one tile per rank (GroupExecutor)
# ---------------------------------------------------------------------------
# The JAX bodies as written, step by step, on the rank's own tiles: a ring
# shift is a point-to-point exchange, a SUMMA broadcast a broadcast and an
# all-gather an all-gather (``GroupExecutor``).  Each local multiply is one
# launch over the rank's pool (its one tile, or the g tiles a summa_ag rank
# gathers); which placed tile the rank holds at each step comes from the
# stacked executor's host maps (``Algorithm.step_maps``), from which the plan
# cuts B1's table.
def _tree_ppermute(ex: GroupExecutor, tree: Dict, axis: str, sign: int = 1,
                   wait: bool = True):
    """The JAX bodies' ``_tree_ppermute``: position d receives the tree of
    position ``(d + sign) % g`` along ``axis``."""
    return ex.shift(tree, axis, sign, wait=wait)


def _tree_bcast(ex: GroupExecutor, tree: Dict, axis: str, root: int,
                wait: bool = True):
    """The JAX bodies' ``_tree_bcast``: position ``root``'s tree to every
    position along ``axis``."""
    return ex.bcast(tree, axis, root, wait=wait)


def _local_view(tree: Dict) -> Dict:
    """The rank's tile tree as a one-tile pool (``[1, ...]`` leaves): the
    counterpart of the JAX package's view of a shard inside
    ``shard_map``."""
    return {k: v[None] for k, v in tree.items()}


def _ring_stream(ex: GroupExecutor, tree: Dict, axis: str, geom: _Geom,
                 sign: int = 1):
    """The tree a rank holds at each of a ring's g steps: g - 1 shifts (the
    port's count, see :func:`_ring_steps`), each issued before the local
    multiply of the step before its use (the bulk body, paper SS3.3
    prefetch), or two steps before it (``geom.overlap``, the split-step
    body), and waited for only where it is used."""
    ahead = 2 if geom.overlap else 1
    queue = [_Ready(tree)]
    for t in range(geom.g):
        while len(queue) <= ahead and t + len(queue) < geom.g:
            queue.append(_tree_ppermute(ex, queue[-1].result(), axis, sign,
                                        wait=False))
        yield queue.pop(0).result()


def _bcast_stream(ex: GroupExecutor, tree: Dict, axis: str, geom: _Geom):
    """Inner step k's tree: position k's along ``axis``; the split-step
    body (``geom.overlap``) issues step k + 1's broadcast before step k's
    multiply."""
    ahead = 1 if geom.overlap else 0
    pending = []
    for k in range(geom.g):
        while len(pending) <= ahead and k + len(pending) < geom.g:
            pending.append(_tree_bcast(ex, tree, axis, k + len(pending),
                                       wait=False))
        yield pending.pop(0).result()


@dataclasses.dataclass(frozen=True)
class _RankSteps:
    """What a dense-output rank body asks its plan for: the schedule's step
    maps (which placed tile each grid position holds at each step) and
    B1's table of a launch over a local pool of placed tiles ``held``
    reading pool tile ``k`` (None where the plain version runs)."""
    maps: list
    table: Optional[Callable[[Tuple[int, ...], int], SpmmTable]]


def _rank_mm(pool: Dict, b_dense: torch.Tensor, held: Tuple[int, ...],
             k: int, steps: _RankSteps, c: Optional[torch.Tensor],
             geom: _Geom) -> torch.Tensor:
    """``c`` (+)= pool tile ``k`` of A (``[n, ...]`` leaves: the placed
    tiles ``held``) @ ``b_dense`` ``[K, n]``, as :func:`_local_mm` computes
    one position's product; ``c`` is ``[1, tm, n]``, fresh when None."""
    if "dense" in pool:
        prod = torch.matmul(pool["dense"][k].float(),
                            b_dense.float()).to(geom.out_dtype)[None]
        return prod if c is None else c.add_(prod)
    return kops.bsr_spmm_raw(
        pool["blocks"], pool["rows"], pool["cols"], b_dense[None],
        n_block_rows=geom.a_nbr, impl=geom.impl, a_map=[k], b_map=[0],
        table=steps.table and steps.table(held, k), out=c)


def _rank_packed_mm(a_pool: torch.Tensor, aux_t: Dict, held: Tuple[int, ...],
                    k: int, b_dense: torch.Tensor, steps: _RankSteps,
                    c: Optional[torch.Tensor], geom: _Geom,
                    stream: str = "") -> torch.Tensor:
    """One packed local SpMM: the consume lists of ``aux_t`` (the rank's
    row) read the packed pool ``[n, wc, bs, bs]`` as one flat buffer (the
    summa_ag planner's lists carry its ``k * wc`` bases)."""
    blocks = a_pool.reshape(1, -1, *a_pool.shape[-2:])
    return kops.bsr_spmm_raw(
        blocks, aux_t["a_rows" + stream], aux_t["a_cols" + stream],
        b_dense[None], n_block_rows=geom.a_nbr, impl=geom.impl, a_map=[0],
        b_map=[0], gidx=aux_t["a_gidx" + stream],
        table=steps.table and steps.table(held, k), out=c)


def _rank_packed_b(b_pool: torch.Tensor, dmap: torch.Tensor,
                   geom: _Geom) -> torch.Tensor:
    """The dense B tile a rank gathers from its packed pool (one flat
    buffer; ``dmap`` is its row of the plan's maps)."""
    return kops.densify_packed(b_pool.reshape(1, -1, *b_pool.shape[-2:]),
                               dmap, n_block_rows=geom.b_nbr,
                               n_block_cols=geom.b_nbc)[0]


def _held(maps: list, p: int, launch: int = 0) -> list:
    """The placed A tile position ``p`` reads at each step."""
    return [int(step[launch][0][p]) for step in maps]


def _rank_body_ring_c(a: Dict, b: Dict, steps: _RankSteps, geom: _Geom,
                      ex: GroupExecutor) -> torch.Tensor:
    """Paper Alg 2 (stationary-C) on a rank: A rides the col ring and B the
    row ring from the skewed placement; C stays."""
    b = _densify_b(b, geom, ex)
    c = None
    for held, a_t, b_t in zip(_held(steps.maps, ex.position),
                              _ring_stream(ex, a, "col", geom),
                              _ring_stream(ex, b, "row", geom)):
        c = _rank_mm(_local_view(a_t), b_t["dense"], (held,), 0, steps, c,
                     geom)
    return ex.unbatch(c)


def _rank_body_ring_c_bidir(a: Dict, b: Dict, steps: _RankSteps,
                            geom: _Geom, ex: GroupExecutor) -> torch.Tensor:
    """Bidirectional stationary-C ring on a rank: the left half-panel's A
    and B ride the +1 rings, the right one's the -1 rings (four streams;
    at g = 2 both directions meet the same neighbour, their messages
    told apart by tag and order)."""
    b = _densify_b(b, geom, ex)["dense"]
    half = geom.tn // 2
    halves = ({"dense": b[:, :half].contiguous()},
              {"dense": b[:, half:].contiguous()})
    c = [None, None]
    p = ex.position
    for t, (a_f, a_b, b_f, b_b) in enumerate(zip(
            _ring_stream(ex, a, "col", geom, +1),
            _ring_stream(ex, a, "col", geom, -1),
            _ring_stream(ex, halves[0], "row", geom, +1),
            _ring_stream(ex, halves[1], "row", geom, -1))):
        for h, (a_t, b_t) in enumerate(((a_f, b_f), (a_b, b_b))):
            held = int(steps.maps[t][h][0][p])
            c[h] = _rank_mm(_local_view(a_t), b_t["dense"], (held,), 0,
                            steps, c[h], geom)
    return ex.unbatch(torch.cat(c, dim=2))


def _rank_body_ring_a(a: Dict, b: Dict, steps: _RankSteps, geom: _Geom,
                      ex: GroupExecutor) -> torch.Tensor:
    """Paper Alg 1 (stationary-A) on a rank: B rides the row ring (split
    step with ``geom.overlap``), the partial C hops one place along the col
    ring after every step, g hops in all, the last one home."""
    b = _densify_b(b, geom, ex)
    a_pool, p = _local_view(a), ex.position
    acc = None
    for b_t in _ring_stream(ex, b, "row", geom):
        acc = _rank_mm(a_pool, b_t["dense"], (p,), 0, steps, acc, geom)
        acc = _tree_ppermute(ex, {"c": acc}, "col")["c"]
    return ex.unbatch(acc)


def _rank_body_summa_bcast(a: Dict, b: Dict, steps: _RankSteps,
                           geom: _Geom, ex: GroupExecutor) -> torch.Tensor:
    """Bulk-synchronous SUMMA on a rank: inner step k broadcasts A[i, k]
    along the grid row and B[k, j] along the grid column; one tile of
    each is held at a time."""
    b = _densify_b(b, geom, ex)
    c = None
    for k, (a_k, b_k) in enumerate(zip(_bcast_stream(ex, a, "col", geom),
                                       _bcast_stream(ex, b, "row", geom))):
        c = _rank_mm(_local_view(a_k), b_k["dense"], (ex.i * geom.g + k,),
                     0, steps, c, geom)
    return ex.unbatch(c)


def _rank_body_summa_ag(a: Dict, b: Dict, steps: _RankSteps, geom: _Geom,
                        ex: GroupExecutor) -> torch.Tensor:
    """All-gather SUMMA on a rank: one all-gather of the A row panel and
    the B column panel up front; the rank then holds the g-tile pools
    and inner step k's launch reads pool tile k in place."""
    b = _densify_b(b, geom, ex)
    a_g = ex.all_gather(a, "col")
    b_g = ex.all_gather(b, "row")["dense"]
    held = tuple(ex.i * geom.g + k for k in range(geom.g))
    c = None
    for k in range(geom.g):
        c = _rank_mm(a_g, b_g[k], held, k, steps, c, geom)
    return ex.unbatch(c)


def _rank_sparse_ring_c(a: Dict, b: Dict, pairs, geom: _Geom,
                        ex: GroupExecutor) -> torch.Tensor:
    """Stationary-C ring with packed sparse output on a rank: A and B ride
    their rings in block form, B2 adds each step into the rank's packed C
    slots (float32 carry, cast once)."""
    c = None
    for t, (a_t, b_t) in enumerate(zip(_ring_stream(ex, a, "col", geom),
                                       _ring_stream(ex, b, "row", geom))):
        c = _sparse_step(a_t, b_t, pairs[t], c, geom, ex)
    return ex.unbatch(c.to(geom.out_dtype))


def _rank_sparse_summa_bcast(a: Dict, b: Dict, pairs, geom: _Geom,
                             ex: GroupExecutor) -> torch.Tensor:
    """Bulk-synchronous SUMMA with packed sparse output on a rank."""
    c = None
    for t, (a_k, b_k) in enumerate(zip(_bcast_stream(ex, a, "col", geom),
                                       _bcast_stream(ex, b, "row", geom))):
        c = _sparse_step(a_k, b_k, pairs[t], c, geom, ex)
    return ex.unbatch(c.to(geom.out_dtype))


def _rank_sparse_summa_ag(a: Dict, b: Dict, pairs, geom: _Geom,
                          ex: GroupExecutor) -> torch.Tensor:
    """All-gather SUMMA with packed sparse output on a rank: the gathered
    pools' slot k feeds inner step k."""
    a_g = ex.all_gather(a, "col")["blocks"]
    b_g = ex.all_gather(b, "row")["blocks"]
    c = None
    for t in range(geom.g):
        c = _sparse_step({"blocks": a_g[t]}, {"blocks": b_g[t]}, pairs[t], c,
                         geom, ex)
    return ex.unbatch(c.to(geom.out_dtype))


def _rank_packed_ring_c(a: Dict, b: Dict, aux, steps: _RankSteps,
                        geom: _Geom, ex: GroupExecutor) -> torch.Tensor:
    """Stationary-C ring over packed buffers on a rank: only real blocks
    ride; a packed B is densified per step by its gather map."""
    b_packed = "b_dmap" in aux[0]
    b0 = b if b_packed else _densify_b(b, geom, ex)
    c = None
    for t, (held, a_t, b_t) in enumerate(zip(
            _held(steps.maps, ex.position), _ring_stream(ex, a, "col", geom),
            _ring_stream(ex, b0, "row", geom))):
        bd = _rank_packed_b(b_t["blocks"], aux[t]["b_dmap"], geom) \
            if b_packed else b_t["dense"]
        c = _rank_packed_mm(a_t["blocks"][None], aux[t], (held,), 0, bd,
                            steps, c, geom)
    return ex.unbatch(c)


def _rank_packed_ring_c_bidir(a: Dict, b: Dict, aux, steps: _RankSteps,
                              geom: _Geom, ex: GroupExecutor
                              ) -> torch.Tensor:
    """Bidirectional ring on a rank, A packed in both directions and B's
    half-panels dense (they need not be block-aligned)."""
    b = _densify_b(b, geom, ex)["dense"]
    half = geom.tn // 2
    halves = ({"dense": b[:, :half].contiguous()},
              {"dense": b[:, half:].contiguous()})
    c = [None, None]
    p = ex.position
    for t, (a_f, a_b, b_f, b_b) in enumerate(zip(
            _ring_stream(ex, a, "col", geom, +1),
            _ring_stream(ex, a, "col", geom, -1),
            _ring_stream(ex, halves[0], "row", geom, +1),
            _ring_stream(ex, halves[1], "row", geom, -1))):
        for h, (a_t, b_t) in enumerate(((a_f, b_f), (a_b, b_b))):
            held = int(steps.maps[t][h][0][p])
            c[h] = _rank_packed_mm(a_t["blocks"][None], aux[t], (held,), 0,
                                   b_t["dense"], steps, c[h], geom,
                                   stream=("", "_bwd")[h])
    return ex.unbatch(torch.cat(c, dim=2))


def _rank_packed_ring_a(a: Dict, b: Dict, aux, steps: _RankSteps,
                        geom: _Geom, ex: GroupExecutor) -> torch.Tensor:
    """Stationary-A ring on a rank with B packed: B's real blocks ride the
    row ring, densified per step; the partial C rides back dense."""
    a_pool, p = _local_view(a), ex.position
    acc = None
    for t, b_t in enumerate(_ring_stream(ex, b, "row", geom)):
        bd = _rank_packed_b(b_t["blocks"], aux[t]["b_dmap"], geom)
        acc = _rank_mm(a_pool, bd, (p,), 0, steps, acc, geom)
        acc = _tree_ppermute(ex, {"c": acc}, "col")["c"]
    return ex.unbatch(acc)


def _rank_packed_summa_bcast(a: Dict, b: Dict, aux, steps: _RankSteps,
                             geom: _Geom, ex: GroupExecutor) -> torch.Tensor:
    """SUMMA broadcasting packed buffers per inner step on a rank."""
    b_packed = "b_dmap" in aux[0]
    b0 = b if b_packed else _densify_b(b, geom, ex)
    c = None
    for k, (a_k, b_k) in enumerate(zip(_bcast_stream(ex, a, "col", geom),
                                       _bcast_stream(ex, b0, "row", geom))):
        bd = _rank_packed_b(b_k["blocks"], aux[k]["b_dmap"], geom) \
            if b_packed else b_k["dense"]
        c = _rank_packed_mm(a_k["blocks"][None], aux[k],
                            (ex.i * geom.g + k,), 0, bd, steps, c, geom)
    return ex.unbatch(c)


def _rank_packed_summa_ag(a: Dict, b: Dict, aux, steps: _RankSteps,
                          geom: _Geom, ex: GroupExecutor) -> torch.Tensor:
    """All-gather SUMMA over packed panels on a rank: the gathered packed
    pools are read as flat buffers through the all-gather planner's
    based lists (``_summa_bases``)."""
    b_packed = "b_dmap" in aux[0]
    a_g = ex.all_gather(a, "col")["blocks"]
    b_g = ex.all_gather(b if b_packed else _densify_b(b, geom, ex), "row")
    held = tuple(ex.i * geom.g + k for k in range(geom.g))
    c = None
    for k in range(geom.g):
        bd = _rank_packed_b(b_g["blocks"], aux[k]["b_dmap"], geom) \
            if b_packed else b_g["dense"][k]
        c = _rank_packed_mm(a_g, aux[k], held, k, bd, steps, c, geom)
    return ex.unbatch(c)


@dataclasses.dataclass(frozen=True)
class _StealRank:
    """A steal3d plan as one rank runs it: its own rows of the plan's pair
    lists (pool-relative, as the JAX body reads them) per B1 launch, with
    B1's table of the real pairs where the kernel runs."""
    splan: "_steal3d.StealPlan"
    segments: Tuple[Dict, ...]

    @property
    def real_pairs(self) -> int:
        """Pair products this rank's B1 launches multiply (sparse A)."""
        return int(sum(int(s["real"].sum()) for s in self.segments))


def _steal_rank(splan: "_steal3d.StealPlan", geom: _Geom, ex: GroupExecutor,
                kernel: bool) -> _StealRank:
    """This rank's slice of a StealPlan (host numpy, once per plan)."""
    g, aux = geom.g, splan.aux
    r, c = ex.i, ex.j
    if splan.a_kind != "bsr":
        stride = 1
    else:
        stride = splan.a_wire_capacity if splan.wire == "packed" \
            else splan.store_a
    if splan.wire == "packed":
        moved = sum(cap * rcap for cap, rcap in zip(splan.a_move_cap,
                                                    splan.a_round_cap))
    else:
        moved = sum(splan.a_move_cap) * stride
    # (lists, the pool index of the segment's zero block)
    names = (("pa0", "pb0", "ps0", g * stride),
             ("pa1", "pb1", "ps1", g * stride + moved)) if splan.overlap \
        else (("pa", "pb", "ps", g * stride + moved),)
    segments = []
    for ka, kb, ks, zero in names:
        pa, pb, ps = (np.asarray(aux[k][r, c]).reshape(1, -1)
                      for k in (ka, kb, ks))
        seg = {k: torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.int32)).to(ex.device)
            for k, x in (("pa", pa), ("pb", pb), ("ps", ps))}
        seg["real"] = pa != zero
        if kernel and splan.a_kind == "bsr":
            seg["table"] = _spmm_table(pa, ps, pb, splan.n_slots,
                                       real=seg["real"],
                                       b_map=np.zeros(1, np.int64),
                                       device=ex.device)
        segments.append(seg)
    return _StealRank(splan=splan, segments=tuple(segments))


def _rank_body_steal3d(a: Dict, b: Dict, st: _StealRank, geom: _Geom,
                       ex: GroupExecutor) -> torch.Tensor:
    """The paper's SS3.4 work stealing on a rank, as the JAX body runs it.

    The rank all-gathers its A grid-row panel and (densified) B grid-column
    panel, sends and receives the moved tiles of the off-owner items in
    one round per hop distance (``_steal3d_perm``: position d sends to
    ``d + delta``), runs one B1 flat dispatch over its pair list (two with
    ``overlap``: its own items while the moved tiles are in flight, then
    the stolen ones), and ships partial C tiles home in the reduce rounds
    (on the packed wire only the block-rows each sender's items touch).
    Dense A takes the JAX einsum as a plain PyTorch product.
    """
    splan, aux = st.splan, st.splan.aux
    r, c_ = ex.i, ex.j
    sparse = splan.a_kind == "bsr"
    packed = splan.wire == "packed"
    a_tiles = ex.all_gather(a, "col")["blocks" if sparse else "dense"]
    b_tiles = ex.all_gather(_densify_b(b, geom, ex), "row")["dense"]
    moved_a = []
    for n, delta in enumerate(splan.a_deltas):
        part = a_tiles[torch.as_tensor(aux[f"amk{delta}"][r, c_],
                                       device=ex.device).long()]
        if packed:
            part = part[:, :splan.a_round_cap[n]]
        moved_a.append(_tree_ppermute(ex, {"x": part}, "row", -delta,
                                      wait=False))
    moved_b = [_tree_ppermute(ex, {"x": b_tiles[torch.as_tensor(
        aux[f"bmk{delta}"][r, c_], device=ex.device).long()]}, "col", -delta,
        wait=False) for delta in splan.b_deltas]
    if sparse:
        panel_a = a_tiles.reshape(-1, *a_tiles.shape[-2:])
        zero_a = panel_a.new_zeros((1,) + panel_a.shape[1:])
    else:
        panel_a = a_tiles
        zero_a = a_tiles.new_zeros((1,) + a_tiles.shape[1:])

    def pools():
        moved = [m.result()["x"] for m in moved_a]
        if sparse:
            moved = [m.reshape(-1, *m.shape[-2:]) for m in moved]
        return (torch.cat([panel_a] + moved + [zero_a]),
                torch.cat([b_tiles] + [m.result()["x"] for m in moved_b]))

    def accum(a_p, b_p, seg, out):
        if sparse:
            return kops.steal_pair_accumulate(
                a_p, b_p.reshape(-1, geom.tn), seg["pa"], seg["pb"],
                seg["ps"], n_slots=splan.n_slots, impl=geom.impl,
                table=seg.get("table"), out=out)
        prods = torch.matmul(a_p[seg["pa"][0].long()].float(),
                             b_p[seg["pb"][0].long()].float())
        cc = torch.zeros((splan.n_out, geom.tm, geom.tn),
                         dtype=torch.float32, device=ex.device) \
            if out is None else out.view(splan.n_out, geom.tm, geom.tn)
        cc.index_add_(0, seg["ps"][0].long(), prods)
        return cc.view(1, splan.n_out * geom.tm, geom.tn)

    if splan.overlap:
        c = accum(torch.cat([panel_a, zero_a]), b_tiles, st.segments[0],
                  None)
        c = accum(*pools(), st.segments[1], c)
    else:
        c = accum(*pools(), st.segments[0], None)
    c = c.view(splan.n_out, geom.tm, geom.tn)
    if packed:
        nbr = geom.a_nbr
        rows = c.view(splan.n_out, nbr, geom.tm // nbr, geom.tn)
        own = torch.cat([rows[0], rows.new_zeros((1,) + rows.shape[2:])])
        for axis, pre, deltas in (("col", "r", splan.row_deltas),
                                  ("row", "c", splan.col_deltas)):
            for delta in deltas:
                part = rows[int(aux[f"{pre}send{delta}"][r, c_]),
                            torch.as_tensor(aux[f"{pre}row{delta}"][r, c_],
                                            device=ex.device).long()]
                part = _tree_ppermute(ex, {"x": part}, axis, -delta)["x"]
                own.index_add_(0, torch.as_tensor(
                    aux[f"{pre}tgt{delta}"][r, c_], device=ex.device).long(),
                    part)
        own = own[:nbr].reshape(geom.tm, geom.tn)
    else:
        own = c[0]
        for axis, pre, deltas in (("col", "r", splan.row_deltas),
                                  ("row", "c", splan.col_deltas)):
            for delta in deltas:
                part = c[int(aux[f"{pre}send{delta}"][r, c_])]
                own = own + _tree_ppermute(ex, {"x": part}, axis,
                                           -delta)["x"]
    return own.to(geom.out_dtype)


@dataclasses.dataclass(frozen=True)
class _RankBodies:
    """A schedule's bodies on a process grid (``Algorithm.on_ranks``):
    dense output, the packed wire, sparse output, and the packed wire's
    planner where it differs from the stacked one (summa_ag's flat pool)."""
    body: Callable
    packed_body: Optional[Callable] = None
    sparse_body: Optional[Callable] = None
    wire_planner: Optional[Callable] = None


# ---------------------------------------------------------------------------
# Algorithm registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A registered schedule: its bodies + declarative placement needs.

    ``a_placement`` / ``b_placement`` name the :data:`PLACEMENTS` state each
    operand must be in before the body runs (the handle caches the
    transform); ``unskew_out`` names the inverse placement applied to the
    output; ``wire`` lists which tiles ride the network each inner step
    (repeats allowed — ``ring_c_bidir`` ships A in both directions; feeds
    :meth:`MatmulPlan.cost_model`); ``wire_amortized`` marks schedules whose
    communication happens once up front (all-gather) rather than per step;
    ``duplex=2`` marks schedules that split traffic over both directions of
    the full-duplex links, halving serialized wire time; ``msgs_per_step``
    is the alpha-term count (``len(wire)`` when None).

    ``sparse_body`` is the packed-output SpGEMM body and ``k_order(i, j,
    t, g)`` the inner index k of step t on grid position (i, j), which
    schedules the symbolic phase's pair lists; ``balance_axis`` the operand
    balance the schedule benefits from (:func:`recommended_balance`);
    ``packed_body`` the packed-wire dense-output body, fed the
    ``wire_planner``'s consume maps for the operands named in ``packable``.
    ``static_planner(a_h, b_h, geom, wire=, assignment=)`` builds a
    schedule's structure-specialised plan (steal3d's
    :class:`~repro_torch.core.steal3d.StealPlan`, which its body consumes
    in place of per-step maps; it packs the A side alone) and ``cost_fn(alg,
    geom, a_h, b_h, wire=)`` scores it for :func:`auto_select` from that
    plan instead of the generic cost model.  ``step_maps(geom, ex)`` (the
    port's own) lists each step's ``(a_map, b_map)`` per kernel launch
    (:meth:`MatmulPlan.step_maps`).  ``on_ranks`` holds the bodies that
    run the schedule on a process grid (``plan_matmul(mesh=...)``), one
    tile per rank; a schedule without them runs stacked only.
    """
    name: str
    body: Callable
    a_placement: str = NATURAL
    b_placement: str = NATURAL
    unskew_out: Optional[str] = None        # None | "rows"
    wire: Tuple[str, ...] = ("a", "b")      # tile names from {"a", "b", "c"}
    wire_amortized: bool = False
    style: str = "rdma"                     # "rdma" | "bsp"
    duplex: int = 1                         # link directions used per step
    msgs_per_step: Optional[int] = None
    sparse_body: Optional[Callable] = None
    k_order: Optional[Callable] = None
    balance_axis: str = "rows"
    static_planner: Optional[Callable] = None
    cost_fn: Optional[Callable] = None
    packed_body: Optional[Callable] = None
    packable: Tuple[str, ...] = ()
    wire_planner: Optional[Callable] = None
    step_maps: Optional[Callable] = None
    on_ranks: Optional[_RankBodies] = None


class AlgorithmRegistry:
    """Name -> :class:`Algorithm` map driving :func:`matmul` dispatch."""

    def __init__(self):
        self._algorithms: Dict[str, Algorithm] = {}

    def register(self, alg: Algorithm, *, overwrite: bool = False
                 ) -> Algorithm:
        for placement, who in ((alg.a_placement, "a"),
                               (alg.b_placement, "b")):
            if placement not in PLACEMENTS:
                raise ValueError(
                    f"algorithm {alg.name!r}: unknown {who}_placement "
                    f"{placement!r}; one of {PLACEMENTS}")
        if alg.name in self._algorithms:
            if not overwrite:
                raise ValueError(f"algorithm {alg.name!r} already registered")
            _evict_plans_for_algorithm(alg.name)
        self._algorithms[alg.name] = alg
        return alg

    def unregister(self, name: str) -> None:
        if self._algorithms.pop(name, None) is not None:
            _evict_plans_for_algorithm(name)

    def get(self, name: str) -> Algorithm:
        try:
            return self._algorithms[name]
        except KeyError:
            raise ValueError(
                f"unknown algorithm {name!r}; one of {self.names()}") from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._algorithms)

    def __contains__(self, name: str) -> bool:
        return name in self._algorithms

    def __iter__(self):
        return iter(self._algorithms.values())

    def __len__(self) -> int:
        return len(self._algorithms)


REGISTRY = AlgorithmRegistry()


def register_algorithm(name: str, *, a_placement: str = NATURAL,
                       b_placement: str = NATURAL,
                       unskew_out: Optional[str] = None,
                       wire: Tuple[str, ...] = ("a", "b"),
                       wire_amortized: bool = False, style: str = "rdma",
                       duplex: int = 1, msgs_per_step: Optional[int] = None,
                       sparse_body: Optional[Callable] = None,
                       k_order: Optional[Callable] = None,
                       balance_axis: str = "rows",
                       static_planner: Optional[Callable] = None,
                       cost_fn: Optional[Callable] = None,
                       packed_body: Optional[Callable] = None,
                       packable: Tuple[str, ...] = (),
                       wire_planner: Optional[Callable] = None,
                       step_maps: Optional[Callable] = None,
                       on_ranks: Optional[_RankBodies] = None,
                       registry: AlgorithmRegistry = REGISTRY):
    """Decorator registering a stacked-grid body as a named algorithm."""
    def deco(body):
        registry.register(Algorithm(
            name=name, body=body, a_placement=a_placement,
            b_placement=b_placement, unskew_out=unskew_out, wire=wire,
            wire_amortized=wire_amortized, style=style, duplex=duplex,
            msgs_per_step=msgs_per_step, sparse_body=sparse_body,
            k_order=k_order, balance_axis=balance_axis,
            static_planner=static_planner, cost_fn=cost_fn,
            packed_body=packed_body, packable=packable,
            wire_planner=wire_planner, step_maps=step_maps,
            on_ranks=on_ranks))
        return body
    return deco


def _evict_plans_for_algorithm(name: str) -> None:
    """Drop the cached plans of a schedule that was re-registered or
    unregistered (their bodies are stale)."""
    invalidate_plans(algorithm=name)


# Registration order is the JAX package's (auto_select breaks ties by it).
register_algorithm("summa_bcast", style="bsp",
                   sparse_body=_sparse_body_summa,
                   packed_body=_packed_body_summa, packable=("a", "b"),
                   wire_planner=_wire_planner_summa_bcast,
                   k_order=lambda i, j, t, g: t + 0 * (i + j),
                   step_maps=_steps_summa,
                   on_ranks=_RankBodies(
                       _rank_body_summa_bcast, _rank_packed_summa_bcast,
                       _rank_sparse_summa_bcast))(_body_summa_bcast)
register_algorithm("summa_ag", style="bsp", wire_amortized=True,
                   sparse_body=_sparse_body_summa,
                   packed_body=_packed_body_summa, packable=("a", "b"),
                   wire_planner=_wire_planner_summa_bcast,
                   k_order=lambda i, j, t, g: t + 0 * (i + j),
                   step_maps=_steps_summa,
                   on_ranks=_RankBodies(
                       _rank_body_summa_ag, _rank_packed_summa_ag,
                       _rank_sparse_summa_ag,
                       wire_planner=_wire_planner_summa_ag))(_body_summa_ag)
register_algorithm("ring_c", a_placement=SKEW_ROWS, b_placement=SKEW_COLS,
                   sparse_body=_sparse_body_ring_c,
                   packed_body=_packed_body_ring_c, packable=("a", "b"),
                   wire_planner=_wire_planner_ring_c,
                   k_order=lambda i, j, t, g: (i + j + t) % g,
                   step_maps=_steps_ring_c,
                   on_ranks=_RankBodies(
                       _rank_body_ring_c, _rank_packed_ring_c,
                       _rank_sparse_ring_c))(_body_ring_c)
register_algorithm("ring_a", b_placement=STATIONARY_A, unskew_out="rows",
                   wire=("b", "c"), balance_axis="cols",
                   packed_body=_packed_body_ring_a, packable=("b",),
                   wire_planner=_wire_planner_ring_a,
                   step_maps=_steps_ring_a,
                   on_ranks=_RankBodies(
                       _rank_body_ring_a, _rank_packed_ring_a))(_body_ring_a)
register_algorithm("ring_c_bidir", a_placement=SKEW_ROWS,
                   b_placement=SKEW_COLS, wire=("a", "a", "b"), duplex=2,
                   packed_body=_packed_body_ring_c_bidir, packable=("a",),
                   wire_planner=_wire_planner_ring_c_bidir,
                   msgs_per_step=4,     # a_fwd, a_bwd, b_left, b_right
                   step_maps=_steps_ring_c_bidir,
                   on_ranks=_RankBodies(
                       _rank_body_ring_c_bidir,
                       _rank_packed_ring_c_bidir))(_body_ring_c_bidir)
register_algorithm("steal3d", style="bsp", wire=("a", "b", "c"),
                   static_planner=_steal_plan_for, cost_fn=_steal3d_cost,
                   packable=("a",),
                   on_ranks=_RankBodies(_rank_body_steal3d))(_body_steal3d)


def algorithms() -> Tuple[str, ...]:
    """Names of all registered algorithms (registration order)."""
    return REGISTRY.names()


def sparse_algorithms() -> Tuple[str, ...]:
    """Names of algorithms with a sparse-output (packed SpGEMM) body."""
    return tuple(a.name for a in REGISTRY if a.sparse_body is not None)


def recommended_balance(algorithm: str) -> str:
    """The operand balance axis the named schedule benefits from.

    Stationary-C schedules are dominated by the A tiles streamed each step,
    so spreading nonzero blocks over grid *rows* shrinks their capacity;
    the stationary-A ring's cost is dominated by B/C traffic and its output
    rides a reverse ring, so a *column* balance (compensated on the B side,
    leaving C unpermuted) composes better.  Feed the result to
    ``DistBSR.from_dense(balance=...)``.
    """
    return REGISTRY.get(algorithm).balance_axis


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------
class _LRUCache:
    """Small bounded cache: access-ordered, with hit/miss/eviction counters.

    Every entry is rebuilt on demand from its operands, so eviction only
    costs a rebuild on re-miss.  ``clear()`` drops entries, keeps counters.
    """

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        self._d: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key, default=None):
        try:
            value = self._d[key]
        except KeyError:
            self.misses += 1
            return default
        self.hits += 1
        self._d.move_to_end(key)
        return value

    def __setitem__(self, key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1

    def __delitem__(self, key) -> None:
        del self._d[key]

    def __iter__(self):
        return iter(list(self._d))

    def __len__(self) -> int:
        return len(self._d)

    def values(self) -> list:
        return list(self._d.values())

    def clear(self) -> None:
        self._d.clear()

    def reset_counters(self) -> None:
        self.evictions = 0
        self.hits = 0
        self.misses = 0


PLAN_CACHE_MAX = 128
SYMBOLIC_CACHE_MAX = 32
DENSITY_CACHE_MAX = 256
STEAL_CACHE_MAX = 32
# B1 tables a dense-output plan keeps: one per ring step and A structure
SPMM_TABLE_CACHE_MAX = 16
_PLAN_CACHE = _LRUCache(PLAN_CACHE_MAX)
# Symbolic-phase results keyed on the operands' structure fingerprints:
# repeated sparse-output plans for the same structures skip the host-side
# pair-list construction.  Density-only results (the cheap prefix that
# output="auto" consults) cache separately, so an auto decision that
# resolves to dense never builds pair lists.
_SYMBOLIC_CACHE = _LRUCache(SYMBOLIC_CACHE_MAX)
_DENSITY_CACHE = _LRUCache(DENSITY_CACHE_MAX)
# steal3d assignments and pair lists, keyed on abstract shapes and (sparse
# A) the structure fingerprint: repeated plans and auto_select scores for
# the same operands skip the host-side LPT and list construction.
_STEAL_CACHE = _LRUCache(STEAL_CACHE_MAX)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _SYMBOLIC_CACHE.clear()
    _DENSITY_CACHE.clear()
    _STEAL_CACHE.clear()


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


def cache_stats(reset: bool = False) -> Dict[str, Dict[str, int]]:
    """Size, cap, hit/miss and eviction counts of the plan, symbolic-phase,
    density and steal3d caches.

    ``reset=True`` zeroes the counters after reading them; the returned
    dict holds the values from before the reset.
    """
    caches = {"plans": _PLAN_CACHE, "symbolic": _SYMBOLIC_CACHE,
              "density": _DENSITY_CACHE, "steal": _STEAL_CACHE}
    out = {name: {"size": len(c), "maxsize": c.maxsize,
                  "evictions": c.evictions, "hits": c.hits,
                  "misses": c.misses} for name, c in caches.items()}
    if reset:
        for c in caches.values():
            c.reset_counters()
    return out


# The plan caches surface in obs snapshots as a pull-time callback: the
# registry reads cache_stats() lazily, with no per-hit instrument update.
_obs.registry().register_callback("plan_caches", cache_stats)

# Machine scoring the predicted side of obs drift records (the measured
# side is the synchronised wall clock); None means H100_SXM.
_DRIFT_MACHINE: Optional["_roofline.Machine"] = None


def set_drift_machine(machine) -> None:
    """Set the Machine used for the predicted side of obs drift records.

    ``None`` restores the default, :data:`~repro_torch.core.roofline.
    H100_SXM`: the predictions describe a g x g grid of H100s (the JAX
    package's default is its TPU preset, which the port does not carry).
    """
    global _DRIFT_MACHINE
    _DRIFT_MACHINE = machine


def _key_g(abstract_key) -> Optional[int]:
    """Grid size of a handle abstract key (None for unrecognised keys)."""
    if not isinstance(abstract_key, tuple) or not abstract_key:
        return None
    if abstract_key[0] == "bsr":
        return int(abstract_key[2][0])
    if abstract_key[0] == "dense":
        return int(abstract_key[2])
    return None


def invalidate_plans(*, algorithm: Optional[str] = None,
                     structure: Optional[str] = None,
                     g: Optional[int] = None) -> int:
    """Keyed plan-cache invalidation: evict only the entries matching every
    given filter (AND semantics; at least one filter is required).

    * ``algorithm`` — a registry name: entries whose schedule it is.
    * ``structure`` — a structure fingerprint (``DistBSR.structure_key()``):
      entries planned against that sparsity structure, including the
      symbolic/density/steal side caches keyed on fingerprints.
    * ``g`` — a grid size: entries planned for a g x g grid.

    Returns the number of entries evicted across all caches.
    """
    if algorithm is None and structure is None and g is None:
        raise ValueError(
            "invalidate_plans requires at least one of algorithm=, "
            "structure=, g= (use clear_plan_cache() to drop everything)")

    def plan_key_matches(k) -> bool:
        # (name, impl, allow_pad, overlap, a_key, b_key, *structure tags)
        if algorithm is not None and k[0] != algorithm:
            return False
        if g is not None and _key_g(k[4]) != g and _key_g(k[5]) != g:
            return False
        if structure is not None and structure not in k[6:]:
            return False
        return True

    evicted = 0
    for key in [k for k in _PLAN_CACHE if plan_key_matches(k)]:
        del _PLAN_CACHE[key]
        evicted += 1
    # side caches are keyed on fingerprints and abstract shapes, not on
    # the schedule: swept for structure and grid filters only
    if structure is not None or g is not None:
        for key in [k for k in _STEAL_CACHE
                    if (structure is None or structure == k[2])
                    and (g is None or _key_g(k[0]) == g)]:
            del _STEAL_CACHE[key]
            evicted += 1
        if algorithm is None and structure is not None:
            for cache in (_SYMBOLIC_CACHE, _DENSITY_CACHE):
                for key in [k for k in cache if structure in k]:
                    del cache[key]
                    evicted += 1
    return evicted


# ---------------------------------------------------------------------------
# Distributed-matrix handles
# ---------------------------------------------------------------------------
def _place_bsr(t: TiledBSR, placement: str) -> TiledBSR:
    if placement == NATURAL:
        return t
    if placement in (SKEW_ROWS, SKEW_COLS):
        return skew_bsr(t, placement[len("skew_"):])
    if placement == STATIONARY_A:
        g = t.grid_shape[0]
        i = torch.arange(g, device=t.device)[:, None]
        j = torch.arange(g, device=t.device)[None, :]
        si, sj = j + 0 * i, (i + j) % g   # position (i,j) <- tile (j,(i+j)%g)
        return dataclasses.replace(
            t, blocks=t.blocks[si, sj], rows=t.rows[si, sj],
            cols=t.cols[si, sj], counts=t.counts[si, sj])
    raise ValueError(f"unknown placement {placement!r}; one of {PLACEMENTS}")


def _place_dense(x: torch.Tensor, g: int, placement: str) -> torch.Tensor:
    if placement == NATURAL:
        return x
    if placement == SKEW_ROWS:
        return skew_dense(x, g, "rows")
    if placement == SKEW_COLS:
        return skew_dense(x, g, "cols")
    if placement == STATIONARY_A:
        return place_b_for_stationary_a(x, g)
    raise ValueError(f"unknown placement {placement!r}; one of {PLACEMENTS}")


class DistMatrix:
    """A matrix distributed over a square ``g x g`` process grid.

    ``placed(p)`` materialises the operand tree for placement ``p`` at most
    once per handle, as stacked ``[g, g, ...]`` tile tensors.
    """

    kind = "abstract"

    @property
    def g(self) -> int:
        raise NotImplementedError

    @property
    def shape(self) -> Tuple[int, int]:      # padded global shape
        raise NotImplementedError

    @property
    def logical_shape(self) -> Tuple[int, int]:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def tile_shape(self) -> Tuple[int, int]:
        s = self.shape
        return s[0] // self.g, s[1] // self.g

    def placed(self, placement: str) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def abstract_key(self) -> tuple:
        """Hashable signature (shapes, dtype, device; no data) for caching."""
        raise NotImplementedError

    def placements(self) -> Tuple[str, ...]:
        """Placement states materialised so far."""
        return tuple(self._placed)


class DistBSR(DistMatrix):
    """Handle for a block-sparse distributed matrix (wraps TiledBSR)."""

    kind = "bsr"

    def __init__(self, tiled: TiledBSR):
        if tiled.grid_shape[0] != tiled.grid_shape[1]:
            raise ValueError("square process grid required, got "
                             f"{tiled.grid_shape}")
        self.tiled = tiled
        self._placed: Dict[str, Dict[str, torch.Tensor]] = {}
        # on a process grid: the executor and the rank's own (natural)
        # tile, for a product made there (None for a global handle)
        self._ex: Optional[GroupExecutor] = None
        self._local: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def _on_grid(cls, tiled: TiledBSR, ex: GroupExecutor,
                 local: Dict[str, torch.Tensor]) -> "DistBSR":
        """A handle distributed over a process grid: ``tiled`` carries the
        structure of every tile on the host (its ``blocks`` a shape on the
        meta device) and ``local`` this rank's tile ``{"blocks": [store,
        bs, bs]}`` on the executor's device."""
        h = cls(tiled)
        h._ex, h._local = ex, local
        return h

    @property
    def on_grid(self) -> bool:
        """Whether each rank of a process grid holds one tile (a product
        made on a grid) rather than the whole matrix."""
        return self._ex is not None

    def to_global(self) -> "DistBSR":
        """The whole matrix on every rank (collective on a grid: every rank
        calls it), as a global handle on the executor's device; a global
        handle returns itself."""
        if self._ex is None:
            return self
        ex, t = self._ex, self.tiled
        blocks = ex.gather_grid(self._local)["blocks"]
        tiled = dataclasses.replace(
            t, blocks=blocks, rows=t.rows.to(ex.device),
            cols=t.cols.to(ex.device), counts=t.counts.to(ex.device))
        tiled.host_layout = t.host_layout
        return DistBSR(tiled)

    @classmethod
    def from_tiled(cls, tiled: TiledBSR, *, balance: str = "none",
                   capacity="keep") -> "DistBSR":
        """Wrap a TiledBSR; ``balance != "none"`` re-tiles with balancing.

        Re-balancing goes through a dense round trip; a value that already
        carries a balance permutation is kept as it is.  ``capacity``:
        ``"keep"`` (default) keeps the value's capacity, ``None`` re-derives
        the minimum, ``"bucket"`` its 1.25x bucket, an int pins it.  A
        capacity other than ``"keep"`` on a call that does not re-tile
        raises.
        """
        if balance not in ("none", "rows", "cols", "auto"):
            raise ValueError(f"unknown balance {balance!r}; one of "
                             "('none', 'rows', 'cols', 'auto')")
        rebuilds = balance != "none" and tiled.row_block_perm is None \
            and tiled.col_block_perm is None
        if capacity != "keep" and not rebuilds:
            raise ValueError(
                "capacity can only be changed when from_tiled re-tiles "
                "(balance= on an unbalanced value); otherwise rebuild "
                "with TiledBSR.from_dense(capacity=...)")
        if rebuilds:
            m, n = tiled.logical_shape or tiled.shape
            cap = tiled.capacity if capacity == "keep" else capacity
            tiled = TiledBSR.from_dense(
                tiled.to_dense()[:m, :n], ProcessGrid(*tiled.grid_shape),
                tiled.block_size, capacity=cap, dtype=tiled.dtype,
                balance=balance, device=tiled.device)
        return cls(tiled)

    @classmethod
    def from_dense(cls, dense, *, g: int, block_size: int,
                   capacity="bucket", dtype: Optional[torch.dtype] = None,
                   balance: str = "none", device=None) -> "DistBSR":
        """Tile + wrap a dense array on ``device`` (the card by default).

        The default capacity is ``"bucket"``, so handles for near-identical
        sparsity patterns share abstract shapes and therefore plans.
        """
        return cls(TiledBSR.from_dense(dense, ProcessGrid(g, g), block_size,
                                       capacity=capacity, dtype=dtype,
                                       balance=balance, device=device))

    @property
    def g(self) -> int:
        return self.tiled.grid_shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.tiled.shape

    @property
    def logical_shape(self) -> Tuple[int, int]:
        return self.tiled.logical_shape or self.tiled.shape

    @property
    def device(self) -> torch.device:
        return self._ex.device if self._ex is not None else self.tiled.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tiled.dtype

    @property
    def block_size(self) -> int:
        return self.tiled.block_size

    @property
    def capacity(self) -> int:
        return self.tiled.capacity

    @property
    def counts(self) -> torch.Tensor:
        return self.tiled.counts

    @property
    def row_block_perm(self) -> Optional[Tuple[int, ...]]:
        """Row-block balance permutation (None unless ``balance="rows"``)."""
        return self.tiled.row_block_perm

    @property
    def col_block_perm(self) -> Optional[Tuple[int, ...]]:
        """Column-block balance permutation (``balance="cols"``)."""
        return self.tiled.col_block_perm

    def _inv_perm(self, which: str) -> Optional[torch.Tensor]:
        perm = getattr(self.tiled, f"{which}_block_perm")
        if perm is None:
            return None
        attr = f"_inv_{which}_perm"
        inv = getattr(self, attr, None)
        if inv is None:
            inv = torch.as_tensor(_schedule.invert_perm(perm),
                                  device=self.device)
            setattr(self, attr, inv)
        return inv

    def inv_row_perm(self) -> Optional[torch.Tensor]:
        """Inverse of ``row_block_perm`` on the device, cached."""
        return self._inv_perm("row")

    def inv_col_perm(self) -> Optional[torch.Tensor]:
        """Inverse of ``col_block_perm`` on the device, cached."""
        return self._inv_perm("col")

    def densify(self) -> torch.Tensor:
        """Dense logical-shape value (inverts balance perms, crops padding);
        on a process grid, of :meth:`to_global` (collective)."""
        if self._ex is not None:
            return self.to_global().densify()
        d = self.tiled.to_dense()
        bs = self.block_size
        if self.tiled.row_block_perm is not None:
            d = d.reshape(-1, bs, d.shape[1])[self.inv_row_perm()].reshape(
                d.shape)
        if self.tiled.col_block_perm is not None:
            d = d.reshape(d.shape[0], -1, bs)[:, self.inv_col_perm()].reshape(
                d.shape)
        m, n = self.logical_shape
        return d[:m, :n]

    def grid_structure(self) -> "_symbolic.GridStructure":
        """Host-side structural view of the stored slots (cached): one read
        of the block mask per handle, shared by the fingerprint, the
        symbolic phase and the packed wire layout."""
        s = getattr(self, "_grid_structure", None)
        if s is None:
            s = self._grid_structure = _symbolic.extract_structure(self.tiled)
        return s

    def structure_key(self) -> str:
        """Fingerprint of the block structure (which slots hold data).

        Sparse-output and packed-wire plans are specialized to the
        operands' structures (pair lists and consume maps are plan
        constants), so it joins their plan-cache keys.  Cached.
        """
        return self.grid_structure().fingerprint

    def packed_operand(self) -> "_wire.PackedOperand":
        """Packed wire layout of this handle's structure (cached)."""
        po = getattr(self, "_packed_operand", None)
        if po is None:
            po = self._packed_operand = _wire.pack_operand(
                self.grid_structure())
        return po

    def packed_wire(self, placement: str) -> Dict[str, torch.Tensor]:
        """Packed blocks for a placement: ``{"blocks": [g, g, wc, bs,
        bs]}``, each tile's real blocks gathered into the packed prefix and
        the trailing slots guaranteed zero.  Cached per placement, like
        :meth:`placed`."""
        cache = getattr(self, "_packed_placed", None)
        if cache is None:
            cache = self._packed_placed = {}
        tree = cache.get(placement)
        if tree is None:
            po = self.packed_operand()
            placed = self.placed(placement)["blocks"]
            tiles = _wire.placement_tiles(placement, self.g)
            pidx = torch.as_tensor(po.pack_idx[tiles[..., 0], tiles[..., 1]],
                                   device=self.device).long()
            ii = torch.arange(self.g, device=self.device)[:, None, None]
            jj = torch.arange(self.g, device=self.device)[None, :, None]
            tree = cache[placement] = {"blocks": placed[ii, jj, pidx]}
        return tree

    def _layout(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        """Host rows, cols, the layout's real mask
        (:meth:`TiledBSR.real_slots`) and their fingerprint, read once per
        handle: the padded wire's B1 tables come from them, not from the
        block values."""
        lay = getattr(self, "_layout_cache", None)
        if lay is None:
            t = self.tiled
            host = t.host()
            rows, cols = host["rows"], host["cols"]
            real = t.real_slots()
            h = hashlib.sha1()
            for arr in (rows, cols, real):
                h.update(np.ascontiguousarray(arr).tobytes())
            lay = self._layout_cache = (rows, cols, real, h.hexdigest())
        return lay

    def pool_lists(self, placement: str, packed: bool) -> PoolLists:
        """Each placed tile's block list and real mask (host numpy, cached
        per placement and wire), from which plans cut B1's tables.

        Padded wire: the stored slots, real by the storage layout (capacity
        padding and coverage zeros left out).  Packed wire: the consume
        lists of the packed buffers, real where they name a packed block
        rather than the zero tail.  Pool tile ``q`` is grid position ``q``
        of the placed stack.
        """
        cache = getattr(self, "_pool_lists", None)
        if cache is None:
            cache = self._pool_lists = {}
        lists = cache.get((placement, packed))
        if lists is None:
            tiles = _wire.placement_tiles(placement, self.g).reshape(-1, 2)
            ti, tj = tiles[:, 0], tiles[:, 1]
            if packed:
                po = self.packed_operand()
                gidx = po.gidx[ti, tj].astype(np.int64)
                lists = PoolLists(
                    key=("packed", po.fingerprint, placement), slots=gidx,
                    rows=po.rows[ti, tj], cols=po.cols[ti, tj],
                    real=gidx != po.zero_slot,
                    slots_per_tile=po.wire_capacity)
            else:
                rows, cols, real, fp = self._layout()
                s = self.tiled.store_capacity
                lists = PoolLists(
                    key=("padded", fp, placement),
                    slots=np.broadcast_to(np.arange(s), (len(ti), s)),
                    rows=rows[ti, tj], cols=cols[ti, tj], real=real[ti, tj],
                    slots_per_tile=s)
            cache[(placement, packed)] = lists
        return lists

    def footprint_bytes(self) -> int:
        """Bytes of the stored representation (blocks + structure arrays)."""
        t = self.tiled
        return sum(x.numel() * x.element_size()
                   for x in (t.blocks, t.rows, t.cols, t.counts))

    def placed(self, placement: str) -> Dict[str, torch.Tensor]:
        if self._ex is not None:
            raise ValueError(
                "a DistBSR on a process grid holds one tile per rank; plans "
                "on the grid place it (or call to_global() first)")
        tree = self._placed.get(placement)
        if tree is None:
            t = _place_bsr(self.tiled, placement)
            tree = {"blocks": t.blocks, "rows": t.rows, "cols": t.cols}
            self._placed[placement] = tree
        return tree

    def abstract_key(self) -> tuple:
        t = self.tiled
        return ("bsr", t.shape, t.grid_shape, t.block_size, t.capacity,
                _dtype_name(t.dtype), str(self.device))


class DistDense(DistMatrix):
    """Handle for a dense distributed matrix (grid-padded global tensor)."""

    kind = "dense"

    def __init__(self, data: torch.Tensor, g: int,
                 logical_shape: Optional[Tuple[int, int]] = None):
        if not isinstance(data, torch.Tensor):
            raise TypeError("DistDense wraps a tensor; use "
                            "DistDense.from_global for arrays")
        if data.dim() != 2:
            raise ValueError(f"expected a 2-D array, got shape "
                             f"{tuple(data.shape)}")
        if data.shape[0] % g or data.shape[1] % g:
            raise ValueError(
                f"padded shape {tuple(data.shape)} not divisible by grid "
                f"size {g}; use DistDense.from_global to pad")
        self.data = data
        self._g = g
        self._logical = tuple(logical_shape or data.shape)
        self._placed: Dict[str, Dict[str, torch.Tensor]] = {}

    @classmethod
    def from_global(cls, x, g: int, *, rows_pad: Optional[int] = None,
                    cols_pad: Optional[int] = None,
                    device=None) -> "DistDense":
        """Wrap a global array on ``device`` (the card by default),
        zero-padding each dim to a multiple of g."""
        x = as_tensor(x, resolve_device(device))
        m, n = x.shape
        rp = pad_to_multiple(m, g) if rows_pad is None else rows_pad
        cp = pad_to_multiple(n, g) if cols_pad is None else cols_pad
        if rp < m or cp < n or rp % g or cp % g:
            raise ValueError(f"bad padded shape ({rp}, {cp}) for array "
                             f"{tuple(x.shape)} on a {g}x{g} grid")
        if (rp, cp) != (m, n):
            padded = x.new_zeros((rp, cp))
            padded[:m, :n] = x
            x = padded
        return cls(x, g, logical_shape=(m, n))

    @classmethod
    def for_rhs(cls, x, a: DistMatrix, *, allow_pad: bool = False,
                device=None) -> "DistDense":
        """Wrap the right operand of ``a @ x``, matching a's padded K dim,
        on a's device unless ``device`` says otherwise.

        The inner dimension must equal a's logical or padded column count;
        anything smaller is only zero-padded with ``allow_pad=True``.
        """
        k = x.shape[0]
        k_pad, k_log = a.shape[1], a.logical_shape[1]
        if k > k_pad:
            raise ValueError(
                f"inner dimensions disagree: right operand has {k} rows, "
                f"left operand has only {k_pad} (padded) columns")
        if k not in (k_pad, k_log) and not allow_pad:
            raise ValueError(
                f"inner dimension mismatch: right operand has {k} rows but "
                f"the left operand has {k_log} logical / {k_pad} padded "
                "columns; pass allow_pad=True to zero-pad explicitly")
        return cls.from_global(x, a.g, rows_pad=k_pad,
                               device=a.device if device is None else device)

    @property
    def g(self) -> int:
        return self._g

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def logical_shape(self) -> Tuple[int, int]:
        return self._logical

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def placed(self, placement: str) -> Dict[str, torch.Tensor]:
        tree = self._placed.get(placement)
        if tree is None:
            tree = {"dense": tileize(
                _place_dense(self.data, self._g, placement), self._g)}
            self._placed[placement] = tree
        return tree

    def abstract_key(self) -> tuple:
        return ("dense", self.shape, self._g, _dtype_name(self.data.dtype),
                str(self.data.device))


# ---------------------------------------------------------------------------
# Operands and results on a process grid
# ---------------------------------------------------------------------------
def _rank_tree(h: DistMatrix, placement: str, packed: bool,
               ex: GroupExecutor, blocks_only: bool = False
               ) -> Dict[str, torch.Tensor]:
    """The tile of ``h`` that ``placement`` puts at this rank's grid
    position, on the rank's device (cached on the handle per placement,
    wire and executor).

    A global handle loads that tile: only its blocks (or its dense tile)
    go to the device.  A handle on the grid (a product made there) holds
    its natural tile, and one exchange round of the placement's tile
    permutation brings each rank the tile it needs (phase ``"place"``).
    Structure (rows, cols) comes from the host, where every rank keeps
    every tile's; ``packed`` takes the tile's real blocks
    (``DistBSR.packed_wire``), ``blocks_only`` drops rows and cols.
    """
    cache = h.__dict__.setdefault("_rank_trees", {})
    key = (placement, packed, blocks_only, id(ex))
    tree = cache.get(key)
    if tree is not None:
        return tree
    ti, tj = (int(x) for x in _wire.placement_tiles(placement, ex.g)[ex.i,
                                                                      ex.j])
    if isinstance(h, DistDense):
        tm, tn = h.tile_shape
        tree = {"dense": h.data[ti * tm:(ti + 1) * tm,
                                tj * tn:(tj + 1) * tn].contiguous().to(
                                    ex.device)}
    else:
        t = h.tiled
        if h.on_grid:
            raw = (placement, "blocks", id(ex))
            if raw not in cache:
                # who needs this rank's natural tile under the placement
                need = _wire.placement_tiles(placement, ex.g).reshape(-1, 2)
                dst = int(np.nonzero((need[:, 0] == ex.i)
                                     & (need[:, 1] == ex.j))[0][0])
                phase, ex.phase = ex.phase, "place"
                try:
                    cache[raw] = ex.permute(h._local, ti * ex.g + tj,
                                            dst)["blocks"]
                finally:
                    ex.phase = phase
            blocks = cache[raw]
        else:
            blocks = t.blocks[ti, tj]
        if packed:
            pidx = torch.as_tensor(h.packed_operand().pack_idx[ti, tj],
                                   device=blocks.device).long()
            tree = {"blocks": blocks.index_select(0, pidx).to(ex.device)}
        else:
            tree = {"blocks": blocks.to(ex.device)}
            if not blocks_only:
                tree["rows"] = t.rows[ti, tj].to(ex.device)
                tree["cols"] = t.cols[ti, tj].to(ex.device)
    cache[key] = tree
    return tree


class RankTile:
    """A dense product on a process grid: this rank's C tile.

    ``tile`` is the rank's ``[tm, tn]`` tile of the padded C, unskewed
    (after a balanced left operand, in its permuted row order).
    :meth:`to_global` all-gathers every rank's tile (collective: every rank
    calls it) and applies the plan's epilogue: the balance permutations
    are inverted and the padding cropped.
    """

    def __init__(self, tile: torch.Tensor, ex: GroupExecutor,
                 finish: Callable[[torch.Tensor], torch.Tensor]):
        self.tile = tile
        self._ex = ex
        self._finish = finish

    @property
    def device(self) -> torch.device:
        return self.tile.device

    def to_global(self) -> torch.Tensor:
        tiles = self._ex.gather_grid({"c": self.tile})["c"]
        return self._finish(untileize(tiles))


def _result_tensor(out):
    """What a multiply's result holds on this process's device (the tensor
    its timing waits for)."""
    if isinstance(out, RankTile):
        return out.tile
    if isinstance(out, DistBSR) and out.on_grid:
        return out._local["blocks"]
    return out


@dataclasses.dataclass(frozen=True)
class _ReshardLayout:
    """Where every stored slot of a BSR handle re-tiled onto a ``g x g``
    grid comes from (host numpy): the new tiles' rows, cols and counts, and
    per new slot the flat index of its block among the old grid's stored
    slots (old tile ``p`` owns ``[p * store_old, (p + 1) * store_old)``),
    -1 for a zero block."""
    g: int
    rows: np.ndarray
    cols: np.ndarray
    counts: np.ndarray
    src: np.ndarray
    capacity: int
    store_old: int
    shape: Tuple[int, int]
    logical_shape: Tuple[int, int]
    block_size: int

    def tiled(self, blocks: torch.Tensor, device) -> TiledBSR:
        return TiledBSR(
            blocks=blocks, rows=torch.as_tensor(self.rows, device=device),
            cols=torch.as_tensor(self.cols, device=device),
            counts=torch.as_tensor(self.counts, device=device),
            shape=self.shape, block_size=self.block_size,
            grid_shape=(self.g, self.g), capacity=self.capacity,
            logical_shape=self.logical_shape)


def _reshard_layout(h: DistBSR, g: int, capacity) -> _ReshardLayout:
    t = h.tiled
    if t.row_block_perm is not None or t.col_block_perm is not None:
        raise ValueError(
            "reshard does not support balanced handles (the balance "
            "permutation is tied to the old grid); rebuild with "
            "DistBSR.from_dense(balance=...) on the new grid")
    bs = t.block_size
    g_old = h.g
    s = h.grid_structure()          # host-side rows/cols/real (cached)
    nbr_old, nbc_old = s.tile_nbr, s.tile_nbc
    m, n = h.logical_shape
    tm = pad_to_multiple(ceil_div(m, g), bs)
    tn = pad_to_multiple(ceil_div(n, g), bs)
    nbr, nbc = tm // bs, tn // bs
    rows_h, cols_h, real_h = s.rows, s.cols, s.real
    store_old = rows_h.shape[2]
    # bucket every real stored block by its new tile, in (row, col) order:
    # the order TiledBSR.from_dense's nonzero scan gives
    per_tile: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
    for i in range(g_old):
        for j in range(g_old):
            for slot in np.nonzero(real_h[i, j])[0]:
                gbr = i * nbr_old + int(rows_h[i, j, slot])
                gbc = j * nbc_old + int(cols_h[i, j, slot])
                src = (i * g_old + j) * store_old + int(slot)
                per_tile.setdefault((gbr // nbr, gbc // nbc), []).append(
                    (gbr % nbr, gbc % nbc, src))
    max_nnzb = max((len(v) for v in per_tile.values()), default=0)
    if capacity == "bucket":
        cap = bucket_capacity(max_nnzb)
    elif capacity is None:
        cap = max_nnzb
    else:
        cap = int(capacity)
        if cap < max_nnzb:
            raise ValueError(f"capacity {cap} < max tile nnzb {max_nnzb}")
    store = cap + nbr
    rows_new = np.zeros((g, g, store), dtype=np.int32)
    cols_new = np.zeros((g, g, store), dtype=np.int32)
    src_new = np.full((g, g, store), -1, dtype=np.int64)
    counts_new = np.zeros((g, g), dtype=np.int32)
    cov = np.arange(nbr, dtype=np.int32)
    for i in range(g):
        for j in range(g):
            ent = sorted(per_tile.get((i, j), []))
            counts_new[i, j] = len(ent)
            r = np.array([e[0] for e in ent], dtype=np.int32)
            c = np.array([e[1] for e in ent], dtype=np.int32)
            src = np.array([e[2] for e in ent], dtype=np.int64)
            # pad to the uniform capacity as BSR.with_capacity does (the
            # last coordinate repeated, zero blocks), then merge the
            # coverage blocks in sorted order
            pad = cap - len(ent)
            last_r = r[-1] if len(ent) else np.int32(0)
            last_c = c[-1] if len(ent) else np.int32(0)
            r = np.concatenate([r, np.full(pad, last_r, np.int32), cov])
            c = np.concatenate([c, np.full(pad, last_c, np.int32),
                                np.zeros(nbr, np.int32)])
            src = np.concatenate([src, np.full(pad + nbr, -1, np.int64)])
            order = np.argsort(r, kind="stable")
            rows_new[i, j] = r[order]
            cols_new[i, j] = c[order]
            src_new[i, j] = src[order]
    return _ReshardLayout(g=g, rows=rows_new, cols=cols_new,
                          counts=counts_new, src=src_new, capacity=cap,
                          store_old=store_old, shape=(tm * g, tn * g),
                          logical_shape=(m, n), block_size=bs)


def _reshard_bsr(h: DistBSR, g: int, capacity) -> DistBSR:
    lay = _reshard_layout(h, g, capacity)
    t, bs = h.tiled, lay.block_size
    # one device gather moves every block value to its new slot: no host
    # round trip of block data, no dense materialisation
    old_flat = t.blocks.reshape(-1, bs, bs)
    pool = torch.cat([old_flat, old_flat.new_zeros((1, bs, bs))])
    idx = np.where(lay.src < 0, old_flat.shape[0], lay.src)
    blocks_new = pool[torch.as_tensor(idx.reshape(-1), device=t.device)]
    return DistBSR(lay.tiled(blocks_new.reshape(g, g, -1, bs, bs),
                             t.device))


def reshard_on_grid(h: DistBSR, g: int, old: GroupExecutor,
                    new: Optional[GroupExecutor], new_ranks: Sequence[int],
                    *, capacity="bucket") -> Optional[DistBSR]:
    """Re-tile a BSR handle held on the process grid of ``old`` (its
    tiles on their ranks, or a global handle whose tiles each rank reads)
    onto the ``g x g`` grid of ``new``, whose position q is the global rank
    ``new_ranks[q]``, by exchange: every rank of the old grid sends each
    new owner the blocks of its old tile that the new tile holds (one
    message per pair, phase ``"place"``), and each new owner assembles
    its tile.  Collective over the old grid: every rank calls it, ``new``
    None on a rank outside the new grid (which then only sends).  The
    layout is :func:`reshard`'s, planned on every rank from the host
    structure; returns the new handle on the grid, or None outside it.

    The JAX package's ``reshard`` reads the whole handle, the lost
    devices' tiles included; here the old owners, lost or not, send
    theirs: the same simulation of a loss, in which a lost rank's memory
    can still be read."""
    lay = _reshard_layout(h, g, capacity)
    bs, store_old = lay.block_size, lay.store_old
    mine = h._local["blocks"] if h.on_grid \
        else h.tiled.blocks[old.i, old.j].to(old.device)
    me, p_old = dist.get_rank(), old.position
    src = lay.src.reshape(g * g, -1)
    tag = old._next_tag(g * g)
    phase, old.phase = old.phase, "place"
    ops, keep, recv = [], [], []
    try:
        for q in range(g * g):
            sel = np.nonzero((src[q] >= 0)
                             & (src[q] // store_old == p_old))[0]
            if not len(sel) or new_ranks[q] == me:
                continue
            part = mine[torch.as_tensor(src[q][sel] - p_old * store_old,
                                        device=mine.device)]
            out = old._to_wire(part)
            keep.append(out)
            ops.append(dist.P2POp(dist.isend, out, int(new_ranks[q]), None,
                                  tag + q))
            old._record("reshard", "grid", out.numel())
        q_me = new.position if new is not None else None
        if q_me is not None:
            blocks = mine.new_zeros((src.shape[1], bs, bs))
            for p in range(old.g * old.g):
                sel = np.nonzero((src[q_me] >= 0)
                                 & (src[q_me] // store_old == p))[0]
                if not len(sel):
                    continue
                at = torch.as_tensor(sel, device=mine.device)
                if p == p_old:
                    blocks[at] = mine[torch.as_tensor(
                        src[q_me][sel] - p * store_old, device=mine.device)]
                    continue
                like = mine.new_empty((len(sel), bs, bs))
                buf = old._buffer(like)
                ops.append(dist.P2POp(dist.irecv, buf, old._ranks[p], None,
                                      tag + q_me))
                recv.append((at, buf, like))
        works = dist.batch_isend_irecv(ops) if ops else []
        for w in works:
            w.wait()
    finally:
        old.phase = phase
    if q_me is None:
        return None
    for at, buf, like in recv:
        blocks[at] = old._from_wire(buf, like)
    meta = lay.tiled(torch.empty((g, g, src.shape[1], bs, bs),
                                 dtype=mine.dtype, device="meta"), "cpu")
    meta.host_layout = {"rows": lay.rows, "cols": lay.cols,
                        "counts": lay.counts, "real": lay.src >= 0}
    return DistBSR._on_grid(meta, new, {"blocks": blocks})


def reshard(h: DistMatrix, g: int, *, capacity="bucket") -> DistMatrix:
    """Re-tile a handle onto a ``g x g`` grid on its device.

    Dense handles re-pad the logical region.  BSR handles re-bucket their
    stored blocks by new-tile coordinates on the host's cached structure
    view (integer index arithmetic only) and move the block values with one
    device gather: nothing is densified.  ``capacity`` is the rebuilt
    uniform tile capacity (``"bucket"`` | ``None`` | int, as in
    :meth:`DistBSR.from_dense`).  Balanced BSR handles are refused: their
    permutation is tied to the old grid.  Returns ``h`` itself when ``g``
    already matches.
    """
    if g < 1:
        raise ValueError(f"grid size must be >= 1, got {g}")
    if isinstance(h, DistBSR):
        if g == h.g:
            return h
        return _reshard_bsr(h, g, capacity)
    if isinstance(h, DistDense):
        if g == h.g:
            return h
        m, n = h.logical_shape
        return DistDense.from_global(h.data[:m, :n], g, device=h.device)
    raise TypeError(f"cannot reshard {type(h).__name__}")


def validate_mesh(executor, g: int, *handles) -> None:
    """Fail fast (and clearly) on a grid the executor cannot run.

    The port's counterpart of the JAX package's mesh check.  A
    :class:`~repro_torch.core.executor.GroupExecutor` (a plan on a process
    grid) must run a ``g x g`` mesh, and a handle made on a grid must
    belong to it; the stacked executor has a grid size and a device, so
    there this checks ``g >= 1``, that it runs a ``g x g`` grid, and that
    every handle lives on that grid and that device.
    """
    if g < 1:
        raise ValueError(f"grid size must be >= 1, got {g}")
    if executor.g != g:
        raise ValueError(
            f"executor grid {executor.g}x{executor.g} does not match the "
            f"{g}x{g} process grid of the operands")
    on_ranks = isinstance(executor, GroupExecutor)
    for h in handles:
        if h.g != g:
            raise ValueError(f"operand lives on a {h.g}x{h.g} grid, not the "
                             f"{g}x{g} grid of the executor")
        if on_ranks:
            if getattr(h, "on_grid", False) and h._ex is not executor:
                raise ValueError("operand was made on another process grid")
        elif h.device != executor.device:
            raise ValueError(f"operand lives on {h.device}, the executor "
                             f"runs on {executor.device}")


_EXECUTORS: Dict[tuple, GroupExecutor] = {}


def _prep_mesh(mesh, g: int, device=None) -> Optional[GroupExecutor]:
    """The executor of a ``plan_matmul(mesh=...)`` request: None (the
    stacked executor), a :class:`GroupExecutor` as given, or one made once
    per (``DeviceMesh``, device) for a mesh from
    :func:`~repro_torch.core.dist.make_grid_mesh` (on ``device``, the card
    set for the rank by default)."""
    if mesh is None or isinstance(mesh, GroupExecutor):
        return mesh
    if tuple(mesh.shape) != (g, g) or mesh.ndim != 2:
        raise ValueError(f"mesh shape {tuple(mesh.shape)} does not match "
                         f"the {g}x{g} process grid of the operands; build "
                         f"one with make_grid_mesh({g}, ...)")
    dev = resolve_device(device)
    key = (_mesh_key(mesh), str(dev))
    ex = _EXECUTORS.get(key)
    if ex is None:
        ex = _EXECUTORS[key] = GroupExecutor(mesh, dev,
                                             *mesh.mesh_dim_names)
    return ex


def _mesh_key(mesh) -> tuple:
    """The plan cache's name for an executor: a plan on one process grid
    is never reused on another, nor a stacked plan on a grid."""
    return ("stacked",) if mesh is None else ("mesh", id(mesh))


def _resolve_overlap(alg: "Algorithm", overlap: str, on_ranks: bool) -> bool:
    """The body an ``overlap`` request builds (``geom.overlap``).

    On a process grid, as the JAX package: the scanned schedules take the
    split-step body on ``"auto"`` and ``"on"``, steal3d only on ``"on"``
    (its second launch pays only where the moved tiles travel while the
    first runs).  On the stacked executor ``"auto"`` is the bulk body: a
    ride is a tile map there, so the split step hides nothing.
    """
    if overlap not in ("auto", "on", "off"):
        raise ValueError(f"unknown overlap {overlap!r}; one of "
                         "('auto', 'on', 'off')")
    if on_ranks and alg.static_planner is None:
        return overlap != "off"
    return overlap == "on"


# ---------------------------------------------------------------------------
# Trace hooks
# ---------------------------------------------------------------------------
_TRACE_HOOKS: List[Callable] = []


def add_trace_hook(hook: Callable) -> Callable:
    """Register ``hook(plan)`` to fire once per plan build (the port's
    counterpart of the JAX package's executable trace; ``plan.traces``
    counts them)."""
    _TRACE_HOOKS.append(hook)
    return hook


def remove_trace_hook(hook: Callable) -> None:
    _TRACE_HOOKS.remove(hook)


# ---------------------------------------------------------------------------
# Operand coercion + plans + public entry points
# ---------------------------------------------------------------------------
def _compensate_rhs(b_h: DistMatrix, perm: Tuple[int, ...],
                    block_size: int) -> DistMatrix:
    """Undo a cols-balanced left operand on the right operand's row blocks.

    A ``balance="cols"`` left operand stores ``A' = A P``; multiplying by
    ``B' = P^T B`` (row blocks gathered by the same permutation) gives
    ``A' B' = A B``.  The compensated handle is cached on the right
    operand, keyed by the permutation.
    """
    cache = getattr(b_h, "_col_compensated", None)
    if cache is None:
        cache = b_h._col_compensated = {}
    if getattr(b_h, "_compensated_for", None) == perm:
        return b_h                       # already the compensated handle
    got = cache.get(perm)
    if got is not None:
        return got
    if isinstance(b_h, DistDense):
        data = b_h.data
        nbr = data.shape[0] // block_size
        idx = torch.as_tensor(np.asarray(perm), device=data.device)
        data = data.reshape(nbr, block_size, -1)[idx]
        new = DistDense(data.reshape(b_h.shape), b_h.g,
                        logical_shape=b_h.logical_shape)
    else:
        # sparse right operand: dense round trip at construction time,
        # keeping any column permutation of B itself (the epilogue inverts
        # it on C)
        t = b_h.tiled
        d = t.to_dense()
        nbr = d.shape[0] // block_size
        idx = torch.as_tensor(np.asarray(perm), device=d.device)
        d = d.reshape(nbr, block_size, -1)[idx].reshape(d.shape)
        newt = TiledBSR.from_dense(d, ProcessGrid(*t.grid_shape),
                                   t.block_size, capacity="bucket",
                                   dtype=t.dtype, device=t.device)
        newt = dataclasses.replace(newt, logical_shape=t.logical_shape
                                   or t.shape,
                                   col_block_perm=t.col_block_perm)
        new = DistBSR(newt)
    new._compensated_for = perm          # idempotence marker (re-coercion)
    cache[perm] = new
    return new


def _coerce_pair(a, b, *, g: Optional[int] = None, allow_pad: bool = False,
                 device=None, on_ranks: bool = False
                 ) -> Tuple[DistMatrix, DistMatrix]:
    """Handles for ``a @ b``, validated.  ``on_ranks`` (a plan on a process
    grid) lets the two live on different devices: each rank moves the
    tiles it needs to its own."""
    if isinstance(a, DistMatrix):
        a_h = a
    elif isinstance(a, TiledBSR):
        a_h = DistBSR.from_tiled(a)
    else:
        if g is None:
            raise ValueError(
                "a dense left operand needs g=<grid size> or a DistDense "
                "handle (DistDense.from_global)")
        a_h = DistDense.from_global(a, g, device=device)
    if g is not None and a_h.g != g:
        raise ValueError(f"left operand lives on a {a_h.g}x{a_h.g} grid, "
                         f"but g={g} was requested")

    if isinstance(b, DistMatrix):
        b_h = b
    elif isinstance(b, TiledBSR):
        b_h = DistBSR.from_tiled(b)
    else:
        b_h = DistDense.for_rhs(b, a_h, allow_pad=allow_pad, device=device)

    if getattr(b_h, "row_block_perm", None):
        raise ValueError(
            "the right operand carries a balance='rows' row-block "
            "permutation, which would permute the contraction dimension; "
            "balanced matrices may only be the left operand (the epilogue "
            "inverts the permutation on output rows)")
    if isinstance(a_h, DistDense) and isinstance(b_h, DistBSR):
        raise NotImplementedError(
            "dense x sparse is not supported; compute the transposed "
            "product sparse x dense instead (B^T A^T = (AB)^T)")
    if a_h.g != b_h.g:
        raise ValueError(f"operands on different process grids: "
                         f"{a_h.g}x{a_h.g} vs {b_h.g}x{b_h.g}")
    if a_h.device != b_h.device and not on_ranks:
        raise ValueError(f"operands on different devices: {a_h.device} vs "
                         f"{b_h.device}")
    if a_h.shape[1] != b_h.shape[0]:
        raise ValueError(
            f"inner (padded) dimensions disagree: A is {a_h.shape}, B is "
            f"{b_h.shape}; build the right operand with "
            "DistDense.for_rhs(b, a) to match A's padding")
    cperm = getattr(a_h, "col_block_perm", None)
    if cperm:
        # cols-balanced left operand: permute B's row blocks to compensate
        b_h = _compensate_rhs(b_h, cperm, a_h.block_size)
    return a_h, b_h


def _geometry(a_h: DistMatrix, b_h: DistMatrix, *, impl: Optional[str],
              overlap: bool = False, c_store: int = 0) -> _Geom:
    a_bsr = isinstance(a_h, DistBSR)
    b_bsr = isinstance(b_h, DistBSR)
    return _Geom(
        g=a_h.g, tm=a_h.tile_shape[0], tn=b_h.tile_shape[1],
        a_nbr=(a_h.tile_shape[0] // a_h.block_size) if a_bsr else 0,
        b_nbr=(b_h.tile_shape[0] // b_h.block_size) if b_bsr else 0,
        b_nbc=(b_h.tile_shape[1] // b_h.block_size) if b_bsr else 0,
        impl=impl, out_dtype=torch.promote_types(a_h.dtype, b_h.dtype),
        overlap=overlap, c_store=c_store)


def _symbolic_for(a_h: DistBSR, b_h: DistBSR) -> SymbolicProduct:
    """Memoised symbolic phase, keyed on the operands' structures."""
    key = (a_h.structure_key(), b_h.structure_key())
    sym = _SYMBOLIC_CACHE.get(key)
    if sym is None:
        with _obs.span("plan_build.symbolic"):
            sym = symbolic_spgemm(a_h.tiled, b_h.tiled)
        _SYMBOLIC_CACHE[key] = sym
    return sym


def _predicted_density_for(a_h: DistBSR, b_h: DistBSR) -> float:
    """Memoised structure-only density (the output="auto" decision input)."""
    key = (a_h.structure_key(), b_h.structure_key())
    sym = _SYMBOLIC_CACHE.get(key)
    if sym is not None:
        return sym.density()
    d = _DENSITY_CACHE.get(key)
    if d is None:
        d = _DENSITY_CACHE[key] = predicted_density(a_h.tiled, b_h.tiled)
    return d


def _sparse_output_eligible(a_h: DistMatrix,
                            b_h: DistMatrix) -> Optional[str]:
    """None when output="sparse" can serve these operands, else the reason."""
    if not (isinstance(a_h, DistBSR) and isinstance(b_h, DistBSR)):
        return "sparse output needs two block-sparse (DistBSR) operands"
    if a_h.block_size != b_h.block_size:
        return (f"sparse output needs equal block sizes, got "
                f"{a_h.block_size} and {b_h.block_size}")
    for h, who in ((a_h, "left"), (b_h, "right")):
        if getattr(h, "row_block_perm", None) or \
                getattr(h, "col_block_perm", None):
            return (
                f"sparse output does not support balanced operands: the "
                f"{who} operand carries a balance permutation, which the "
                "symbolic phase cannot compose into its pair lists yet; "
                'either keep a dense output for this multiply '
                '(output="dense") or rebuild the operand without balancing '
                '(balance="none")')
    return None


# output="auto" emits a sparse DistBSR when the symbolic phase predicts C's
# block density at or below this threshold; above it the packed form loses
# its footprint advantage.
SPARSE_OUTPUT_DENSITY_THRESHOLD = 0.25


def _resolve_wire(wire: str, output: str) -> str:
    """``wire="auto"`` is packed for sparse outputs (their plans are
    specialized to the structure anyway) and padded for dense ones, so
    structurally different operands of equal shapes share a dense plan."""
    if wire == "auto":
        return "packed" if output == "sparse" else "padded"
    return wire


def _b_pack_wins(b_h: DistMatrix) -> bool:
    """Whether packing B beats the densified tile on a dense-output path.

    A dense-output body consumes B as a dense tile either way, so shipping
    B packed only pays when its real blocks cover less than the tile;
    decided on the stored ``counts`` (an upper bound on real blocks).
    """
    if not isinstance(b_h, DistBSR):
        return False
    counts = b_h.tiled.host()["counts"]
    wc = wire_capacity(int(counts.max()) if counts.size else 0,
                       b_h.tiled.store_capacity)
    bs = b_h.block_size
    tm, tn = b_h.tile_shape
    return wc * bs * bs < tm * tn


def _check_request(algorithm: str, output: str, wire: str,
                   overlap: str, impl: Optional[str]) -> None:
    """Refuse, before any work, an unknown option or what the port lacks."""
    if algorithm != "auto":
        REGISTRY.get(algorithm)             # raises: unknown algorithm
    if output not in ("dense", "sparse", "auto"):
        raise ValueError(f"unknown output {output!r}; one of "
                         "('dense', 'sparse', 'auto')")
    if wire not in ("auto", "padded", "packed"):
        raise ValueError(f"unknown wire {wire!r}; one of "
                         "('auto', 'padded', 'packed')")
    if overlap not in ("auto", "on", "off"):
        raise ValueError(f"unknown overlap {overlap!r}; one of "
                         "('auto', 'on', 'off')")
    if impl not in (None, *kops.IMPLS):
        raise ValueError(f"unknown impl {impl!r}; one of {kops.IMPLS}")


def _wire_caps_for(a_h: DistMatrix, b_h: DistMatrix,
                   packable: Tuple[str, ...]) -> Dict[str, int]:
    """Estimated packed wire capacities from the handles' stored counts (an
    upper bound on real blocks), so scoring reads no block values."""
    caps = {}
    for who, h in (("a", a_h), ("b", b_h)):
        if who in packable and isinstance(h, DistBSR):
            counts = h.tiled.host()["counts"]
            caps[who] = wire_capacity(
                int(counts.max()) if counts.size else 0,
                h.tiled.store_capacity)
    return caps


# ---------------------------------------------------------------------------
# Cost model (alpha-beta-gamma) and algorithm="auto"
# ---------------------------------------------------------------------------
def _key_dtype(abstract_key: tuple) -> str:
    """The dtype name of a handle's abstract key, read by its index (the
    port's keys end with the device)."""
    return abstract_key[5] if abstract_key[0] == "bsr" else abstract_key[3]


def _itemsize(dtype) -> int:
    """Bytes per element of a torch dtype or of its name."""
    return (getattr(torch, dtype) if isinstance(dtype, str) else
            dtype).itemsize


def _cost_model(alg: Algorithm, geom: _Geom, a_key: tuple, b_key: tuple,
                symbolic: Optional[SymbolicProduct] = None,
                wire_caps: Optional[Dict[str, int]] = None
                ) -> Dict[str, float]:
    """Per-step wire volume / flops of one plan execution on a g x g grid
    of devices, as the JAX package counts them.

    The A tile rides in its stored pre-augmented BSR form (``capacity +
    tile block-rows`` block products per step, padding included); the B
    tile rides densified regardless of kind; ``wire`` may name a tile twice
    (bidirectional schedules) and ``duplex`` credits full-duplex links in
    :func:`_predicted_time`, not here.  With ``symbolic`` (a sparse-output
    plan) B rides in stored block form, the step executes
    ``pair_capacity`` block-pair products and C is the packed slot array.
    With ``wire_caps`` a packed operand is charged blocks-only at its wire
    capacity.  The counts are the stored slots: B1 multiplies the real
    blocks alone, so these flops over-count the port's kernel work.
    """
    g = geom.g
    wire_caps = wire_caps or {}
    if symbolic is not None:
        bs = symbolic.block_size
        store_a = a_key[4] + geom.a_nbr
        store_b = b_key[4] + geom.b_nbr
        wa = _itemsize(_key_dtype(a_key))
        wb = _itemsize(_key_dtype(b_key))
        a_slots = wire_caps.get("a", store_a)
        b_slots = wire_caps.get("b", store_b)
        a_bytes = a_slots * bs * bs * wa
        b_bytes = b_slots * bs * bs * wb
        c_bytes = symbolic.store_capacity * bs * bs \
            * _itemsize(geom.out_dtype)
        flops_step = 2 * symbolic.pair_capacity * bs ** 3
        tiles = {"a": a_bytes, "b": b_bytes, "c": c_bytes}
        return _assemble_cost(alg, g, a_bytes, b_bytes, c_bytes, flops_step,
                              tiles)
    if a_key[0] == "bsr":
        bs, cap = a_key[3], a_key[4]
        wa = _itemsize(_key_dtype(a_key))
        if "a" in wire_caps:
            wc = wire_caps["a"]             # packed: blocks only
            a_bytes = wc * bs * bs * wa
            slots = min(wc + geom.a_nbr, cap + geom.a_nbr)
            flops_step = 2 * slots * bs * bs * geom.tn
        else:
            store = cap + geom.a_nbr        # pre-augmented stored slots
            a_bytes = store * bs * bs * wa \
                + store * 2 * 4             # + rows/cols int32
            flops_step = 2 * store * bs * bs * geom.tn
    else:
        tk = a_key[1][1] // g
        a_bytes = geom.tm * tk * _itemsize(_key_dtype(a_key))
        flops_step = 2 * geom.tm * tk * geom.tn
    wb = _itemsize(_key_dtype(b_key))
    if "b" in wire_caps and b_key[0] == "bsr":
        b_bytes = wire_caps["b"] * b_key[3] * b_key[3] * wb
    else:
        tk_b = b_key[1][0] // g
        b_bytes = tk_b * geom.tn * wb
    c_bytes = geom.tm * geom.tn * _itemsize(geom.out_dtype)
    tiles = {"a": a_bytes, "b": b_bytes, "c": c_bytes}
    return _assemble_cost(alg, g, a_bytes, b_bytes, c_bytes, flops_step,
                          tiles)


def _assemble_cost(alg: Algorithm, g: int, a_bytes, b_bytes, c_bytes,
                   flops_step, tiles) -> Dict[str, float]:
    step_bytes = sum(tiles[t] for t in alg.wire)
    if alg.wire_amortized:
        step_bytes = step_bytes * (g - 1) / g
    total_flops = float(flops_step * g)
    total_bytes = float(step_bytes * g)
    return {
        "steps": float(g),
        "flops_per_step": float(flops_step),
        "net_bytes_per_step": float(step_bytes),
        "total_flops": total_flops,
        "total_net_bytes": total_bytes,
        "ai_net": total_flops / total_bytes if total_bytes else float("inf"),
        "ai_local": total_flops / (g * (a_bytes + b_bytes) + c_bytes),
    }


def _overlap_eff(alg: Algorithm, machine: "_roofline.Machine",
                 overlap: str) -> float:
    """The comm-hiding fraction the cost model credits this schedule.

    ``"off"`` serializes everything; ``"on"`` credits the machine's
    ``overlap_eff`` to every schedule but the wire-amortized ones (whose
    single up-front gather gates all compute); ``"auto"`` (the scoring
    default) credits it only to the RDMA-style prefetch schedules:
    bulk-synchronous schedules pay ``comp + comm``, rings ``max(comp,
    comm)`` at ``overlap_eff = 1.0`` (the paper's SS3.3 overlap claim).
    """
    if overlap == "off":
        return 0.0
    if overlap == "on":
        return 0.0 if alg.wire_amortized else machine.overlap_eff
    return machine.overlap_eff if alg.style != "bsp" else 0.0


def _time_breakdown(cm: Dict[str, float], alg: Algorithm,
                    machine: "_roofline.Machine",
                    overlap: str = "auto") -> Dict[str, float]:
    """Alpha-beta-gamma time decomposition for one execution.

    Compute time is capped by the local roofline; wire time is serialized
    bytes over the per-chip link share (credited for ``duplex``) plus a
    per-message alpha term (``machine.hop_latency``); the exposed comm is
    ``max(0, comm - eff * comp)`` and the predicted seconds ``comp +
    exposed``.
    """
    t_comp = cm["total_flops"] / _roofline.local_peak(cm["ai_local"], machine)
    if "n_msgs" in cm:
        msgs = cm["n_msgs"]
    else:
        n_msgs = alg.msgs_per_step if alg.msgs_per_step is not None \
            else len(alg.wire)
        msgs = n_msgs * (1.0 if alg.wire_amortized else cm["steps"])
    t_comm = cm["total_net_bytes"] / (machine.net_bw * alg.duplex) \
        + msgs * machine.hop_latency
    eff = _overlap_eff(alg, machine, overlap)
    exposed = max(0.0, t_comm - eff * t_comp)
    return {
        "t_comp": t_comp,
        "t_comm": t_comm,
        "t_comm_exposed": exposed,
        "msgs": float(msgs),
        "duplex": float(alg.duplex),
        "overlap_eff": eff,
        "predicted_s": t_comp + exposed,
    }


def _predicted_time(cm: Dict[str, float], alg: Algorithm,
                    machine: "_roofline.Machine",
                    overlap: str = "auto") -> float:
    """Predicted seconds for one execution — the auto-select score."""
    return _time_breakdown(cm, alg, machine, overlap)["predicted_s"]


def auto_select(a, b, *, machine: Optional["_roofline.Machine"] = None,
                g: Optional[int] = None, allow_pad: bool = False,
                registry: Optional[AlgorithmRegistry] = None,
                output: str = "dense", wire: str = "auto",
                overlap: str = "auto", device=None, _symbolic=None,
                _on_ranks: bool = False
                ) -> Tuple[str, Dict[str, float]]:
    """Score every registered schedule for ``a @ b``; pick the cheapest.

    Returns ``(name, scores)``, ``scores`` mapping every candidate to its
    predicted seconds (:func:`_predicted_time` on its cost model) on
    ``machine`` (default :data:`~repro_torch.core.roofline.H100_SXM`).
    Ties resolve to registration order.  The scores describe the g x g
    grid of devices the schedules are written for, not the stacked
    executor, which moves no tile.  ``output="sparse"`` scores only the
    schedules with a sparse-output body against the symbolic-phase cost
    model; ``wire="packed"`` scores each schedule's packable operands at
    their wire capacities; ``overlap`` feeds the comm-hiding term
    (:func:`_overlap_eff`).
    """
    _check_request("auto", output, wire, overlap, None)
    a_h, b_h = _coerce_pair(a, b, g=g, allow_pad=allow_pad, device=device,
                            on_ranks=_on_ranks)
    machine = machine or _roofline.H100_SXM
    registry = registry or REGISTRY
    wire = _resolve_wire(wire, output)
    if wire == "packed" and not (isinstance(a_h, DistBSR)
                                 or isinstance(b_h, DistBSR)):
        raise ValueError(
            "wire='packed' needs at least one block-sparse (DistBSR) "
            "operand — dense operands have no packable structure; use "
            "wire='padded'")
    sym = None
    candidates = list(registry)
    if output == "sparse":
        reason = _sparse_output_eligible(a_h, b_h)
        if reason:
            raise ValueError(reason)
        sym = _symbolic if _symbolic is not None else _symbolic_for(a_h, b_h)
        candidates = [alg for alg in candidates
                      if alg.sparse_body is not None]
    geom = _geometry(a_h, b_h, impl=None, overlap=overlap == "on",
                     c_store=sym.store_capacity if sym else 0)
    a_key, b_key = a_h.abstract_key(), b_h.abstract_key()
    scores = {}
    for alg in candidates:
        if alg.cost_fn is not None:       # structure-dependent (steal3d)
            cm = alg.cost_fn(alg, geom, a_h, b_h, wire=wire)
        else:
            caps = None
            if wire == "packed":
                packable = ("a", "b") if sym is not None else alg.packable
                caps = _wire_caps_for(a_h, b_h, packable)
                if sym is None and "b" in caps and not _b_pack_wins(b_h):
                    del caps["b"]
            cm = _cost_model(alg, geom, a_key, b_key, symbolic=sym,
                             wire_caps=caps)
        scores[alg.name] = _predicted_time(cm, alg, machine, overlap)
    if not scores:
        raise ValueError("no algorithms registered" if output != "sparse"
                         else "no sparse-output algorithms registered")
    return min(scores, key=scores.get), scores


def _steps_on_device(arrays: Dict[str, np.ndarray], g: int,
                     device: torch.device, rows: slice = slice(None)
                     ) -> list:
    """``[g, g, t, ...]`` plan arrays -> per step t a dict of ``[g*g, ...]``
    tensors on ``device`` (gather maps as int64, lists as int32); ``rows``
    keeps some grid positions only (a rank's own, ``[1, ...]``)."""
    steps = []
    for t in range(g):
        step = {}
        for k, v in arrays.items():
            v = np.ascontiguousarray(v[:, :, t].reshape(g * g, -1)[rows])
            dtype = torch.int64 if "gidx" in k or "dmap" in k \
                else torch.int32
            step[k] = torch.from_numpy(v).to(device=device, dtype=dtype)
        steps.append(step)
    return steps


def _runs_kernel(impl: Optional[str], device: torch.device) -> bool:
    """Whether ``impl`` on ``device`` launches the CUDA kernels."""
    impl = impl or "auto"
    if impl == "auto":
        impl = kops.default_impl(torch.empty(0, device=device))
    return impl == "cuda"


class MatmulPlan:
    """A reusable distributed multiply: placements, geometry, the schedule
    body and its plan-time constants, run on a stacked-grid executor.
    Build with :func:`plan_matmul`; execute with ``plan(a, b)``.

    Sparse-output plans (``symbolic`` set) hold each step's ``[g*g, P]``
    pair lists, scheduled by the algorithm's ``k_order`` (and remapped to
    the packed layout under ``wire="packed"``), plus, where the kernel runs,
    each step's :class:`~repro_torch.kernels.bsr_pair.PairTable` over the
    symbolic phase's real pairs: the lists are plan constants, so their
    work split is built once, here.
    Packed-wire dense-output plans hold each step's consume maps.
    Dense-output plans with a sparse A cache, where the kernel runs, B1's
    work table of each ring step (:meth:`spmm_table`), keyed on A's
    structure and the step's tile maps.  A steal3d plan (``steal`` set)
    holds its :class:`~repro_torch.core.steal3d.StealPlan` and the index
    maps and B1 tables that run it on the stacked executor.

    ``plan.traces`` counts the plan's builds (1) and each build fires the
    :func:`add_trace_hook` hooks, where the JAX package traces its
    executable.  With tracing on (``repro_torch.obs.enable()``) a call
    records a ``multiply.<algorithm>`` span and a drift record.
    """

    def __init__(self, algorithm: Algorithm, geom: _Geom,
                 executor: StackedExecutor, a_key: tuple, b_key: tuple,
                 allow_pad: bool = False, overlap: str = "auto",
                 requested: Optional[str] = None,
                 auto_scores: Optional[Dict[str, float]] = None,
                 symbolic: Optional[SymbolicProduct] = None,
                 wire: str = "padded", packs: Tuple[str, ...] = (),
                 wire_aux: Optional[Dict[str, np.ndarray]] = None,
                 wire_caps: Optional[Dict[str, int]] = None,
                 wire_fps: Optional[Dict[str, str]] = None,
                 steal: Optional["_steal3d.StealPlan"] = None,
                 steal_dev=None, notify: bool = True):
        self.algorithm = algorithm
        self.geom = geom
        self.executor = executor
        # the overlap request ("auto"|"on"|"off"); geom.overlap holds the
        # body structure it resolved to
        self.overlap = overlap
        self._a_key = a_key
        self._b_key = b_key
        self._allow_pad = allow_pad
        # what the request that first built this plan asked for ("auto" or
        # a name) and, if auto ever selected it, the candidates' scores
        self.requested = requested or algorithm.name
        self.auto_scores = auto_scores
        self.symbolic = symbolic
        self.steal = steal
        self._steal = steal_dev
        # which operands ship packed ("a"/"b"), their wire capacities (the
        # cost model's byte terms) and the structure fingerprints their
        # consume maps were built for (the call guard)
        self.wire = wire
        self._packs = packs
        self._wire_caps = wire_caps
        self._wire_fps = wire_fps or {}
        dev = executor.device
        # on a process grid the plan keeps this rank's rows of its lists
        self.on_ranks = isinstance(executor, GroupExecutor)
        mine = slice(executor.position, executor.position + 1) \
            if self.on_ranks else slice(None)
        # a rank plan keeps the host arrays every rank plans alike (the
        # verifier holds the rank's lists to their slice)
        self._host_aux = wire_aux if self.on_ranks else None
        self._host_pairs = None
        if symbolic is not None:
            sched = symbolic.scheduled_pairs(
                algorithm.k_order,
                pair_a=None if wire_aux is None else wire_aux.get("pa"),
                pair_b=None if wire_aux is None else wire_aux.get("pb"))
            real = sched.pop("real")
            # host copy of the mask B2's tables are cut from (the verifier
            # holds it to the device lists)
            self._pair_real = real
            if self.on_ranks:
                self._host_pairs = sched
            self._pairs = _steps_on_device(sched, geom.g, dev, mine)
            if _runs_kernel(geom.impl, dev):
                for t, step in enumerate(self._pairs):
                    step["table"] = pair_table(
                        sched["ps"][:, :, t].reshape(geom.g ** 2, -1)[mine],
                        geom.c_store,
                        real=real[:, :, t].reshape(geom.g ** 2, -1)[mine],
                        device=dev)
            self._c_rows = torch.as_tensor(symbolic.c_rows, device=dev)
            self._c_cols = torch.as_tensor(symbolic.c_cols, device=dev)
            self._c_counts = torch.as_tensor(symbolic.c_counts, device=dev)
        elif wire == "packed" and steal is None:
            self._aux = _steps_on_device(wire_aux, geom.g, dev, mine)
        self._tables = _LRUCache(SPMM_TABLE_CACHE_MAX)
        self._maps: Dict[bytes, torch.Tensor] = {}
        self._validated: set = set()     # static-verifier modes passed
        self.traces = 1
        for hook in list(_TRACE_HOOKS) if notify else ():
            hook(self)

    @property
    def kind(self) -> str:
        """"spmm" | "spgemm" | "dense" — what this plan dispatches to."""
        if self._a_key[0] == "bsr":
            return "spgemm" if self._b_key[0] == "bsr" else "spmm"
        return "dense"

    @property
    def output(self) -> str:
        """"sparse" (returns a DistBSR) or "dense" (returns a tensor)."""
        return "dense" if self.symbolic is None else "sparse"

    def workspace_bytes(self) -> int:
        """Bytes of the kernels' float32 partial workspace over a multiply's
        steps (the largest step's): the pair kernel's of a sparse-output
        plan, B1's of the tables a dense-output plan has built so far."""
        if self.symbolic is None:
            bs = self._a_key[3] if self._a_key[0] == "bsr" else 0
            tables = self._tables.values() if self._steal is None else [
                s["table"] for s in self._steal.segments if "table" in s]
            return max((tab.workspace_bytes(bs, self.geom.tn)
                        for tab in tables), default=0)
        bs = self.symbolic.block_size
        return max((s["table"].workspace_bytes(bs) for s in self._pairs
                    if "table" in s), default=0)

    def step_maps(self) -> list:
        """The schedule's steps as this plan's dense-output body runs them:
        per step, one ``(a_map, b_map)`` per B1 launch (two for
        ``ring_c_bidir``), output tile p reading A tile ``a_map[p]`` and B
        tile ``b_map[p]`` of the placed stacks (a packed B is densified per
        position first, and the launch then reads position p's)."""
        if self.algorithm.step_maps is None:
            raise ValueError(f"algorithm {self.algorithm.name!r} declares no "
                             "step_maps")
        return self.algorithm.step_maps(self.geom, self.executor)

    def validate(self, mode: str = "fast", a=None, b=None) -> None:
        """Statically verify this plan (``repro_torch.analysis``).

        ``mode="fast"`` runs the host-side schedule checker over the
        plan's metadata (ring permutations and the tile maps composed from
        them, steal3d exactly-once + conservation, packed-wire consume-map
        contracts, sparse pair lists, balance perms).  ``mode="full"``
        additionally runs one multiply of ``a @ b`` under the op-trace lint
        (no sort or scatter between the kernel launches of a kernel plan,
        no copy of a placed operand, the executor's shifts equal to the
        cost model's messages, the overlap body's shift order).  Raises
        :class:`repro_torch.analysis.PlanValidationError` on any finding.

        Results are memoized per plan and mode ("full" subsumes "fast"),
        so validating a cached plan is a set lookup.
        """
        if mode == "off":
            return
        if mode not in ("fast", "full"):
            raise ValueError(
                f"unknown validate mode {mode!r} "
                "(expected 'off', 'fast' or 'full')")
        if mode in self._validated:
            return
        from .. import analysis as _analysis
        check, lint = (_analysis.check_rank_plan, _analysis.lint_rank_plan) \
            if self.on_ranks else (_analysis.check_plan, _analysis.lint_plan)
        with _obs.span("plan_build.validate", mode=mode,
                       algorithm=self.algorithm.name):
            # a plan proven "fast" is not checked again on the way to "full"
            findings = [] if "fast" in self._validated \
                else check(self, a, b)
            if mode == "full" and not findings:
                findings = lint(self, a, b)
            if findings:
                raise _analysis.PlanValidationError(findings)
        self._validated.add(mode)
        if mode == "full":
            self._validated.add("fast")   # full subsumes fast

    def stacked_twin(self, a_h: Optional[DistMatrix] = None,
                     b_h: Optional[DistMatrix] = None) -> "MatmulPlan":
        """The stacked plan a rank plan is a slice of, on the host: the
        same schedule, geometry, symbolic phase, steal3d plan and packed
        wire, from the host metadata every rank of the grid plans alike
        (the stacked executor's consume maps where the rank's planner
        differs: ``summa_ag``'s flat pool).  ``a_h`` / ``b_h`` give the
        operands' host structure (a steal3d or packed plan needs it).
        A stacked plan returns itself."""
        if not self.on_ranks:
            return self
        alg, geom = self.algorithm, self.geom
        wire_aux = self._host_aux
        if self.symbolic is None and self.wire == "packed" \
                and self.steal is None \
                and alg.on_ranks.wire_planner is not None:
            wire_aux = alg.wire_planner(
                a_h.packed_operand() if "a" in self._packs else None,
                b_h.packed_operand() if "b" in self._packs else None, geom)
        elif self.symbolic is not None and self.wire == "packed":
            wire_aux = {"pa": _wire.remap_pairs_packed(
                self.symbolic.pair_a, a_h.packed_operand(), "a"),
                "pb": _wire.remap_pairs_packed(
                    self.symbolic.pair_b, b_h.packed_operand(), "b")}
        ex = StackedExecutor(geom.g, torch.device("cpu"))
        steal_dev = None if self.steal is None else _steal_device(
            self.steal, a_h, geom, ex.device, False)
        return MatmulPlan(alg, geom, ex, self._a_key, self._b_key,
                          allow_pad=self._allow_pad, overlap=self.overlap,
                          requested=self.requested, symbolic=self.symbolic,
                          wire=self.wire, packs=self._packs,
                          wire_aux=wire_aux, wire_caps=self._wire_caps,
                          wire_fps=self._wire_fps, steal=self.steal,
                          steal_dev=steal_dev, notify=False)

    def cost_model(self, a: Optional["DistBSR"] = None) -> Dict[str, float]:
        """Per-step volume / flops of one plan execution (per device of the
        g x g grid the schedule is written for), the JAX package's counts:
        stored slots, padding and coverage included.  Pass the sparse
        left-hand handle to also get the paper's Fig-1 per-stage vs
        end-to-end imbalance from its tile counts.  A steal3d plan's is its
        planner's: the LPT makespan's flops and the gather, moved-tile and
        reduce traffic."""
        if self.steal is not None:
            out = dict(self.steal.cost)
        else:
            out = _cost_model(self.algorithm, self.geom, self._a_key,
                              self._b_key, symbolic=self.symbolic,
                              wire_caps=self._wire_caps)
        if isinstance(a, DistBSR):
            per_stage, end_to_end = _schedule.stage_imbalance(
                a.counts.cpu().numpy().astype(np.float64))
            out["per_stage_imbalance"] = per_stage
            out["end_to_end_imbalance"] = end_to_end
        out["duplex"] = float(self.algorithm.duplex)
        out["overlap"] = self.overlap
        return out

    def predicted_cost(self, machine: Optional["_roofline.Machine"] = None
                       ) -> float:
        """Predicted seconds per execution (the ``algorithm="auto"`` score)
        on ``machine`` (default :data:`~repro_torch.core.roofline.
        H100_SXM`)."""
        machine = machine or _roofline.H100_SXM
        return _predicted_time(self.cost_model(), self.algorithm, machine,
                               self.overlap)

    def predicted_perf(self, machine: "_roofline.Machine"
                       ) -> Dict[str, float]:
        """Paper SS4 inter-node roofline prediction for this plan, with the
        alpha-beta-gamma time breakdown under its overlap mode."""
        cm = self.cost_model()
        peak = _roofline.local_peak(cm["ai_local"], machine)
        return {
            "perf": _roofline.internode_roofline(cm["ai_net"],
                                                 cm["ai_local"], machine),
            "local_peak": peak,
            "net_bound": cm["ai_net"] * machine.net_bw < peak,
            **_time_breakdown(cm, self.algorithm, machine, self.overlap),
            **cm,
        }

    def spmm_table(self, a_h: "DistBSR", a_map: np.ndarray,
                   b_map: np.ndarray) -> SpmmTable:
        """B1's work table of one dense-output ring step, in which grid
        position p multiplies the real blocks of placed A tile ``a_map[p]``
        by B tile ``b_map[p]`` (built on the host once, then cached with the
        plan)."""
        lists = a_h.pool_lists(self.algorithm.a_placement,
                               packed="a" in self._packs)
        key = (lists.key, np.asarray(a_map).tobytes(),
               np.asarray(b_map).tobytes())
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = lists.table(
                a_map, b_map, self.geom.a_nbr, device=self.executor.device)
        return table

    def _device_map(self, tile_map: np.ndarray) -> torch.Tensor:
        """A host tile map as an int64 tensor on the executor's device,
        copied once per plan (a copy per step would wait on the card)."""
        key = np.asarray(tile_map).tobytes()
        got = self._maps.get(key)
        if got is None:
            got = self._maps[key] = torch.as_tensor(
                np.asarray(tile_map, dtype=np.int64),
                device=self.executor.device)
        return got

    def __call__(self, a, b):
        # tracing off (the default): straight to the body, no clock read
        # and no synchronisation
        if not _obs.enabled():
            return self._execute(a, b)
        ex = self.executor
        attrs = dict(kind=self.kind, wire=self.wire, output=self.output,
                     overlap=self.overlap)
        if self.on_ranks:
            attrs["rank"] = ex.rank
            ex.barrier()                 # every rank starts the clock here
        t0 = time.perf_counter()
        sp = _obs.span(f"multiply.{self.algorithm.name}", **attrs)
        with sp:
            out = self._execute(a, b)
            measured = _obs.sync_elapsed(t0, _result_tensor(out))
            if self.on_ranks:            # the slowest rank's time
                sp.note(rank_s=measured)
                measured = ex.max_over_ranks(measured)
            sp.note(measured_s=measured)
        if self.on_ranks and ex.position != 0:
            return out                   # position 0 records the drift
        machine = _DRIFT_MACHINE or _roofline.H100_SXM
        cm = self.cost_model()
        _obs.record_drift(
            self.algorithm.name, self.wire, self.overlap,
            predicted_s=_predicted_time(cm, self.algorithm, machine,
                                        self.overlap),
            measured_s=measured, cm=cm, kind=self.kind,
            machine=machine.name)
        return out

    def _execute(self, a, b):
        a_h, b_h = _coerce_pair(a, b, g=self.geom.g,
                                allow_pad=self._allow_pad,
                                device=self._operand_device(),
                                on_ranks=self.on_ranks)
        if (a_h.abstract_key(), b_h.abstract_key()) != (self._a_key,
                                                        self._b_key):
            raise ValueError(
                "operands do not match this plan's abstract shapes "
                f"(plan: {self._a_key} @ {self._b_key}, got "
                f"{a_h.abstract_key()} @ {b_h.abstract_key()}); build a new "
                "plan with plan_matmul")
        if self.on_ranks:
            return self._execute_on_ranks(a_h, b_h)
        body, operands = self._operands(a_h, b_h)
        c = body(*operands, self.geom, self.executor)
        if self.symbolic is not None:
            return self._epilogue_sparse(c, a_h, b_h)
        return self._epilogue(untileize(c), a_h, b_h)

    def _operand_device(self):
        """Where array operands are wrapped: the stacked executor's device,
        or the host on a process grid (each rank loads its tiles)."""
        return torch.device("cpu") if self.on_ranks \
            else self.executor.device

    def _execute_on_ranks(self, a_h: DistMatrix, b_h: DistMatrix):
        """The rank's body on its tiles, then its part of the epilogue: the
        packed C handle on the grid, or the unskewed C tile."""
        ex = self.executor
        ex.reset_counters()
        ex.phase = "body"
        try:
            body, operands = self._operands(a_h, b_h)
            c = body(*operands, self.geom, ex)
            if self.symbolic is not None:
                ex.phase = "structure"
                return self._epilogue_sparse_ranks(c, a_h, b_h)
            if self.algorithm.unskew_out == "rows":
                # tile (i, j) came to rest at (i, (j + i) % g): one
                # exchange within each grid row brings it home
                ex.phase = "epilogue"
                c = _tree_ppermute(ex, {"c": c}, "col", -ex.i)["c"]
            elif self.algorithm.unskew_out is not None:
                raise ValueError(
                    f"unknown unskew_out {self.algorithm.unskew_out!r}")
            return RankTile(c, ex, lambda full: self._epilogue(
                full, a_h, b_h, unskew=False))
        finally:
            ex.phase = "body"

    def _operands(self, a_h: DistMatrix, b_h: DistMatrix):
        """The body to run and its operand trees (plus plan constants),
        after the structure guards of structure-specialized plans; on a
        process grid the rank's bodies and tiles (:func:`_rank_tree`)."""
        alg = self.algorithm
        pl_a, pl_b = alg.a_placement, alg.b_placement
        packed = self.wire == "packed"
        if self.on_ranks:
            bodies = alg.on_ranks
            ex = self.executor

            def tree(h, pl, pk, blocks_only=False):
                return _rank_tree(h, pl, pk, ex, blocks_only)
        else:
            bodies = alg

            def tree(h, pl, pk, blocks_only=False):
                if pk:
                    return h.packed_wire(pl)
                t = h.placed(pl)
                return {"blocks": t["blocks"]} if blocks_only else t
        if self.steal is not None:
            if isinstance(a_h, DistBSR):
                if a_h.structure_key() != self.steal.a_fingerprint:
                    raise ValueError(
                        "left operand's sparsity structure does not match "
                        "this steal3d plan (the LPT assignment and pair "
                        "lists are specialized to the structure); build a "
                        "new plan with plan_matmul")
                a_tree = tree(a_h, pl_a, packed, blocks_only=True)
            else:
                a_tree = tree(a_h, pl_a, False)
            return bodies.body, (a_tree, tree(b_h, pl_b, False), self._steal)
        if self.symbolic is not None:
            sym = self.symbolic
            if (a_h.structure_key(), b_h.structure_key()) != \
                    (sym.a_fingerprint, sym.b_fingerprint):
                raise ValueError(
                    "operands' sparsity structure does not match this "
                    "sparse-output plan (pair lists are specialized to the "
                    "structure); build a new plan with plan_matmul")
            return bodies.sparse_body, (
                tree(a_h, pl_a, packed, blocks_only=True),
                tree(b_h, pl_b, packed, blocks_only=True), self._pairs)
        if packed:
            for who, h in (("a", a_h), ("b", b_h)):
                if who in self._packs \
                        and h.structure_key() != self._wire_fps.get(who):
                    raise ValueError(
                        f"{'left' if who == 'a' else 'right'} operand's "
                        "sparsity structure does not match this packed-wire "
                        "plan (the consume maps are specialized to the "
                        "structure); build a new plan with plan_matmul")
            return bodies.packed_body, (
                tree(a_h, pl_a, "a" in self._packs),
                tree(b_h, pl_b, "b" in self._packs), self._aux,
                self._steps(a_h))
        return bodies.body, (tree(a_h, pl_a, False), tree(b_h, pl_b, False),
                             self._steps(a_h))

    def _steps(self, a_h: DistMatrix):
        kernel = isinstance(a_h, DistBSR) \
            and _runs_kernel(self.geom.impl, self.executor.device)
        if self.on_ranks:
            table = (lambda held, k: self._rank_table(a_h, held, k)) \
                if kernel else None
            return _RankSteps(maps=self.step_maps(), table=table)
        table = (lambda a_map, b_map: self.spmm_table(a_h, a_map, b_map)) \
            if kernel else None
        return _Steps(table=table, device_map=self._device_map)

    def _rank_table(self, a_h: "DistBSR", held: Tuple[int, ...],
                    k: int) -> SpmmTable:
        """B1's table of a rank's launch over its local pool of the placed
        A tiles ``held``, reading pool tile ``k`` (cached with the plan)."""
        lists = a_h.pool_lists(self.algorithm.a_placement,
                               packed="a" in self._packs)
        key = (lists.key, tuple(held), k)
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = lists.take(held).table(
                [k], [0], self.geom.a_nbr, device=self.executor.device)
        return table

    def _epilogue_sparse(self, c_blocks: torch.Tensor, a_h: DistBSR,
                         b_h: DistBSR) -> DistBSR:
        """Wrap the packed numeric result into a DistBSR handle.

        The symbolic layout already satisfies the TiledBSR storage contract
        (row-sorted, coverage-augmented, uniformly padded), so the handle
        is an operand of further multiplies as it is.  Its ``rows``,
        ``cols`` and ``counts`` are the plan's tensors, shared by every
        result of the plan.
        """
        sym = self.symbolic
        tiled = TiledBSR(
            blocks=c_blocks, rows=self._c_rows, cols=self._c_cols,
            counts=self._c_counts, shape=sym.shape,
            block_size=sym.block_size, grid_shape=(sym.g, sym.g),
            capacity=sym.capacity,
            logical_shape=(a_h.logical_shape[0], b_h.logical_shape[1]))
        return DistBSR(tiled)

    def _epilogue_sparse_ranks(self, c_blocks: torch.Tensor, a_h: DistBSR,
                               b_h: DistBSR) -> DistBSR:
        """The rank's packed C tile as a :class:`DistBSR` on the grid.

        Every rank keeps every tile's structure on the host: the symbolic
        layout, and which of its slots hold data, from one all-gather of
        the ranks' block masks (``|block| != 0``, as a stacked result's
        :meth:`TiledBSR.host` reads it), so a chained multiply plans from
        the same structure on every rank."""
        sym, ex = self.symbolic, self.executor
        mask = torch.ne(c_blocks, 0).flatten(-2).any(dim=-1)
        real = ex.gather_grid({"real": mask})["real"].cpu().numpy()
        g, bs = sym.g, sym.block_size
        tiled = TiledBSR(
            blocks=torch.empty((g, g, sym.store_capacity, bs, bs),
                               dtype=c_blocks.dtype, device="meta"),
            rows=torch.as_tensor(sym.c_rows), cols=torch.as_tensor(
                sym.c_cols), counts=torch.as_tensor(sym.c_counts),
            shape=sym.shape, block_size=bs, grid_shape=(g, g),
            capacity=sym.capacity,
            logical_shape=(a_h.logical_shape[0], b_h.logical_shape[1]))
        tiled.host_layout = {"rows": np.asarray(sym.c_rows),
                             "cols": np.asarray(sym.c_cols),
                             "counts": np.asarray(sym.c_counts),
                             "real": real}
        return DistBSR._on_grid(tiled, ex, {"blocks": c_blocks})

    def _epilogue(self, c: torch.Tensor, a_h: DistMatrix,
                  b_h: DistMatrix, unskew: bool = True) -> torch.Tensor:
        """Shared output fix-up: unskew, un-balance, crop padding.

        A rows-balanced left operand permuted its global row blocks before
        tiling and C inherits that order, so it is inverted here (after
        the unskew, before the crop); a cols-balanced right operand
        permuted C's column blocks likewise.
        """
        if not unskew:
            pass                     # the ranks unskewed their tiles
        elif self.algorithm.unskew_out == "rows":
            c = unskew_c_rows(c, self.geom.g)
        elif self.algorithm.unskew_out is not None:
            raise ValueError(
                f"unknown unskew_out {self.algorithm.unskew_out!r}")
        perm = getattr(a_h, "row_block_perm", None)
        if perm:
            bs = a_h.block_size
            c = c.reshape(len(perm), bs, -1)[a_h.inv_row_perm().to(
                c.device)].reshape(c.shape)
        cperm = getattr(b_h, "col_block_perm", None)
        if cperm:
            bs = b_h.block_size
            c = c.reshape(c.shape[0], len(cperm), bs)[
                :, b_h.inv_col_perm().to(c.device)]
            c = c.reshape(c.shape[0], -1)
        return c[:a_h.logical_shape[0], :b_h.logical_shape[1]]


def _plan_matmul_impl(a, b, *, algorithm: str = "ring_c", mesh=None,
                      impl: Optional[str] = None, g: Optional[int] = None,
                      allow_pad: bool = False, cache: bool = True,
                      machine: Optional["_roofline.Machine"] = None,
                      output: str = "dense",
                      sparse_threshold: Optional[float] = None,
                      wire: str = "auto", overlap: str = "auto",
                      device=None, validate: str = "off",
                      assignment=None) -> MatmulPlan:
    """Build (or fetch from the shared cache) a plan for ``a @ b``.

    ``a`` / ``b`` may be :class:`DistMatrix` handles (preferred: placement
    caches live on the handle), :class:`TiledBSR` values, or dense arrays
    (``g`` required when ``a`` is dense); arrays go to ``device``, the card
    by default.  ``impl`` picks the local multiply (``None``/``"auto"``:
    the CUDA kernel on the card, the plain version on the CPU).

    ``mesh`` runs the plan on a process grid, one tile per rank: a
    ``DeviceMesh`` from :func:`~repro_torch.core.dist.make_grid_mesh`
    (every rank builds the same plan; ``device`` is then the rank's compute
    device, the card set for it by default) or a
    :class:`~repro_torch.core.executor.GroupExecutor`.  Each rank loads
    (or, for a product made on the grid, exchanges into place) only its
    own tiles; the host planners run on every rank alike.  A dense result
    is the rank's :class:`RankTile`, a sparse one a :class:`DistBSR` on
    the grid; ``to_global()`` gathers either.  ``None`` (the default) runs
    every tile stacked on one device.

    ``algorithm`` names a registered schedule (:func:`algorithms`), or
    ``"auto"``: :func:`auto_select` scores every registered schedule
    against ``machine`` (default :data:`~repro_torch.core.roofline.
    H100_SXM`) and the cheapest is built; the choice and the scores are
    recorded on the plan (``plan.requested``, ``plan.auto_scores``).

    ``output``: ``"dense"`` returns a cropped dense tensor; ``"sparse"``
    (two DistBSR operands of one block size, unbalanced) returns a
    :class:`DistBSR` from the symbolic phase's layout; ``"auto"`` is sparse
    when the predicted block density of C is at most ``sparse_threshold``
    (default :data:`SPARSE_OUTPUT_DENSITY_THRESHOLD`).  Sparse-output plans
    are specialized to the operands' structure, which joins the cache key.

    ``wire``: ``"padded"`` moves sparse tiles at their stored stride,
    ``"packed"`` only their real blocks (consume maps stay in the plan),
    ``"auto"`` packs sparse-output plans and keeps dense-output plans
    padded.  Packed plans join the cache keyed on the packed operands'
    structures; a plan with nothing to pack stays padded.  steal3d packs
    its A side alone (panel gathers, moved tiles and the partial-C rounds).

    ``overlap="on"`` builds the split-step body (steal3d: its own and
    stolen items as two launches), ``"off"`` the bulk one, and ``"auto"``
    resolves as :func:`_resolve_overlap` says: on a process grid to the
    split step but for steal3d, as the JAX package; stacked to the bulk
    body (there a ride is a tile map, so the split step hides nothing and
    holds one more copy of each operand).  The mode joins the cache key
    and feeds the cost model's comm-hiding credit.

    ``validate`` statically verifies the plan before handing it back
    (:meth:`MatmulPlan.validate`): ``"off"`` (default) skips, ``"fast"``
    runs the host-side schedule checker, ``"full"`` also runs one multiply
    under the op-trace lint.  Verification is memoized per plan, so a cache
    hit revalidates for free; any finding raises
    :class:`repro_torch.analysis.PlanValidationError` with named rule ids,
    and a plan that fails never enters the cache.

    ``assignment`` injects a prebuilt :class:`~repro_torch.core.schedule.
    Assignment3D` into a static-planner schedule (steal3d) in place of the
    plan-time LPT.  It needs an explicit ``algorithm`` with a static
    planner, passes ``validate_assignment``'s checks inside
    ``build_steal_plan``, and bypasses the plan cache both ways (the
    elastic-recovery path, ``repro_torch.runtime.replan``).
    """
    if validate not in ("off", "fast", "full"):
        raise ValueError(f"unknown validate {validate!r}; one of "
                         "('off', 'fast', 'full')")
    if assignment is not None:
        if algorithm == "auto" \
                or REGISTRY.get(algorithm).static_planner is None:
            raise ValueError(
                "assignment= requires an explicit algorithm with a static "
                "planner (steal3d); "
                f"got algorithm={algorithm!r}")
        cache = False
    _check_request(algorithm, output, wire, overlap, impl)
    on_ranks = mesh is not None
    a_h, b_h = _coerce_pair(a, b, g=g, allow_pad=allow_pad,
                            device=torch.device("cpu") if on_ranks
                            else device, on_ranks=on_ranks)
    ex = _prep_mesh(mesh, a_h.g, device)
    if ex is not None:
        validate_mesh(ex, a_h.g, a_h, b_h)
    if (ex.device if on_ranks else a_h.device).type == "cuda":
        strict_fp32()
    if output == "sparse":
        reason = _sparse_output_eligible(a_h, b_h)
        if reason:
            raise ValueError(reason)
    elif output == "auto":
        if sparse_threshold is None:
            sparse_threshold = SPARSE_OUTPUT_DENSITY_THRESHOLD
        can_sparse = algorithm == "auto" \
            or REGISTRY.get(algorithm).sparse_body is not None
        if can_sparse and _sparse_output_eligible(a_h, b_h) is None \
                and _predicted_density_for(a_h, b_h) <= sparse_threshold:
            output = "sparse"
        else:
            output = "dense"
    requested, auto_scores = algorithm, None
    wire = _resolve_wire(wire, output)
    if wire == "packed" and not (isinstance(a_h, DistBSR)
                                 or isinstance(b_h, DistBSR)):
        raise ValueError(
            "wire='packed' needs at least one block-sparse (DistBSR) "
            "operand — dense operands have no packable structure; use "
            "wire='padded'")
    sym = _symbolic_for(a_h, b_h) if output == "sparse" else None
    if algorithm == "auto":
        with _obs.span("plan_build.auto_select"):
            algorithm, auto_scores = auto_select(
                a_h, b_h, machine=machine, allow_pad=allow_pad,
                output=output, wire=wire, overlap=overlap, _symbolic=sym,
                _on_ranks=on_ranks)
    alg = REGISTRY.get(algorithm)
    if on_ranks and alg.on_ranks is None:
        raise ValueError(f"algorithm {algorithm!r} has no bodies for a "
                         "process grid (Algorithm.on_ranks)")
    if sym is not None and alg.sparse_body is None:
        raise ValueError(
            f"algorithm {algorithm!r} has no sparse-output body; one of "
            f"{sparse_algorithms()} (or use output='dense')")
    # which operands ship packed (a plan with none stays padded)
    packs: Tuple[str, ...] = ()
    if wire == "packed":
        if sym is not None:
            packs = ("a", "b")
        elif alg.static_planner is not None:
            # static planners pack the A side only (declared via packable)
            packs = ("a",) if "a" in alg.packable \
                and isinstance(a_h, DistBSR) else ()
        elif alg.packed_body is not None:
            packs = tuple(t for t in alg.packable
                          if isinstance(a_h if t == "a" else b_h, DistBSR))
            if "b" in packs and not _b_pack_wins(b_h):
                # a near-block-dense B is cheaper densified than packed
                packs = tuple(t for t in packs if t != "b")
        if not packs:
            wire = "padded"
    key = (alg.name, impl or "auto", allow_pad, overlap, a_h.abstract_key(),
           b_h.abstract_key())
    if sym is not None:
        # pair lists are plan constants, so the structure is part of the
        # plan's identity, not just its abstract shapes
        key += ("sparse", a_h.structure_key(), b_h.structure_key())
    if alg.static_planner is not None:
        # the LPT assignment (and so the pair lists and rounds) is a
        # function of A's sparsity structure
        key += ("steal", a_h.structure_key()
                if isinstance(a_h, DistBSR) else None)
    if wire == "packed":
        key += ("wire-packed",) + tuple(
            (a_h if t == "a" else b_h).structure_key() for t in packs)
    key += (_mesh_key(ex),)
    if cache:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            if auto_scores is not None and plan.auto_scores is None:
                plan.auto_scores = auto_scores   # record for introspection
            plan.validate(validate, a_h, b_h)
            return plan
    geom = _geometry(a_h, b_h, impl=impl,
                     overlap=_resolve_overlap(alg, overlap, on_ranks),
                     c_store=sym.store_capacity if sym else 0)
    steal = alg.static_planner(a_h, b_h, geom, wire=wire,
                               assignment=assignment) \
        if alg.static_planner is not None else None
    wire_aux = wire_caps = wire_fps = None
    if wire == "packed" and steal is None:
        with _obs.span("plan_build.wire", packs="".join(packs)):
            a_po = a_h.packed_operand() if "a" in packs else None
            b_po = b_h.packed_operand() if "b" in packs else None
            wire_caps = {t: po.wire_capacity for t, po in
                         (("a", a_po), ("b", b_po)) if po is not None}
            wire_fps = {t: po.fingerprint for t, po in
                        (("a", a_po), ("b", b_po)) if po is not None}
            if sym is not None:
                # compose the stored->packed slot maps into the pair lists
                wire_aux = {
                    "pa": _wire.remap_pairs_packed(sym.pair_a, a_po, "a"),
                    "pb": _wire.remap_pairs_packed(sym.pair_b, b_po, "b"),
                }
            else:
                planner = alg.wire_planner
                if on_ranks and alg.on_ranks.wire_planner is not None:
                    planner = alg.on_ranks.wire_planner
                wire_aux = planner(a_po, b_po, geom)
    elif steal is not None and steal.wire == "packed":
        wire_caps = {"a": steal.a_wire_capacity}
    with _obs.span("plan_build.executable", algorithm=alg.name):
        kernel = _runs_kernel(impl, (ex or a_h).device)
        if ex is None:
            ex = StackedExecutor(a_h.g, a_h.device)
            steal_dev = None if steal is None else _steal_device(
                steal, a_h, geom, ex.device, kernel)
        else:
            steal_dev = None if steal is None else _steal_rank(
                steal, geom, ex, kernel)
        plan = MatmulPlan(alg, geom, ex, a_h.abstract_key(),
                          b_h.abstract_key(), allow_pad=allow_pad,
                          overlap=overlap, requested=requested,
                          auto_scores=auto_scores, symbolic=sym, wire=wire,
                          packs=packs, wire_aux=wire_aux,
                          wire_caps=wire_caps, wire_fps=wire_fps,
                          steal=steal, steal_dev=steal_dev)
    plan.validate(validate, a_h, b_h)
    if cache:
        _PLAN_CACHE[key] = plan
    return plan


def plan_matmul(a, b, **kw) -> MatmulPlan:
    sp = _obs.span("plan_build",
                   algorithm=str(kw.get("algorithm", "ring_c")),
                   output=str(kw.get("output", "dense")),
                   wire=str(kw.get("wire", "auto")),
                   overlap=str(kw.get("overlap", "auto")))
    hits0 = _PLAN_CACHE.hits
    with sp:
        plan = _plan_matmul_impl(a, b, **kw)
        sp.note(algorithm=plan.algorithm.name, wire=plan.wire,
                output=plan.output, cached=_PLAN_CACHE.hits > hits0)
    return plan


plan_matmul.__doc__ = _plan_matmul_impl.__doc__


def matmul(a, b, *, algorithm: str = "ring_c", mesh=None,
           impl: Optional[str] = None,
           g: Optional[int] = None, allow_pad: bool = False,
           machine: Optional["_roofline.Machine"] = None,
           output: str = "dense", sparse_threshold: Optional[float] = None,
           wire: str = "auto", overlap: str = "auto", device=None):
    """Distributed ``a @ b`` through the shared plan cache.

    Dispatches sparse x dense -> SpMM, sparse x sparse -> SpGEMM (a dense
    tensor, or with ``output="sparse"|"auto"`` a :class:`DistBSR` that
    chains into further multiplies) and dense x dense -> the dense engine;
    ``algorithm="auto"`` picks the schedule by the cost model; ``mesh``
    runs it on a process grid (see :func:`plan_matmul` for the
    arguments).
    """
    _check_request(algorithm, output, wire, overlap, impl)
    on_ranks = mesh is not None
    a_h, b_h = _coerce_pair(a, b, g=g, allow_pad=allow_pad,
                            device=torch.device("cpu") if on_ranks
                            else device, on_ranks=on_ranks)
    plan = plan_matmul(a_h, b_h, algorithm=algorithm, mesh=mesh, impl=impl,
                       allow_pad=allow_pad, machine=machine, output=output,
                       sparse_threshold=sparse_threshold, wire=wire,
                       overlap=overlap, device=device if on_ranks else None)
    return plan(a_h, b_h)
