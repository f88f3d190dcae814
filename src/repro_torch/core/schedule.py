"""Static scheduling (port of ``repro/core/schedule.py``).

The paper's work stealing (SS3.4) claims (i, k, j) work items at run time;
the quantity it balances — flops per item, known from per-tile block
counts — is static for a given matrix, so the equilibrium is computed
ahead of execution:

* :func:`lpt_assign` / :func:`makespan` — the Longest-Processing-Time
  greedy, what the paper's stealing converges to;
* :func:`balance_row_perm` spreads nonzero blocks evenly over grid rows so
  the uniform tile capacity shrinks, :func:`invert_perm` undoes the
  permutation on the output;
* :func:`stage_imbalance` / :func:`stage_imbalance_3d` — the ring's
  per-stage against end-to-end load imbalance (paper Fig. 1);
* :func:`steal_simulation` — the simulated makespan of stationary-A with
  random (2D) or locality-aware (3D) stealing;
* :func:`assign_3d_lpt` -> :class:`Assignment3D` — the executable form of
  that simulation, consumed by ``core/steal3d.py``.

Plain numpy, bit-identical to the JAX package.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "lpt_assign", "makespan", "balance_row_perm", "invert_perm",
    "stage_imbalance", "stage_imbalance_3d", "steal_simulation",
    "Assignment3D", "assign_3d_lpt",
]


def invert_perm(perm: Sequence[int]) -> np.ndarray:
    """Inverse of a permutation: ``invert_perm(p)[p[t]] == t``."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return inv


def lpt_assign(costs: Sequence[float], n_workers: int) -> np.ndarray:
    """Greedy LPT: assign items (descending cost) to the least-loaded worker.

    Returns int array: worker index per item.  4/3-approximation of optimal
    makespan — the static analogue of the paper's workstealing equilibrium.
    """
    costs = np.asarray(costs, dtype=np.float64)
    order = np.argsort(-costs, kind="stable")
    heap = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    assign = np.zeros(len(costs), dtype=np.int64)
    for item in order:
        load, w = heapq.heappop(heap)
        assign[item] = w
        heapq.heappush(heap, (load + costs[item], w))
    return assign


def makespan(costs: Sequence[float], assign: np.ndarray,
             n_workers: int) -> Tuple[float, float]:
    """(max, avg) load over workers for a given assignment."""
    costs = np.asarray(costs, dtype=np.float64)
    loads = np.zeros(n_workers)
    np.add.at(loads, np.asarray(assign), costs)
    return float(loads.max()), float(loads.mean())


def balance_row_perm(nnz_per_row_block: Sequence[int],
                     grid_rows: int) -> np.ndarray:
    """Permute row blocks so each grid row gets a near-equal nnz share.

    Returns a permutation ``perm`` such that row block ``perm[t]`` should be
    placed at position ``t``; every grid row keeps ``n/grid_rows`` row
    blocks.
    """
    nnz = np.asarray(nnz_per_row_block, dtype=np.float64)
    n = len(nnz)
    if n % grid_rows:
        raise ValueError("row blocks must divide evenly among grid rows")
    per = n // grid_rows
    assign = _lpt_capacity(nnz, grid_rows, per)
    # positions [g*per:(g+1)*per] receive the row blocks assigned to grid
    # row g (descending nnz for determinism)
    perm = np.zeros(n, dtype=np.int64)
    for gidx in range(grid_rows):
        mine = np.where(assign == gidx)[0]
        mine = mine[np.argsort(-nnz[mine], kind="stable")]
        perm[gidx * per:(gidx + 1) * per] = mine
    return perm


def _lpt_capacity(costs: np.ndarray, n_workers: int, cap: int) -> np.ndarray:
    """LPT with a per-worker item-count capacity (keeps tiles per row even)."""
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_workers)
    counts = np.zeros(n_workers, dtype=np.int64)
    assign = np.zeros(len(costs), dtype=np.int64)
    for item in order:
        open_w = np.where(counts < cap)[0]
        w = open_w[np.argmin(loads[open_w])]
        assign[item] = w
        loads[w] += costs[item]
        counts[w] += 1
    return assign


def stage_imbalance(tile_costs: np.ndarray) -> Tuple[float, float]:
    """(per_stage, end_to_end) max/avg imbalance of the ring-C schedule.

    ``tile_costs[i, k]`` = flops of using tile A[i, k] (e.g. nnzb counts).
    Device (i, j) at stage t works on A[i, (i + j + t) % g]: per-stage cost
    matrix c_t(i, j) = tile_costs[i, (i+j+t) % g].

    A bulk-synchronous implementation pays sum_t max_devices(c_t); the
    asynchronous one pays max_devices(sum_t c_t).  Both are reported as
    ratios over the average total (paper Fig. 1: ~2.3 vs ~1.2).
    """
    g = tile_costs.shape[0]
    if tile_costs.shape != (g, g):
        raise ValueError(f"tile_costs must be square [g, g], got shape "
                         f"{tile_costs.shape}")
    i = np.arange(g)[:, None]
    j = np.arange(g)[None, :]
    totals = np.zeros((g, g))
    per_stage_max = 0.0
    for t in range(g):
        c_t = tile_costs[i, (i + j + t) % g]
        per_stage_max += c_t.max()
        totals += c_t
    avg_total = totals.mean()
    if avg_total == 0:
        return 1.0, 1.0
    return per_stage_max / avg_total, totals.max() / avg_total


def stage_imbalance_3d(flops_ikj: np.ndarray) -> Tuple[float, float]:
    """(per_stage, end_to_end) imbalance with j-dependent local costs.

    ``flops_ikj[i, k, j]`` = flops of A[i,k] @ B[k,j].  Device (i, j) at
    stage t multiplies k = (i + j + t) % g (the paper's offset).
    """
    g = flops_ikj.shape[0]
    i = np.arange(g)[:, None]
    j = np.arange(g)[None, :]
    totals = np.zeros((g, g))
    per_stage_max = 0.0
    for t in range(g):
        k = (i + j + t) % g
        c_t = flops_ikj[i, k, j]
        per_stage_max += c_t.max()
        totals += c_t
    avg = totals.mean()
    if avg == 0:
        return 1.0, 1.0
    return per_stage_max / avg, totals.max() / avg


def steal_simulation(tile_costs: np.ndarray, steal: str = "none",
                     comm_penalty: float = 0.0) -> float:
    """Simulated end-to-end makespan of stationary-A with work stealing.

    Device (i, k) owns A[i, k] and the g work items (i, k, j) — one per
    output column, each costing ``tile_costs[i, k]`` (the paper's SS3.4
    work grids hand out *column* items; that granularity is what lets an
    idle device absorb part of a hub tile's work instead of all of it).
    ``steal='none'`` = owner computes; ``'random'`` = 2D work grid, any
    idle device may claim any remaining item at ``(1+comm_penalty)`` x
    cost (all three tiles move); ``'locality'`` = 3D grid, items claimable
    only by devices in the owner's grid row/column at ``(1+comm_penalty/3)``
    x cost (one tile moves).  Returns the max/avg load ratio; an all-empty
    ``tile_costs`` (legal for hypersparse operands) is perfectly balanced
    by definition (1.0, not NaN).
    """
    g = tile_costs.shape[0]
    tile = tile_costs.flatten().astype(np.float64)
    n_dev = g * g
    if steal == "none":
        loads = tile * g               # device (i,k) runs its g column items
        return float(loads.max() / loads.mean()) if loads.mean() else 1.0
    # greedy list scheduling over the g^3 column items = idealized
    # stealing equilibrium
    penalty = {"random": 1.0 + comm_penalty,
               "locality": 1.0 + comm_penalty / 3.0}[steal]
    costs = np.repeat(tile, g)         # item (i, k, j) costs tile[i, k]
    owners = np.repeat(np.arange(n_dev), g)
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_dev)
    for item in order:
        own = int(owners[item])
        cost = costs[item]
        if cost == 0.0:
            continue
        if steal == "random":
            w = int(np.argmin(loads))
        else:                          # same grid row/col as the owner
            i, k = divmod(own, g)
            feasible = np.concatenate(
                [i * g + np.arange(g), np.arange(g) * g + k])
            w = int(feasible[np.argmin(loads[feasible])])
        if w == own or loads[own] <= loads[w] + cost * (penalty - 1.0):
            loads[own] += cost
        else:
            loads[w] += cost * penalty
    return float(loads.max() / loads.mean()) if loads.mean() else 1.0


# ---------------------------------------------------------------------------
# Static 3D work-grid assignment (the executable form of steal_simulation)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Assignment3D:
    """A static placement of the (i, k, j) work grid onto a g x g device grid.

    ``dev[i, k, j]`` is the flattened device index ``r * g + c`` executing
    work item (i, k, j) — the block product A[i, k] @ B[k, j] contributing
    to C[i, j].  ``loads`` are the resulting per-device costs *including*
    the off-owner move penalty; ``makespan``/``owner_makespan`` compare the
    assignment against pure owner-computes (device (i, j) runs all its k).
    The invariant ``makespan <= owner_makespan`` always holds
    (:func:`assign_3d_lpt` falls back to owner-computes otherwise).
    """
    dev: np.ndarray            # i64[g, g, g] flattened device per item
    loads: np.ndarray          # f64[g*g] penalized load per device
    makespan: float
    owner_makespan: float
    n_moved: int               # items executed off-owner
    locality: str
    comm_penalty: float

    @property
    def g(self) -> int:
        return self.dev.shape[0]

    def gain(self) -> float:
        """Owner-computes makespan over assigned makespan (>= 1.0)."""
        return self.owner_makespan / self.makespan if self.makespan else 1.0


def assign_3d_lpt(flops_ikj: np.ndarray, grid: int, *,
                  locality: str = "locality", comm_penalty: float = 1.0,
                  max_stolen: Optional[int] = None) -> Assignment3D:
    """Capacity-constrained LPT assignment of the 3D work grid to devices.

    The static realization of the paper's SS3.4 work stealing: instead of
    devices claiming items at runtime with remote fetch-and-add, the same
    greedy equilibrium is computed once at plan time and baked into a
    schedule.  ``flops_ikj[i, k, j]`` is the cost of work item (i, k, j);
    device (i, j) owns it.

    ``locality`` selects the work-grid shape: ``"none"`` is pure
    owner-computes, ``"random"`` the paper's 2D grid (any device may take
    any item, at ``1 + comm_penalty`` x cost — all tiles move) and
    ``"locality"`` the 3D grid (an item is only placeable on devices in
    grid row i or grid column j, at ``1 + comm_penalty / 3`` x cost — one
    tile moves), matching :func:`steal_simulation`'s penalty convention.

    ``max_stolen`` caps how many items a device may take off-owner (the
    capacity constraint — it bounds the static move/pair buffers a
    compiled dispatch must allocate).

    Items are placed in descending cost order on the feasible device that
    minimizes its resulting load, staying with the owner on ties (a
    zero-cost item never moves).  If the greedy result would exceed the
    owner-computes makespan, the owner assignment is returned instead, so
    ``makespan <= owner_makespan`` is an invariant callers may rely on.
    """
    g = int(grid)
    flops = np.asarray(flops_ikj, dtype=np.float64)
    if flops.shape != (g, g, g):
        raise ValueError(f"flops_ikj must be ({g}, {g}, {g}) for a {g}x{g} "
                         f"grid, got {flops.shape}")
    if locality not in ("none", "random", "locality"):
        raise ValueError(f"unknown locality {locality!r}; one of "
                         "('none', 'random', 'locality')")
    ii, kk, jj = np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                             indexing="ij")
    owner = (ii * g + jj).astype(np.int64)
    owner_loads = np.zeros(g * g)
    np.add.at(owner_loads, owner.ravel(), flops.ravel())
    owner_makespan = float(owner_loads.max())

    def _owner_result() -> Assignment3D:
        return Assignment3D(
            dev=owner.copy(), loads=owner_loads.copy(),
            makespan=owner_makespan, owner_makespan=owner_makespan,
            n_moved=0, locality=locality, comm_penalty=comm_penalty)

    if locality == "none":
        return _owner_result()
    penalty = 1.0 + comm_penalty if locality == "random" \
        else 1.0 + comm_penalty / 3.0
    order = np.argsort(-flops.ravel(), kind="stable")
    dev = owner.copy().ravel()
    loads = np.zeros(g * g)
    stolen = np.zeros(g * g, dtype=np.int64)
    items_i, items_j = ii.ravel(), jj.ravel()
    for item in order:
        cost = flops.ravel()[item]
        own = owner.ravel()[item]
        if cost == 0.0:
            continue                       # free items never move
        if locality == "random":
            feasible = np.arange(g * g)
        else:
            i, j = items_i[item], items_j[item]
            feasible = np.concatenate(
                [i * g + np.arange(g), np.arange(g) * g + j])
        if max_stolen is not None:
            feasible = feasible[stolen[feasible] < max_stolen]
        open_w = np.append(feasible, own)  # running your own item never steals
        w = int(open_w[np.argmin(loads[open_w])])
        # stay home unless moving (with penalty) strictly helps the max
        if w == own or loads[own] <= loads[w] + cost * (penalty - 1.0):
            loads[own] += cost
        else:
            dev[item] = w
            loads[w] += cost * penalty
            stolen[w] += 1
    if float(loads.max()) > owner_makespan:
        return _owner_result()             # greedy never beats owner: keep it
    return Assignment3D(
        dev=dev.reshape(g, g, g), loads=loads, makespan=float(loads.max()),
        owner_makespan=owner_makespan,
        n_moved=int((dev != owner.ravel()).sum()), locality=locality,
        comm_penalty=comm_penalty)
