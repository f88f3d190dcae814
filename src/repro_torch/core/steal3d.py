"""Static 3D work-grid dispatch: the executable form of work stealing.

Port of ``repro/core/steal3d.py`` (host numpy, bit-identical plans).  The
paper's SS3.4 work stealing lets idle devices claim (i, k, j) work items
from a 2D/3D work grid at run time with remote fetch-and-add.  The
quantity stealing balances (flops per item, known from per-tile block
counts) is static for a given matrix, so the *equilibrium* the paper's
stealing converges to is computed once at plan time
(:func:`repro_torch.core.schedule.assign_3d_lpt`) and turned into the
per-device execution data the ``steal3d`` body (``repro_torch.core.api``)
consumes, for a g x g grid of devices:

* **pools** — every device all-gathers its A grid-row panel and its
  densified B grid-column panel, so any item respecting the locality
  constraint (device in grid row i or grid column j) is one moved tile
  away from executable;
* **move rounds** — for off-owner items, the one missing tile (B[k, j]
  for a row-local thief, A[i, k] for a column-local one) ships in static
  rounds, one per hop distance, with per-device gather indices selecting
  what each source sends (``amk<d>`` / ``bmk<d>``);
* **pair lists** — each device's items flatten into one block-level pair
  list (A pool block, B pool row-chunk, output slot), slot-sorted, with a
  coverage pair per slot and inert zero-block padding to the uniform
  capacity (the LPT makespan is the list length);
* **reduce rounds** — partial C tiles computed off-owner ride static
  rounds back to their owners (``rsend<d>`` / ``csend<d>``, and on the
  packed wire ``*row<d>`` / ``*tgt<d>``).

On the stacked executor the pools, the move rounds and the reduce rounds
are index maps into the placed stacks: no tile moves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .. import obs as _obs
from . import roofline as _roofline
from . import wire as _wire
from .grid import bucket_capacity
from .schedule import Assignment3D, assign_3d_lpt
from .symbolic import extract_structure

__all__ = ["StealPlan", "build_steal_plan", "validate_assignment"]


def validate_assignment(asg: Assignment3D, g: int,
                        cost_ik: Optional[np.ndarray] = None
                        ) -> Assignment3D:
    """Fail fast on an :class:`Assignment3D` that cannot compile.

    The steal3d builder turns the assignment into gather indices and pair
    lists with no further checks, so a hand-built (or elastically
    rebuilt) assignment that breaks the invariants used to surface as
    silently wrong results or shape errors deep in the move-round
    construction.  Checked here, with actionable errors:

    * **shape/range** — ``dev`` is an int grid of shape ``(g, g, g)``
      with every entry a valid device id in ``[0, g*g)``;
    * **exactly-once + locality** — every (i, k, j) item is assigned to
      exactly one device (the dense ``dev`` grid guarantees this by
      construction) that lies in the item's grid row i or grid column j
      (the 3D locality constraint: anything else has no pool panel to
      steal from);
    * **makespan <= owner-computes** — the assignment is no worse than
      not stealing at all, both on the recorded ``makespan`` /
      ``owner_makespan`` fields and, when ``cost_ik`` (real block
      products per (i, k) panel tile, j-independent) is given,
      recomputed from the actual item costs.

    Returns ``asg`` so it can be used inline.  Raises ``ValueError``.
    """
    dev = np.asarray(asg.dev)
    if dev.shape != (g, g, g):
        raise ValueError(
            f"Assignment3D.dev has shape {dev.shape}, expected "
            f"({g}, {g}, {g}) — one device id per (i, k, j) work item")
    if not np.issubdtype(dev.dtype, np.integer):
        raise ValueError(
            f"Assignment3D.dev must hold integer device ids, got dtype "
            f"{dev.dtype}")
    if dev.min() < 0 or dev.max() >= g * g:
        raise ValueError(
            f"Assignment3D.dev holds device ids outside [0, {g * g}) "
            f"(min {int(dev.min())}, max {int(dev.max())}) for a "
            f"{g}x{g} mesh")
    r, c = dev // g, dev % g
    ii = np.arange(g)[:, None, None]
    jj = np.arange(g)[None, None, :]
    bad = np.argwhere((r != ii) & (c != jj))
    if len(bad):
        i, k, j = (int(x) for x in bad[0])
        d = int(dev[i, k, j])
        raise ValueError(
            f"assignment violates the 3D locality constraint: item "
            f"({i},{k},{j}) is assigned to device ({d // g},{d % g}), "
            f"which is in neither grid row {i} nor grid column {j} — it "
            "has no A/B pool panel to execute from; assign items only to "
            "devices in their row or column ("
            f"{len(bad)} violating item(s) total)")
    if asg.makespan > asg.owner_makespan * (1.0 + 1e-9):
        raise ValueError(
            f"assignment records makespan {asg.makespan:.6g} > "
            f"owner-computes makespan {asg.owner_makespan:.6g} — stealing "
            "must never lose to not stealing; fall back to the owner "
            "assignment for these items")
    if cost_ik is not None:
        flops = np.broadcast_to(
            np.asarray(cost_ik, dtype=np.float64)[:, :, None], (g, g, g))
        loads = np.zeros(g * g)
        np.add.at(loads, dev.ravel(), flops.ravel())
        owner = (ii * g + jj) * np.ones((g, g, g), dtype=np.int64)
        owner_loads = np.zeros(g * g)
        np.add.at(owner_loads, owner.ravel(), flops.ravel())
        if float(loads.max()) > float(owner_loads.max()) * (1.0 + 1e-9):
            raise ValueError(
                f"assignment's realized makespan {float(loads.max()):.6g} "
                "(recomputed from the operands' per-item costs) exceeds "
                f"the owner-computes makespan {float(owner_loads.max()):.6g}"
                " — this assignment makes the multiply slower than not "
                "stealing; rebuild it with assign_3d_lpt against the "
                "current cost grid")
    return asg


@dataclasses.dataclass(frozen=True)
class StealPlan:
    """Per-device static execution data for one steal3d dispatch.

    ``aux`` holds the arrays the body consumes, all leading-indexed
    ``[g, g, ...]`` (device-major): ``pa``/``pb``/
    ``ps`` pair lists, ``amk<d>``/``bmk<d>`` per-move-round source gather
    indices, and ``rsend<d>``/``csend<d>`` per-reduce-round output-slot
    selectors.  ``cost`` is the alpha-beta-gamma cost-model dict scored by
    ``algorithm="auto"`` — its flop term is the realized LPT makespan
    (pair capacity), its byte term counts panel gathers, moved tiles and
    owner reductions.
    """
    g: int
    a_kind: str                    # "bsr" | "dense"
    n_out: int                     # output accumulator tiles per device
    n_slots: int                   # packed output slots (n_out * a_nbr)
    pair_capacity: int             # uniform pair-list length (the makespan)
    store_a: int                   # A pool stride per tile (sparse A only)
    b_chunks: int                  # bs-row chunks per B tile (sparse A only)
    a_deltas: Tuple[int, ...]      # A move rounds (hop distances, axr)
    a_move_cap: Tuple[int, ...]    # tiles shipped per A round
    b_deltas: Tuple[int, ...]      # B move rounds (hop distances, axc)
    b_move_cap: Tuple[int, ...]
    row_deltas: Tuple[int, ...]    # C reduce rounds along axc
    col_deltas: Tuple[int, ...]    # C reduce rounds along axr
    aux: Dict[str, np.ndarray]
    assignment: Assignment3D
    a_fingerprint: Optional[str]   # sparse A structure the lists encode
    cost: Dict[str, float]
    wire: str = "padded"           # "padded" | "packed" A-side shipments
    a_wire_capacity: int = 0       # packed panel stride (wire="packed")
    a_round_cap: Tuple[int, ...] = ()
                                   # packed per-move-round real max
                                   # (parallel to ``a_deltas``)
    overlap: bool = False          # two-segment pair lists (see below)


def _item_cost_grid(a_h, g: int) -> Tuple[np.ndarray, Optional[object]]:
    """(cost[i, k], structure) — real block products per (i, k, j) item.

    Every schedule in the engine consumes B as a densified tile, so the
    executed cost of item (i, k, j) is A[i, k]'s *real* stored block count
    for sparse A (j-independent) and uniform for dense A.
    """
    if a_h.kind == "bsr":
        # the handle caches its structural view (shared with fingerprints
        # and the packed wire layout); fall back for raw duck-typed inputs
        sa = a_h.grid_structure() if hasattr(a_h, "grid_structure") \
            else extract_structure(a_h.tiled)
        return sa.real.sum(axis=2).astype(np.float64), sa
    return np.ones((g, g), dtype=np.float64), None


def build_steal_plan(a_h, b_h, geom, *, locality: str = "locality",
                     comm_penalty: float = 1.0,
                     wire: str = "padded",
                     overlap: bool = False,
                     assignment: Optional[Assignment3D] = None
                     ) -> StealPlan:
    """Compile the stealing equilibrium for ``a_h @ b_h`` into a StealPlan.

    ``geom`` is the plan's :class:`repro_torch.core.api._Geom`; handles are
    :class:`DistBSR` / :class:`DistDense` (duck-typed via ``.kind``).

    ``wire="packed"`` (sparse A only) builds the packed-wire variant: the
    A panel gathers at the packed wire capacity, moved-tile rounds slice
    to their own per-move real max (rounds moving only empty tiles are
    dropped outright), pair lists index the flat packed pool, and the
    partial-C reduce rounds ship only the block-rows each sender's items
    can touch.  The LPT assignment — and therefore the executed makespan
    — is identical to the padded plan; only the bytes on the wire shrink.

    ``overlap=True`` additionally splits each device's pair list into two
    segments so the body can overlap the moved-tile rounds with
    compute: segment 0 (``pa0``/``pb0``/``ps0``) holds the *own* items —
    (i, k, j) with i == r and j == c, executable straight off the panel
    gathers — and segment 1 (``pa1``/``pb1``/``ps1``) the stolen items
    that need moved tiles.  Each segment is independently slot-sorted
    with its own coverage pairs (the two partial outputs sum), and
    segment 0's pair indices address the *panel-only* pool (zero block
    appended directly after the g panel tiles).  The assignment, cost
    dict and combined pair lists are identical to the non-overlap build.

    ``assignment`` injects a pre-built :class:`Assignment3D` (elastic
    replanning, experiments) instead of running the LPT; it is validated
    fail-fast by :func:`validate_assignment` — locality, exactly-once,
    makespan <= owner-computes against this operand's actual item costs —
    so a broken hand-built assignment raises an actionable ``ValueError``
    here rather than silently misbehaving downstream.
    """
    g = geom.g
    n_dev = g * g
    tk = a_h.shape[1] // g
    cost_ik, sa = _item_cost_grid(a_h, g)
    sparse_a = sa is not None
    if wire not in ("padded", "packed"):
        raise ValueError(f"unknown wire {wire!r}; one of "
                         "('padded', 'packed')")
    packed = wire == "packed" and sparse_a
    wire = "packed" if packed else "padded"
    n_real_tile = sa.real.sum(axis=2).astype(np.int64) if sparse_a else None
    wc = _wire.wire_capacity(int(n_real_tile.max()),
                             a_h.tiled.store_capacity) if packed else 0
    if assignment is not None:
        asg = validate_assignment(assignment, g, cost_ik=cost_ik)
    else:
        asg = validate_assignment(
            assign_3d_lpt(
                np.broadcast_to(cost_ik[:, :, None], (g, g, g)).copy(), g,
                locality=locality, comm_penalty=comm_penalty),
            g, cost_ik=cost_ik)
    dev = asg.dev

    # ---- per-device item sets and the tiles they need moved --------------
    items = [[] for _ in range(n_dev)]
    for i in range(g):
        for k in range(g):
            for j in range(g):
                items[int(dev[i, k, j])].append((i, k, j))
    row_js, col_is, need_a, need_b = [], [], [], []
    for d in range(n_dev):
        r, c = divmod(d, g)
        rj, ci, na, nb = set(), set(), set(), set()
        for (i, k, j) in items[d]:
            if i == r and j == c:
                continue                                  # own item
            if i == r:                                    # row-local thief
                rj.add(j)
                nb.add((k, j))                            # B[k, j] moves
            elif j == c:                                  # col-local thief
                ci.add(i)
                na.add((i, k))                            # A[i, k] moves
            else:                                         # cannot happen
                raise AssertionError(
                    f"assignment violates the 3D locality constraint: item "
                    f"({i},{k},{j}) on device ({r},{c})")
        row_js.append(sorted(rj))
        col_is.append(sorted(ci))
        need_a.append(sorted(na))
        need_b.append(sorted(nb))

    # ---- move rounds: one per hop distance --------------------------------
    # A tiles move along the mesh ROW axis (source (i, c) owns the A[i, :]
    # panel after the A all-gather); B tiles along the COLUMN axis.
    def _move_rounds(need, src_of, dist_of, panel_k):
        deltas, caps, lists, send = [], [], {}, {}
        for delta in range(1, g):
            per_dev = [[t for t in need[d] if dist_of(d, t) == delta]
                       for d in range(n_dev)]
            cap = max((len(v) for v in per_dev), default=0)
            if not cap:
                continue
            # source-side gather indices: what each source packs for the
            # device `delta` hops downstream of it
            k_src = np.zeros((g, g, cap), dtype=np.int32)
            for d in range(n_dev):
                s = src_of(d, delta)
                for m, t in enumerate(per_dev[d]):
                    k_src[s[0], s[1], m] = panel_k(t)
            deltas.append(delta)
            caps.append(cap)
            lists[delta] = per_dev
            send[delta] = k_src
        return deltas, caps, lists, send

    a_deltas, a_move_cap, a_lists, a_send = _move_rounds(
        need_a,
        src_of=lambda d, delta: ((d // g - delta) % g, d % g),
        dist_of=lambda d, t: (d // g - t[0]) % g,
        panel_k=lambda t: t[1])     # A[i, k]: position k in the row panel
    b_deltas, b_move_cap, b_lists, b_send = _move_rounds(
        need_b,
        src_of=lambda d, delta: (d // g, (d % g - delta) % g),
        dist_of=lambda d, t: (d % g - t[1]) % g,
        panel_k=lambda t: t[0])     # B[k, j]: position k in the col panel

    # packed wire: each A move round is sliced to its own real max (the
    # ROADMAP "moved-tile packing" item); rounds moving only structurally
    # empty tiles vanish — no round, no pool segment, no alpha term.
    a_round_cap = []
    if packed:
        keep, caps = [], []
        for delta, cap in zip(a_deltas, a_move_cap):
            mr = max((int(n_real_tile[t]) for d in range(n_dev)
                      for t in a_lists[delta][d]), default=0)
            if mr == 0:
                continue
            keep.append(delta)
            caps.append(min(wc, bucket_capacity(mr)))
        a_deltas = keep
        a_move_cap = [max(len(a_lists[d_][dd]) for dd in range(n_dev))
                      for d_ in keep]
        a_round_cap = caps
        a_send = {d_: a_send[d_] for d_ in keep}

    # ---- pool tile positions (must mirror the body's concat order) ------
    # padded: tile index into the uniform-stride pool; packed: FLAT block
    # offset (panel tiles at stride wc, each move round at its own stride).
    a_pos = [dict() for _ in range(n_dev)]
    b_pos = [dict() for _ in range(n_dev)]
    for d in range(n_dev):
        r, c = divmod(d, g)
        for k in range(g):
            a_pos[d][(r, k)] = k * wc if packed else k
            b_pos[d][(k, c)] = k                 # B col panel: B[k, c] at k
    if packed:
        base = g * wc
        for delta, cap, rcap in zip(a_deltas, a_move_cap, a_round_cap):
            for d in range(n_dev):
                for m, t in enumerate(a_lists[delta][d]):
                    a_pos[d][t] = base + m * rcap
            base += cap * rcap
        a_flat_zero = base                       # zero block appended after
        a_pool_tiles = 0                         # unused on the packed path
    else:
        base = g
        for delta, cap in zip(a_deltas, a_move_cap):
            for d in range(n_dev):
                for m, t in enumerate(a_lists[delta][d]):
                    a_pos[d][t] = base + m
            base += cap
        a_pool_tiles = base                      # zero tile appended after
    base = g
    for delta, cap in zip(b_deltas, b_move_cap):
        for d in range(n_dev):
            for m, t in enumerate(b_lists[delta][d]):
                b_pos[d][t] = base + m
        base += cap

    # ---- output accumulator layout ---------------------------------------
    n_row_max = max(len(v) for v in row_js)
    n_col_max = max(len(v) for v in col_is)
    dummy = n_row_max + n_col_max > 0    # zero target for idle reduce sends
    n_out = 1 + n_row_max + n_col_max + (1 if dummy else 0)
    out_idx = []
    for d in range(n_dev):
        r, c = divmod(d, g)
        m = {(r, c): 0}
        for t, j in enumerate(row_js[d]):
            m[(r, j)] = 1 + t
        for t, i in enumerate(col_is[d]):
            m[(i, c)] = 1 + n_row_max + t
        out_idx.append(m)
    dummy_idx = n_out - 1

    # ---- reduce rounds: partials ride home, one round per distance -------
    row_deltas = sorted({(j - d % g) % g for d in range(n_dev)
                         for j in row_js[d]})
    col_deltas = sorted({(i - d // g) % g for d in range(n_dev)
                         for i in col_is[d]})
    aux: Dict[str, np.ndarray] = {}
    nbr_a = geom.a_nbr if sparse_a else 1
    if packed:
        # row-packed reduce rounds: a sender's partial C tile can only be
        # nonzero in the block-rows its items' A tiles store, so each
        # round ships [round_cap, bs, tn] instead of the full tile.  The
        # sender-side row gather (``rrow``/``crow``) and the receiver-side
        # target rows (``rtgt``/``ctgt``; the padding lands on the dummy
        # row ``nbr``) are both static; rounds with no real rows vanish.
        out_rows = [dict() for _ in range(n_dev)]
        for d in range(n_dev):
            for (i, k, j) in items[d]:
                sl = np.nonzero(sa.real[i, k])[0]
                if len(sl):
                    out_rows[d].setdefault((i, j), set()).update(
                        sa.rows[i, k][sl].tolist())

        def _packed_round(deltas, out_of, src_of, prefix):
            kept, caps = [], []
            for delta in deltas:
                rows_of = [sorted(out_rows[d].get(out_of(d, delta), ()))
                           for d in range(n_dev)]
                mr = max((len(r_) for r_ in rows_of), default=0)
                if mr == 0:
                    continue
                rcap = min(nbr_a, bucket_capacity(mr))
                row = np.zeros((g, g, rcap), np.int32)
                tgt = np.full((g, g, rcap), nbr_a, np.int32)
                for d in range(n_dev):
                    r, c = divmod(d, g)
                    row[r, c, :len(rows_of[d])] = rows_of[d]
                    src = rows_of[src_of(d, delta)]
                    tgt[r, c, :len(src)] = src
                aux[f"{prefix}row{delta}"] = row
                aux[f"{prefix}tgt{delta}"] = tgt
                kept.append(delta)
                caps.append(rcap)
            return kept, caps

        row_deltas, reduce_row_caps = _packed_round(
            row_deltas,
            out_of=lambda d, delta: (d // g, (d % g + delta) % g),
            src_of=lambda d, delta: (d // g) * g + (d % g - delta) % g,
            prefix="r")
        col_deltas, reduce_col_caps = _packed_round(
            col_deltas,
            out_of=lambda d, delta: ((d // g + delta) % g, d % g),
            src_of=lambda d, delta: ((d // g - delta) % g) * g + d % g,
            prefix="c")
    else:
        reduce_row_caps = reduce_col_caps = []
    for delta in row_deltas:
        sel = np.full((g, g), dummy_idx, dtype=np.int32)
        for d in range(n_dev):
            r, c = divmod(d, g)
            sel[r, c] = out_idx[d].get((r, (c + delta) % g), dummy_idx)
        aux[f"rsend{delta}"] = sel
    for delta in col_deltas:
        sel = np.full((g, g), dummy_idx, dtype=np.int32)
        for d in range(n_dev):
            r, c = divmod(d, g)
            sel[r, c] = out_idx[d].get(((r + delta) % g, c), dummy_idx)
        aux[f"csend{delta}"] = sel
    for delta, arr in a_send.items():
        aux[f"amk{delta}"] = arr
    for delta, arr in b_send.items():
        aux[f"bmk{delta}"] = arr

    # ---- pair lists (symbolic-phase style: slot-sorted + coverage) -------
    bs = a_h.block_size if sparse_a else 0
    nbr = geom.a_nbr if sparse_a else 1
    store_a = a_h.tiled.store_capacity if sparse_a else 0
    b_chunks = tk // bs if sparse_a else 0
    n_slots = n_out * nbr if sparse_a else n_out
    if packed:
        zero_a = a_flat_zero
    else:
        zero_a = a_pool_tiles * store_a if sparse_a else a_pool_tiles

    def _pair_arrays(item_sets, z_a):
        """Slot-sorted pair arrays for a per-device item subset, with
        coverage pairs referencing the zero-A index ``z_a``."""
        per_dev_pairs = []
        for d in range(n_dev):
            pa, pb, ps = [], [], []
            for (i, k, j) in item_sets[d]:
                o = out_idx[d][(i, j)]
                if sparse_a:
                    sl = np.nonzero(sa.real[i, k])[0]
                    if packed and not len(sl):
                        # a structurally empty tile contributes no pairs;
                        # its move round may have been dropped above, so it
                        # has no packed pool position to reference either
                        continue
                    if packed:
                        # packed pool: real blocks are the tile's flat
                        # prefix
                        pa.append(a_pos[d][(i, k)] + np.arange(len(sl)))
                    else:
                        pa.append(a_pos[d][(i, k)] * store_a + sl)
                    pb.append(b_pos[d][(k, j)] * b_chunks
                              + sa.cols[i, k][sl].astype(np.int64))
                    ps.append(o * nbr + sa.rows[i, k][sl].astype(np.int64))
                else:
                    pa.append(np.array([a_pos[d][(i, k)]]))
                    pb.append(np.array([b_pos[d][(k, j)]]))
                    ps.append(np.array([o]))
            pa = np.concatenate(pa) if pa else np.zeros(0, np.int64)
            pb = np.concatenate(pb) if pb else np.zeros(0, np.int64)
            ps = np.concatenate(ps) if ps else np.zeros(0, np.int64)
            if sparse_a:
                # one coverage pair per slot (inert: zero A block), merged
                # in slot order — the kernel's first-visit zeroing contract
                ps_all = np.concatenate([ps, np.arange(n_slots)])
                order = np.argsort(ps_all, kind="stable")
                pa = np.concatenate([pa, np.full(n_slots, z_a)])[order]
                pb = np.concatenate([pb, np.zeros(n_slots, np.int64)])[order]
                ps = ps_all[order]
            else:
                order = np.argsort(ps, kind="stable")
                pa, pb, ps = pa[order], pb[order], ps[order]
            per_dev_pairs.append((pa, pb, ps))
        cap = bucket_capacity(max(len(p[0]) for p in per_dev_pairs))
        pa_arr = np.full((g, g, cap), z_a, dtype=np.int32)
        pb_arr = np.zeros((g, g, cap), dtype=np.int32)
        ps_arr = np.full((g, g, cap), n_slots - 1, dtype=np.int32)
        for d, (pa, pb, ps) in enumerate(per_dev_pairs):
            r, c = divmod(d, g)
            n = len(pa)
            pa_arr[r, c, :n] = pa
            pb_arr[r, c, :n] = pb
            ps_arr[r, c, :n] = ps
        return cap, pa_arr, pb_arr, ps_arr

    pair_cap, pa_arr, pb_arr, ps_arr = _pair_arrays(items, zero_a)
    if overlap:
        # two-segment split: own items run straight off the panel gathers
        # (segment 0, addressing the panel-only pool whose zero block sits
        # right after the g panel tiles), stolen items wait for the moved
        # tiles (segment 1, addressing the full pool as usual)
        own_items, stolen_items = [], []
        for d in range(n_dev):
            r, c = divmod(d, g)
            own_items.append([t for t in items[d]
                              if t[0] == r and t[2] == c])
            stolen_items.append([t for t in items[d]
                                 if not (t[0] == r and t[2] == c)])
        zero0 = g * wc if packed else (g * store_a if sparse_a else g)
        _, aux["pa0"], aux["pb0"], aux["ps0"] = _pair_arrays(own_items,
                                                             zero0)
        _, aux["pa1"], aux["pb1"], aux["ps1"] = _pair_arrays(stolen_items,
                                                             zero_a)
    else:
        aux["pa"], aux["pb"], aux["ps"] = pa_arr, pb_arr, ps_arr

    # ---- cost model (what auto_select scores) ----------------------------
    w_a = a_h.dtype.itemsize
    w_b = b_h.dtype.itemsize
    w_o = geom.out_dtype.itemsize
    if packed:
        # packed A shipments: blocks only, at the wire / per-round strides
        a_tile_bytes = wc * bs * bs * w_a
        a_moved_bytes = sum(cap * rcap for cap, rcap
                            in zip(a_move_cap, a_round_cap)) * bs * bs * w_a
    else:
        a_tile_bytes = store_a * bs * bs * w_a if sparse_a \
            else geom.tm * tk * w_a
        a_moved_bytes = sum(a_move_cap) * a_tile_bytes
    b_tile_bytes = tk * geom.tn * w_b            # B rides densified
    c_tile_bytes = geom.tm * geom.tn * w_o
    gather_bytes = (g - 1) * (a_tile_bytes + b_tile_bytes)
    moved_bytes = a_moved_bytes + sum(b_move_cap) * b_tile_bytes
    if packed:
        reduce_bytes = sum(reduce_row_caps + reduce_col_caps) \
            * bs * geom.tn * w_o
    else:
        reduce_bytes = (len(row_deltas) + len(col_deltas)) * c_tile_bytes
    flops = 2.0 * pair_cap * (bs * bs * geom.tn if sparse_a
                              else geom.tm * tk * geom.tn)
    net_bytes = float(gather_bytes + moved_bytes + reduce_bytes)
    # local traffic at the same granularity as the generic cost model: A
    # blocks stream once per executed pair (the gather), the pooled B
    # panel and the packed C accumulator are touched once
    a_local = pair_cap * (bs * bs if sparse_a else geom.tm * tk) * w_a
    local_bytes = a_local \
        + (g + sum(b_move_cap)) * b_tile_bytes + n_out * c_tile_bytes
    n_msgs = 2 + len(a_deltas) + len(b_deltas) \
        + len(row_deltas) + len(col_deltas)
    cost = {
        "steps": 1.0,
        "flops_per_step": flops,
        "net_bytes_per_step": net_bytes,
        "total_flops": flops,
        "total_net_bytes": net_bytes,
        "ai_net": _roofline.steal3d_internode_ai(
            flops, gather_bytes, moved_bytes, reduce_bytes),
        "ai_local": flops / local_bytes if local_bytes else float("inf"),
        "n_msgs": float(n_msgs),
        "gather_bytes": float(gather_bytes),
        "moved_tile_bytes": float(moved_bytes),
        "reduce_bytes": float(reduce_bytes),
        "lpt_makespan": asg.makespan,
        "owner_makespan": asg.owner_makespan,
        "n_moved_items": float(asg.n_moved),
    }
    # steal3d's stolen-work accounting feeds the process-wide registry:
    # moved-tile bytes are the paper's stealing cost, worth watching as a
    # running total across every plan a serving process builds.
    reg = _obs.registry()
    reg.counter("steal3d.plans_built", wire=wire).inc()
    reg.counter("steal3d.moved_tile_bytes").inc(float(moved_bytes))
    reg.counter("steal3d.moved_items").inc(float(asg.n_moved))
    reg.histogram("steal3d.lpt_makespan").observe(float(asg.makespan))
    return StealPlan(
        g=g, a_kind="bsr" if sparse_a else "dense", n_out=n_out,
        n_slots=n_slots, pair_capacity=pair_cap, store_a=store_a,
        b_chunks=b_chunks, a_deltas=tuple(a_deltas),
        a_move_cap=tuple(a_move_cap), b_deltas=tuple(b_deltas),
        b_move_cap=tuple(b_move_cap), row_deltas=tuple(row_deltas),
        col_deltas=tuple(col_deltas), aux=aux, assignment=asg,
        a_fingerprint=sa.fingerprint if sparse_a else None, cost=cost,
        wire=wire, a_wire_capacity=wc, a_round_cap=tuple(a_round_cap),
        overlap=overlap)
