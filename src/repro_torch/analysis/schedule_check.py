"""Schedule check: host-side verification of plan metadata.

Port of ``repro/analysis/schedule_check.py``.  Everything a
:class:`repro_torch.core.api.MatmulPlan` will execute is decided at plan
time: the ring permutations and the tile maps composed from them, the
steal3d assignment, pair lists and move/reduce rounds, the packed wire's
consume maps, the sparse output's pair lists and the balance
permutations.  This pass re-derives the *contracts* those artifacts must
satisfy (independently of the planners that built them) and proves them
before the plan ever runs.

Where the JAX package hands each permutation to ``lax.ppermute``, the
stacked executor composes it into ``[g*g]`` tile maps
(:meth:`~repro_torch.core.executor.StackedExecutor.shift_map`), so the
rules read the maps the bodies really use: the step maps of
:meth:`MatmulPlan.step_maps`, the device copies of the consume maps and
pair lists (``plan._aux``, ``plan._pairs``) and the steal3d index maps
(``plan._steal``).

Rules (stable ids, the JAX package's):

* ``schedule.ppermute-bijection`` — every ring permutation (and every
  steal3d move/reduce delta) is a complete bijection with no self-sends,
  each ring step's tile maps are bijections on ``[0, g*g)`` equal to the
  composition of those permutations, and the steal3d reduce rounds add
  each owner the partial its delta's source computed.
* ``schedule.steal-exactly-once`` — decoding the steal3d pair lists
  against the LPT assignment and A's structure, every (i, k, j) work
  item's real block products are accumulated exactly once across all
  devices/segments, with consistent joins and output slots, and B1's
  tables multiply exactly those products.
* ``schedule.steal-conservation`` — steal3d's moved-tile gather indices,
  reduce-round slot/row selectors and pool layout conserve blocks: every
  needed tile ships, every off-owner partial rides home, inert padding
  references guaranteed-zero pool entries, pair lists stay slot-sorted
  with full coverage.
* ``schedule.wire-contract`` — packed-wire ``pack_idx``/consume
  maps/``slot_map``/``dmap`` satisfy the ``bsr_spmm_raw`` contract (rows
  sorted, every block-row present, real blocks exactly once, inert
  padding proven structurally zero), the per-step maps match the
  algorithm's published tile schedule, and each launch reads the placed
  tile its consume maps were built for.
* ``schedule.sparse-pairs-exactly-once`` — sparse-output pair lists
  accumulate every structural block product exactly once, slot-sorted
  with full coverage, the step->k schedule is a bijection, and the pairs
  the kernel multiplies (``pair_real``) are exactly the listed
  structural products.
* ``schedule.balance-identity`` — balance permutations on the operands
  compose to identity through the epilogue's inverse.
* ``schedule.survivor-coverage`` — a rebuilt steal3d assignment covers
  exactly the surviving grid's work (the elastic-recovery gate).
* ``schedule.rank-slice`` — a plan on a process grid (one tile per rank)
  holds its position's slice of the lists every rank plans alike: its
  pair lists, consume maps and steal3d segments are those rows of the
  host plan, and its kernel tables multiply exactly their real entries.

A plan on a process grid is verified through its stacked twin
(:meth:`~repro_torch.core.api.MatmulPlan.stacked_twin`): the same
schedule built on the host from the metadata every rank plans
identically, checked by every rule above, so its findings are the
stacked plan's finding for finding (:func:`check_rank_plan`); then the
rank's own lists are held to that plan's slice for its position.

A decode failure on corrupted metadata is itself a detection: each rule
converts unexpected decode errors into a finding rather than raising.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from .findings import Finding

_MAX_PER_RULE = 8      # cap repeated findings per rule (keep errors readable)


def _perm_problems(perm, g: int) -> List[str]:
    perm = list(perm)
    out = []
    if len(perm) != g:
        out.append(f"has {len(perm)} pairs for a {g}-device axis")
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if sorted(srcs) != list(range(g)):
        out.append(f"sources {sorted(srcs)} are not a complete cover of "
                   f"0..{g - 1} (a missing source deadlocks the exchange; "
                   "a duplicate sends twice)")
    if sorted(dsts) != list(range(g)):
        out.append(f"destinations {sorted(dsts)} are not a complete cover "
                   f"of 0..{g - 1} (a dropped destination loses a tile)")
    if g > 1 and any(s == d for s, d in perm):
        out.append(f"contains self-sends {[p for p in perm if p[0] == p[1]]}"
                   " (a device must not be its own neighbour on a ring "
                   "of size > 1)")
    return out


_RING_SIGNS = {"ring_c": (1,), "ring_a": (1,), "ring_c_bidir": (1, -1)}


def _ring_perm(g: int, sign: int = 1):
    """The ring ppermute of the JAX bodies, ``(source, destination)``
    pairs: position d receives from ``(d + sign) % g``.  The stacked
    executor runs it as a roll of tile maps
    (:meth:`~repro_torch.core.executor.StackedExecutor.shift_map`); the
    plan's step maps are held to its composition."""
    return [((d + sign) % g, d) for d in range(g)]


def _steal3d_perm(g: int, delta: int):
    """steal3d's move/reduce ppermute for hop ``delta``: position d sends
    to ``(d + delta) % g``; the plan's reduce rounds are held to it."""
    return [(d, (d + delta) % g) for d in range(g)]


def _compose(tile_map: np.ndarray, perm, axis: int, g: int) -> np.ndarray:
    """One ring hop of a ``[g*g]`` tile map along grid ``axis`` (0 rows,
    1 columns) by a ppermute ``perm`` of ``(source, destination)`` pairs:
    the destination's entry becomes the source's.  Entries no pair
    reaches become -1."""
    grid = np.asarray(tile_map).reshape(g, g)
    out = np.full_like(grid, -1)
    for src, dst in perm:
        if axis == 0:
            out[dst, :] = grid[src, :]
        else:
            out[:, dst] = grid[:, src]
    return out.reshape(-1)


def _expected_step_maps(name: str, g: int, ring_perm) -> list:
    """The ring schedules' tile maps, per step one ``(a_map, b_map)`` per
    launch, derived from the ppermute permutations alone: A rides the
    column ring and B the row ring, each position receiving from its
    ``+sign`` neighbour (``ring_a``: B on the row ring, the accumulator's
    position on the column ring, each accumulator taking the product of
    the position that holds it)."""
    ident = np.arange(g * g)
    signs = _RING_SIGNS[name]
    maps = {sign: [(ident, ident)] for sign in signs}
    for sign in signs:
        perm = ring_perm(g, sign)
        for _ in range(1, g):
            a_m, b_m = maps[sign][-1]
            maps[sign].append((_compose(a_m, perm, 1, g),
                               _compose(b_m, perm, 0, g)))
    if name == "ring_a":
        out = []
        for ride, b_pos in maps[1]:
            if (np.sort(ride) != ident).any():
                out.append(((ride, ride),))     # not invertible: flagged
                continue
            at = np.argsort(ride)
            out.append(((at, b_pos[at]),))
        return out
    return [tuple(maps[sign][t] for sign in signs) for t in range(g)]


def _steal_round_sources(sp, g: int, steal_perm) -> list:
    """Per reduce round (row deltas, then column deltas, the port's order),
    the source device of each owner by the ppermute of its delta: the
    device whose send lands on the owner (-1 where none does)."""
    r, c = np.divmod(np.arange(g * g), g)
    out = []
    for axis, deltas in ((1, sp.row_deltas), (0, sp.col_deltas)):
        for delta in deltas:
            src_of = np.full(g, -1)
            for src, dst in steal_perm(g, delta):
                src_of[dst] = src
            sr, sc = (r, src_of[c]) if axis == 1 else (src_of[r], c)
            out.append((axis, delta,
                        np.where((sr >= 0) & (sc >= 0), sr * g + sc, -1)))
    return out


def check_perms(plan, twin=None) -> List[Finding]:
    """schedule.ppermute-bijection over every permutation the plan's body
    composes, the ring schedules' tile maps, and steal3d's reduce rounds
    (a rank plan's, from its stacked ``twin``'s index maps)."""
    rule = "schedule.ppermute-bijection"
    name = plan.algorithm.name
    g = plan.geom.g
    perms: List[Tuple[str, tuple]] = []
    if plan.steal is not None:
        sp = plan.steal
        for what, deltas in (("a_move", sp.a_deltas), ("b_move", sp.b_deltas),
                             ("row_reduce", sp.row_deltas),
                             ("col_reduce", sp.col_deltas)):
            for delta in deltas:
                perms.append((f"steal3d {what} delta={delta}",
                              _steal3d_perm(g, delta)))
    for sign in _RING_SIGNS.get(name, ()):
        perms.append((f"{name} ring sign={sign:+d}",
                      _ring_perm(g, sign)))
    findings = []
    for label, perm in perms:
        for prob in _perm_problems(perm, g):
            findings.append(Finding(
                rule, f"{label} permutation {tuple(perm)} {prob}",
                subject=name))
    if name in _RING_SIGNS and plan.algorithm.step_maps is not None:
        findings += _check_step_maps(plan, _ring_perm)
    rounds = plan if twin is None else twin
    # a rank plan's segments have no index maps: its rounds are read off
    # its twin, which needs the operands
    if plan.steal is not None and hasattr(rounds._steal, "rounds"):
        findings += _check_steal_rounds(rounds, _steal3d_perm)
    return findings


def _check_step_maps(plan, ring_perm) -> List[Finding]:
    rule = "schedule.ppermute-bijection"
    name, g = plan.algorithm.name, plan.geom.g
    ident = np.arange(g * g)
    got = plan.step_maps()
    want = _expected_step_maps(name, g, ring_perm)
    findings = []
    if len(got) != len(want):
        return [Finding(rule, f"the body runs {len(got)} steps, the ring "
                        f"has {len(want)}", subject=name)]
    for t, (launches, expect) in enumerate(zip(got, want)):
        for h, ((a_map, b_map), (a_w, b_w)) in enumerate(zip(launches,
                                                             expect)):
            for who, m, w in (("A", a_map, a_w), ("B", b_map, b_w)):
                m = np.asarray(m)
                if m.shape != (g * g,) or not np.array_equal(np.sort(m),
                                                             ident):
                    findings.append(Finding(
                        rule, f"step {t} launch {h}: the {who} tile map "
                        f"{m.tolist()} is not a bijection on [0, {g * g}) "
                        "— a tile is read twice and another never",
                        subject=f"{name}/step {t}"))
                elif not np.array_equal(m, w):
                    findings.append(Finding(
                        rule, f"step {t} launch {h}: the {who} tile map "
                        f"{m.tolist()} is not the composition of the ring "
                        f"permutations ({np.asarray(w).tolist()}) — the "
                        "step reads tiles the ring would not have "
                        "delivered", subject=f"{name}/step {t}"))
                if len(findings) >= _MAX_PER_RULE:
                    return findings
    return findings


def _check_steal_rounds(plan, steal_perm) -> List[Finding]:
    """Each reduce round of the stacked executor's index maps adds to
    owner d the partial of the device that its delta's ppermute sends
    from."""
    rule = "schedule.ppermute-bijection"
    sp, st, g = plan.steal, plan._steal, plan.geom.g
    want = _steal_round_sources(sp, g, steal_perm)
    if len(want) != len(st.rounds):
        return [Finding(rule, f"steal3d runs {len(st.rounds)} reduce rounds "
                        f"but its plan has {len(want)}", subject="steal3d")]
    findings = []
    for (axis, delta, src), rnd in zip(want, st.rounds):
        if st.packed:
            rows, owner, _ = (x.cpu().numpy() for x in rnd)
            sender = rows // max(plan.geom.a_nbr, 1) // st.n_out
        else:
            owner = np.arange(g * g)
            sender = rnd[0].cpu().numpy() // st.n_out
        if not np.array_equal(sender, src[owner]):
            bad = int(np.argmax(sender != src[owner]))
            findings.append(Finding(
                rule, f"{'row' if axis == 1 else 'col'} reduce round "
                f"delta={delta}: owner {divmod(int(owner[bad]), g)} adds "
                f"the partial of device {divmod(int(sender[bad]), g)}, but "
                f"the delta's ppermute sends it device "
                f"{divmod(int(src[owner[bad]]), g)}'s",
                subject="steal3d"))
    return findings


def check_balance(plan, a_h, b_h) -> List[Finding]:
    """schedule.balance-identity: epilogue inverses undo the perms."""
    findings = []
    for h, who, attr, inv_fn in (
            (a_h, "left", "row_block_perm", "inv_row_perm"),
            (b_h, "right", "col_block_perm", "inv_col_perm")):
        perm = getattr(h, attr, None)
        if not perm:
            continue
        p = np.asarray(perm)
        n = len(p)
        if sorted(p.tolist()) != list(range(n)):
            findings.append(Finding(
                "schedule.balance-identity",
                f"{who} operand's {attr} {tuple(perm)} is not a "
                f"permutation of 0..{n - 1}; the epilogue cannot undo it",
                subject=who))
            continue
        inv = np.asarray(getattr(h, inv_fn)().cpu())
        if not (np.array_equal(p[inv], np.arange(n))
                and np.array_equal(inv[p], np.arange(n))):
            findings.append(Finding(
                "schedule.balance-identity",
                f"{who} operand's {attr} does not compose to identity "
                f"with {inv_fn}() — the epilogue would return permuted "
                "output",
                subject=who))
    return findings


def _host_steps(steps: list, keys, g: int) -> Dict[str, np.ndarray]:
    """The device copies of per-step plan arrays (``[g*g, ...]`` tensors a
    step) as host ``[g, g, t, ...]`` arrays: what the body really reads."""
    out = {}
    for k in keys:
        if all(k in s for s in steps):
            out[k] = np.stack([s[k].cpu().numpy().reshape(g, g, -1)
                               for s in steps], axis=2)
    return out


# ---------------------------------------------------------------------------
# packed-wire contract
# ---------------------------------------------------------------------------
def _check_po_contract(po, sa, who: str) -> List[Finding]:
    """Per-tile PackedOperand contract against the operand structure."""
    findings = []
    g = sa.real.shape[0]
    wc, nbr = po.wire_capacity, po.tile_nbr
    for i in range(g):
        for j in range(g):
            if len(findings) >= _MAX_PER_RULE:
                return findings
            real = np.nonzero(sa.real[i, j])[0]
            nr = len(real)
            pk = po.pack_idx[i, j]
            if not np.array_equal(np.sort(pk[:nr]), real):
                findings.append(Finding(
                    "schedule.wire-contract",
                    f"{who} tile ({i},{j}): pack_idx prefix {pk[:nr]} does "
                    f"not select the tile's {nr} real stored slots "
                    f"{real} exactly once — blocks would ship "
                    "duplicated/dropped",
                    subject=f"{who}[{i},{j}]"))
                continue
            if nr < wc and sa.real[i, j][pk[nr:]].any():
                findings.append(Finding(
                    "schedule.wire-contract",
                    f"{who} tile ({i},{j}): pack_idx padding gathers a "
                    "real stored slot — the inert tail must be "
                    "structurally zero",
                    subject=f"{who}[{i},{j}]"))
            # slot_map: stored -> packed, inert slots -> guaranteed zero
            sm = po.slot_map[i, j]
            for sl in range(sm.shape[0]):
                if sa.real[i, j][sl]:
                    if pk[sm[sl]] != sl:
                        findings.append(Finding(
                            "schedule.wire-contract",
                            f"{who} tile ({i},{j}): slot_map[{sl}] = "
                            f"{sm[sl]} but pack_idx maps that packed slot "
                            f"to stored slot {pk[sm[sl]]} — remapped pair "
                            "lists would read the wrong block",
                            subject=f"{who}[{i},{j}]"))
                        break
                elif sm[sl] < nr:
                    findings.append(Finding(
                        "schedule.wire-contract",
                        f"{who} tile ({i},{j}): inert stored slot {sl} "
                        f"maps to real packed slot {sm[sl]} — padding "
                        "would alias a real block",
                        subject=f"{who}[{i},{j}]"))
                    break
            # consume lists: bsr_spmm_raw(augment=False) contract
            gx, rw, cl = po.gidx[i, j], po.rows[i, j], po.cols[i, j]
            prob = None
            if (np.diff(rw) < 0).any():
                prob = f"consume rows {rw} are not nondecreasing"
            elif set(range(nbr)) - set(rw.tolist()):
                prob = (f"consume rows miss block-rows "
                        f"{sorted(set(range(nbr)) - set(rw.tolist()))} "
                        "(first-visit zeroing skips them)")
            elif gx.min() < 0 or gx.max() >= wc:
                prob = f"gather index out of the packed range [0, {wc})"
            else:
                seen = Counter()
                for m in range(len(gx)):
                    s = int(gx[m])
                    if s < nr:
                        seen[s] += 1
                        if rw[m] != sa.rows[i, j][pk[s]] \
                                or cl[m] != sa.cols[i, j][pk[s]]:
                            prob = (f"consume entry {m} gathers packed "
                                    f"slot {s} (stored {pk[s]}) but "
                                    f"labels it ({rw[m]},{cl[m]}) instead "
                                    f"of ({sa.rows[i, j][pk[s]]},"
                                    f"{sa.cols[i, j][pk[s]]})")
                            break
                if prob is None and (set(seen) != set(range(nr))
                                     or any(v != 1 for v in seen.values())):
                    prob = (f"real packed slots consumed "
                            f"{dict(seen)} times — exactly-once violated")
            if prob:
                findings.append(Finding(
                    "schedule.wire-contract",
                    f"{who} tile ({i},{j}): {prob}",
                    subject=f"{who}[{i},{j}]"))
            # densify-by-gather map
            dm = po.dmap[i, j]
            lookup = {(int(sa.rows[i, j][sl]), int(sa.cols[i, j][sl])): sl
                      for sl in real}
            for p in range(len(dm)):
                br, bc = divmod(p, po.tile_nbc)
                s = int(dm[p])
                if (br, bc) in lookup:
                    if s >= nr or pk[s] != lookup[(br, bc)]:
                        findings.append(Finding(
                            "schedule.wire-contract",
                            f"{who} tile ({i},{j}): dmap[{p}] does not "
                            f"gather the real block at ({br},{bc}) — "
                            "densified tile would drop it",
                            subject=f"{who}[{i},{j}]"))
                        break
                elif s < nr:
                    findings.append(Finding(
                        "schedule.wire-contract",
                        f"{who} tile ({i},{j}): dmap[{p}] gathers real "
                        f"packed slot {s} into an empty dense position "
                        f"({br},{bc}) — densified tile gains a phantom "
                        "block",
                        subject=f"{who}[{i},{j}]"))
                    break
    return findings


def _wire_schedules(alg_name: str, g: int):
    """(a_tiles, a_bwd_tiles, b_tiles) per algorithm: the tile each grid
    position consumes at each step.  The port's ``summa_ag`` reads the
    placed stack in place, so its maps carry no all-gather base offset
    and equal ``summa_bcast``'s."""
    from repro_torch.core import wire as _wire
    tbl = {
        "ring_c": (_wire.tiles_ring_c(g), None, _wire.tiles_ring_c_b(g)),
        "ring_c_bidir": (_wire.tiles_ring_c(g), _wire.tiles_ring_c_bwd(g),
                         None),
        "ring_a": (None, None, _wire.tiles_ring_a_b(g)),
        "summa_ag": (_wire.tiles_summa_a(g), None, _wire.tiles_summa_b(g)),
        "summa_bcast": (_wire.tiles_summa_a(g), None,
                        _wire.tiles_summa_b(g)),
    }
    return tbl.get(alg_name)


def _launch_tiles(plan) -> list:
    """Per step, per launch, the placed tile each grid position's consume
    maps are applied to: ``(A tile of position p, B tile of position p)``
    as indices into the placed stacks (``ring_a``: the position's B, which
    each accumulator reads through ``at``)."""
    out = []
    for launches in plan.step_maps():
        step = []
        for a_map, b_map in launches:
            a_map, b_map = np.asarray(a_map), np.asarray(b_map)
            if plan.algorithm.name == "ring_a":
                # accumulator q reads position at[q]: b_map[q] = b_pos[at[q]]
                b_pos = np.empty_like(b_map)
                b_pos[a_map] = b_map
                step.append((None, b_pos))
            else:
                step.append((a_map, b_map))
        out.append(step)
    return out


def check_wire(plan, a_h, b_h) -> List[Finding]:
    """schedule.wire-contract for packed dense-output plans."""
    from repro_torch.core.dist import placement_tiles
    if plan.wire != "packed" or plan.steal is not None \
            or plan.symbolic is not None:
        return []
    rule = "schedule.wire-contract"
    findings = []
    g = plan.geom.g
    name = plan.algorithm.name
    a_po = a_h.packed_operand() if "a" in plan._packs else None
    b_po = b_h.packed_operand() if "b" in plan._packs else None
    if a_po is not None:
        findings += _check_po_contract(a_po, a_h.grid_structure(), "A")
    if b_po is not None:
        findings += _check_po_contract(b_po, b_h.grid_structure(), "B")
    sched = _wire_schedules(name, g)
    if sched is None:
        return findings
    a_tiles, a_bwd, b_tiles = sched
    keys = [f"a_{k}{s}" for k in ("gidx", "rows", "cols")
            for s in ("", "_bwd")] + ["b_dmap"]
    aux = _host_steps(plan._aux, keys, g)

    pairs = []
    if a_po is not None and a_tiles is not None:
        pairs += [("a_gidx", a_po.gidx, a_tiles),
                  ("a_rows", a_po.rows, a_tiles),
                  ("a_cols", a_po.cols, a_tiles)]
    if a_po is not None and a_bwd is not None:
        pairs += [("a_gidx_bwd", a_po.gidx, a_bwd),
                  ("a_rows_bwd", a_po.rows, a_bwd),
                  ("a_cols_bwd", a_po.cols, a_bwd)]
    if b_po is not None and b_tiles is not None:
        pairs += [("b_dmap", b_po.dmap, b_tiles)]
    for key, arr, tiles in pairs:
        if key not in aux:
            findings.append(Finding(
                rule, f"packed plan is missing consume map {key!r} — the "
                "body cannot reconstruct the shipped tiles", subject=name))
            continue
        want = arr[tiles[..., 0], tiles[..., 1]]
        if aux[key].shape != want.shape \
                or not np.array_equal(aux[key], want):
            bad = np.argwhere(aux[key] != want) \
                if aux[key].shape == want.shape else [(0, 0, 0)]
            i, j, t = bad[0][:3]
            findings.append(Finding(
                rule, f"consume map {key!r} disagrees with the {name} tile "
                f"schedule (first mismatch at device ({i},{j}) step {t}) — "
                "the receiver would reassemble the wrong tile",
                subject=name))
    # each launch must read the placed tile its consume maps describe
    alg = plan.algorithm
    nat = {who: placement_tiles(pl, g).reshape(-1, 2)
           for who, pl in (("a", alg.a_placement), ("b", alg.b_placement))}
    for t, launches in enumerate(_launch_tiles(plan)):
        for h, (a_map, b_map) in enumerate(launches):
            checks = []
            a_sched = a_tiles if h == 0 else a_bwd
            if a_po is not None and a_map is not None and a_sched is not None:
                checks.append(("A", nat["a"][a_map],
                               a_sched[:, :, t].reshape(-1, 2)))
            if b_po is not None and b_tiles is not None:
                checks.append(("B", nat["b"][b_map],
                               b_tiles[:, :, t].reshape(-1, 2)))
            for who, got, want in checks:
                if not np.array_equal(got, want):
                    p = int(np.argmax((got != want).any(axis=1)))
                    findings.append(Finding(
                        rule, f"step {t} launch {h}: position "
                        f"{divmod(p, g)} reads placed {who} tile "
                        f"{tuple(got[p])} through consume maps built for "
                        f"tile {tuple(want[p])}", subject=name))
    return findings


# ---------------------------------------------------------------------------
# sparse-output pair lists
# ---------------------------------------------------------------------------
def _decode_side(po, s_struct, ti: int, tj: int, v: np.ndarray):
    """(real, stored slot) of a vector of operand pair values: a stored
    slot on the padded wire, a packed slot (real below the tile's real
    count) on the packed one."""
    if po is None:
        return s_struct.real[ti, tj][v], v
    return v < int(po.n_real[ti, tj]), po.pack_idx[ti, tj][v].astype(
        np.int64)


def _joins(a_cols, a_slots, b_rows, b_slots, nb: int) -> np.ndarray:
    """Sorted keys ``a_slot * nb + b_slot`` of every structural product of
    two tiles: each real A block with each real B block whose block-row is
    the A block's block-column (a sort-merge join, not a dense match
    matrix: full-width tiles hold tens of thousands of blocks)."""
    oa, ob = np.argsort(a_cols, kind="stable"), np.argsort(b_rows,
                                                          kind="stable")
    ac, asl = a_cols[oa], a_slots[oa].astype(np.int64)
    br_, bsl = b_rows[ob], b_slots[ob].astype(np.int64)
    lo = np.searchsorted(br_, ac, "left")
    n = np.searchsorted(br_, ac, "right") - lo
    first = np.repeat(np.cumsum(n) - n, n)
    idx_b = np.arange(int(n.sum())) - first + np.repeat(lo, n)
    return np.sort(np.repeat(asl, n) * nb + bsl[idx_b])


def _multiplicity(keys: np.ndarray, want: np.ndarray) -> np.ndarray:
    """How many times each entry of ``want`` occurs in ``keys``."""
    have, counts = np.unique(keys, return_counts=True)
    if not len(have):
        return np.zeros(len(want), np.int64)
    idx = np.minimum(np.searchsorted(have, want), len(have) - 1)
    return np.where(have[idx] == want, counts[idx], 0)


def check_sparse_pairs(plan, a_h, b_h) -> List[Finding]:
    """schedule.sparse-pairs-exactly-once over the committed pair lists
    (the device copies the body reads), decoded a list at a time."""
    if plan.symbolic is None:
        return []
    findings: List[Finding] = []
    rule = "schedule.sparse-pairs-exactly-once"
    name = plan.algorithm.name
    sym = plan.symbolic
    g = sym.g
    sa, sb = a_h.grid_structure(), b_h.grid_structure()
    store = sym.store_capacity
    packed = plan.wire == "packed"
    a_po = a_h.packed_operand() if packed else None
    b_po = b_h.packed_operand() if packed else None
    pairs = _host_steps(plan._pairs, ("pa", "pb", "ps"), g)
    listed_real = np.asarray(plan._pair_real)
    k_order = plan.algorithm.k_order
    nb = sb.real.shape[2]

    def add(msg):
        if len(findings) < _MAX_PER_RULE:
            findings.append(Finding(rule, msg, subject=name))

    got: Dict[Tuple[int, int, int], np.ndarray] = {}
    for i in range(g):
        for j in range(g):
            ks = [int(np.asarray(k_order(i, j, t, g))) for t in range(g)]
            if sorted(ks) != list(range(g)):
                add(f"k_order at device ({i},{j}) visits {ks} — not a "
                    "bijection over inner steps, so some k panel is "
                    "consumed twice and another dropped")
                continue
            for t, k in enumerate(ks):
                pa, pb, ps = (pairs[x][i, j, t].astype(np.int64)
                              for x in ("pa", "pb", "ps"))
                if (np.diff(ps) < 0).any():
                    add(f"pair list at device ({i},{j}) step {t} is not "
                        "slot-sorted — first-visit zeroing would reset "
                        "accumulated slots")
                covered = np.zeros(store, dtype=bool)
                covered[ps[(ps >= 0) & (ps < store)]] = True
                missing = np.flatnonzero(~covered).tolist()
                if missing:
                    add(f"pair list at device ({i},{j}) step {t} misses "
                        f"output slots {missing[:4]} — uninitialized slots "
                        "survive first-visit zeroing")
                ar, asl = _decode_side(a_po, sa, i, k, pa)
                br, bsl = _decode_side(b_po, sb, k, j, pb)
                structural = ar & br
                qa = sa.cols[i, k][asl]
                qb = sb.rows[k, j][bsl]
                joined = structural & (qa == qb)
                for p in np.flatnonzero(structural & (qa != qb))[:1]:
                    add(f"device ({i},{j}) k={k}: pair joins A block col "
                        f"{qa[p]} with B block row {qb[p]} — not a "
                        "structural product")
                lands = sym.c_real[i, j][ps] \
                    & (sym.c_rows[i, j][ps] == sa.rows[i, k][asl]) \
                    & (sym.c_cols[i, j][ps] == sb.cols[k, j][bsl])
                for p in np.flatnonzero(joined & ~lands)[:1]:
                    sl = ps[p]
                    add(f"device ({i},{j}) k={k}: real product targets "
                        f"slot {sl} whose layout entry is "
                        f"({sym.c_rows[i, j][sl]},{sym.c_cols[i, j][sl]},"
                        f"real={bool(sym.c_real[i, j][sl])}) — the "
                        "accumulation lands on the wrong output block")
                kernel = listed_real[i, j, t]
                if kernel.shape != structural.shape \
                        or not np.array_equal(kernel, structural):
                    p = int(np.argmax(kernel != structural)) \
                        if kernel.shape == structural.shape else 0
                    add(f"device ({i},{j}) step {t} pair {p}: the kernel's "
                        "real-pair mask disagrees with the structural "
                        "products the lists decode to — B2 would skip a "
                        "real product or multiply a non-product")
                keys = asl[joined] * nb + bsl[joined]
                got[(i, j, k)] = np.concatenate(
                    [got.get((i, j, k), np.zeros(0, np.int64)), keys])

    for i in range(g):
        for j in range(g):
            for k in range(g):
                ra = np.nonzero(sa.real[i, k])[0]
                rb = np.nonzero(sb.real[k, j])[0]
                want = _joins(sa.cols[i, k][ra], ra, sb.rows[k, j][rb], rb,
                              nb)
                keys = got.get((i, j, k), np.zeros(0, np.int64))
                n_got = _multiplicity(keys, want)
                for w in np.flatnonzero(n_got != 1)[:1]:
                    asl, bsl = divmod(int(want[w]), nb)
                    add(f"structural product A[{i},{k}] slot {asl} x "
                        f"B[{k},{j}] slot {bsl} is accumulated "
                        f"{int(n_got[w])} time(s) instead of exactly once on "
                        f"device ({i},{j})")
                extra = np.setdiff1d(keys, want)
                for key in extra[:1]:
                    asl, bsl = divmod(int(key), nb)
                    add(f"pair list accumulates A[{i},{k}] slot {asl} x "
                        f"B[{k},{j}] slot {bsl}, which is not a structural "
                        "product — spurious accumulation")
    return findings


# ---------------------------------------------------------------------------
# steal3d: exactly-once accumulation + conservation
# ---------------------------------------------------------------------------
def _steal_layout(sp, sa):
    """Re-derive the deterministic pool/output layout the builder
    documents (items from the assignment, sorted need lists, pool
    positions, out_idx) — the decode frame the pair lists are checked
    against."""
    g = sp.g
    n_dev = g * g
    dev = np.asarray(sp.assignment.dev)
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
                continue
            if i == r:
                rj.add(j)
                nb.add((k, j))
            elif j == c:
                ci.add(i)
                na.add((i, k))
        row_js.append(sorted(rj))
        col_is.append(sorted(ci))
        need_a.append(sorted(na))
        need_b.append(sorted(nb))
    a_lists = {delta: [[t for t in need_a[d]
                        if (d // g - t[0]) % g == delta]
                       for d in range(n_dev)] for delta in sp.a_deltas}
    b_lists = {delta: [[t for t in need_b[d]
                        if (d % g - t[1]) % g == delta]
                       for d in range(n_dev)] for delta in sp.b_deltas}
    packed = sp.wire == "packed"
    wc = sp.a_wire_capacity
    a_pos = [dict() for _ in range(n_dev)]
    b_pos = [dict() for _ in range(n_dev)]
    for d in range(n_dev):
        r, c = divmod(d, g)
        for k in range(g):
            a_pos[d][(r, k)] = k * wc if packed else k
            b_pos[d][(k, c)] = k
    if packed:
        base = g * wc
        for delta, cap, rcap in zip(sp.a_deltas, sp.a_move_cap,
                                    sp.a_round_cap):
            for d in range(n_dev):
                for m, t in enumerate(a_lists[delta][d]):
                    a_pos[d][t] = base + m * rcap
            base += cap * rcap
        a_zero, a_pool_tiles = base, 0
    else:
        base = g
        for delta, cap in zip(sp.a_deltas, sp.a_move_cap):
            for d in range(n_dev):
                for m, t in enumerate(a_lists[delta][d]):
                    a_pos[d][t] = base + m
            base += cap
        a_pool_tiles = base
        a_zero = base * sp.store_a if sp.a_kind == "bsr" else base
    base = g
    for delta, cap in zip(sp.b_deltas, sp.b_move_cap):
        for d in range(n_dev):
            for m, t in enumerate(b_lists[delta][d]):
                b_pos[d][t] = base + m
        base += cap
    n_row_max = max(len(v) for v in row_js)
    out_idx = []
    for d in range(n_dev):
        r, c = divmod(d, g)
        m = {(r, c): 0}
        for t, j in enumerate(row_js[d]):
            m[(r, j)] = 1 + t
        for t, i in enumerate(col_is[d]):
            m[(i, c)] = 1 + n_row_max + t
        out_idx.append(m)
    out_rows = [dict() for _ in range(n_dev)]
    if sa is not None:
        for d in range(n_dev):
            for (i, k, j) in items[d]:
                sl = np.nonzero(sa.real[i, k])[0]
                if len(sl):
                    out_rows[d].setdefault((i, j), set()).update(
                        sa.rows[i, k][sl].tolist())
    return dict(items=items, need_a=need_a, need_b=need_b,
                a_lists=a_lists, b_lists=b_lists, a_pos=a_pos, b_pos=b_pos,
                a_zero=a_zero, a_pool_tiles=a_pool_tiles, out_idx=out_idx,
                out_rows=out_rows, dev=dev)


def _decode_steal_pairs(sp, sa, lay, aux, seg, findings):
    """Decode one pair-list segment into a multiset of executed products.

    ``seg`` is ("", full-pool) for bulk plans, ("0", panel-pool) /
    ("1", full-pool) for overlap plans.  Returns Counter of
    (i, k, j, stored_slot) — stored_slot is 0 for dense A.
    """
    suffix, panel_only = seg
    g = sp.g
    packed = sp.wire == "packed"
    sparse_a = sp.a_kind == "bsr"
    wc = sp.a_wire_capacity
    nbr = sa.tile_nbr if sparse_a else 1
    pa_arr = aux[f"pa{suffix}"]
    pb_arr = aux[f"pb{suffix}"]
    ps_arr = aux[f"ps{suffix}"]
    if panel_only:
        a_zero = g * wc if packed else (
            g * sp.store_a if sparse_a else g)
    else:
        a_zero = lay["a_zero"]
    # flat packed intervals: (base, stride, tile) in base order
    intervals = []
    if packed:
        for k in range(g):
            intervals.append((k * wc, wc, None, k))   # panel: tile (r, k)
        if not panel_only:
            base = g * wc
            for delta, cap, rcap in zip(sp.a_deltas, sp.a_move_cap,
                                        sp.a_round_cap):
                intervals.append((base, rcap, delta, None))
                base += cap * rcap
    got: Counter = Counter()
    inv_out = [{o: key for key, o in lay["out_idx"][d].items()}
               for d in range(g * g)]
    inv_b = [{pos: t for t, pos in lay["b_pos"][d].items()}
             for d in range(g * g)]
    inv_a = [{pos: t for t, pos in lay["a_pos"][d].items()}
             for d in range(g * g)]
    for d in range(g * g):
        r, c = divmod(d, g)
        ps_dev = ps_arr[r, c]
        if sparse_a and (np.diff(ps_dev) < 0).any():
            findings.append(Finding(
                "schedule.steal-conservation",
                f"device ({r},{c}) pair list (segment {suffix or 'bulk'}) "
                "is not slot-sorted — first-visit zeroing would reset "
                "accumulated slots",
                subject="steal3d"))
        if sparse_a and set(range(sp.n_slots)) - set(ps_dev.tolist()):
            findings.append(Finding(
                "schedule.steal-conservation",
                f"device ({r},{c}) pair list (segment {suffix or 'bulk'}) "
                "misses output slots — uninitialized accumulator slots "
                "survive first-visit zeroing",
                subject="steal3d"))
        for p in range(pa_arr.shape[2]):
            va = int(pa_arr[r, c, p])
            if va == a_zero:
                continue                       # inert coverage/padding
            # --- decode the A side to (tile, stored slot) ---
            if packed:
                tile = off = None
                for base, stride, delta, k in intervals:
                    span = stride * (1 if k is not None else
                                     len(lay["a_lists"][delta][d]) or 1)
                    if k is not None:
                        lo, hi = base, base + stride
                        if lo <= va < hi:
                            tile, off = (r, k), va - lo
                            break
                    else:
                        lst = lay["a_lists"][delta][d]
                        lo, hi = base, base + stride * len(lst)
                        if lo <= va < hi and lst:
                            m, off = divmod(va - lo, stride)
                            tile = lst[m]
                            break
                if tile is None:
                    findings.append(Finding(
                        "schedule.steal-exactly-once",
                        f"device ({r},{c}) pair {p}: packed pool index "
                        f"{va} addresses no gathered or moved tile — "
                        "reads junk as real work",
                        subject="steal3d"))
                    continue
                i, k_a = tile
                nz = np.nonzero(sa.real[i, k_a])[0]
                if off >= len(nz):
                    continue                   # packed zero tail: inert
                stored = int(nz[off])
            elif sparse_a:
                pos, stored = divmod(va, sp.store_a)
                if pos not in inv_a[d] or (panel_only and pos >= g):
                    findings.append(Finding(
                        "schedule.steal-exactly-once",
                        f"device ({r},{c}) pair {p}: pool position {pos} "
                        "addresses no gathered or moved tile — reads "
                        "junk as real work",
                        subject="steal3d"))
                    continue
                i, k_a = inv_a[d][pos]
                if not sa.real[i, k_a][stored]:
                    continue                   # structurally zero: inert
            else:
                if va not in inv_a[d] or (panel_only and va >= g):
                    findings.append(Finding(
                        "schedule.steal-exactly-once",
                        f"device ({r},{c}) pair {p}: pool position {va} "
                        "addresses no gathered or moved tile",
                        subject="steal3d"))
                    continue
                i, k_a = inv_a[d][va]
                stored = 0
            # --- decode output slot and B chunk; check the join ---
            vs = int(ps_arr[r, c, p])
            vb = int(pb_arr[r, c, p])
            o, rhat = divmod(vs, nbr) if sparse_a else (vs, 0)
            if o not in inv_out[d]:
                findings.append(Finding(
                    "schedule.steal-exactly-once",
                    f"device ({r},{c}) pair {p}: output slot {o} maps to "
                    "no (i, j) accumulator on this device",
                    subject="steal3d"))
                continue
            oi, oj = inv_out[d][o]
            bpos, q = divmod(vb, sp.b_chunks) if sparse_a else (vb, 0)
            if bpos not in inv_b[d]:
                findings.append(Finding(
                    "schedule.steal-exactly-once",
                    f"device ({r},{c}) pair {p}: B pool position {bpos} "
                    "addresses no gathered or moved B tile",
                    subject="steal3d"))
                continue
            bk, bj = inv_b[d][bpos]
            ok = (oi == i and bj == oj and bk == k_a)
            if sparse_a:
                ok = ok and q == int(sa.cols[i, k_a][stored]) \
                    and rhat == int(sa.rows[i, k_a][stored])
            if not ok:
                findings.append(Finding(
                    "schedule.steal-exactly-once",
                    f"device ({r},{c}) pair {p}: inconsistent join — A "
                    f"block ({i},{k_a}) slot {stored} paired with B tile "
                    f"({bk},{bj}) chunk {q} into output ({oi},{oj}) row "
                    f"{rhat}",
                    subject="steal3d"))
                continue
            item = (i, k_a, oj)
            if panel_only is not None and suffix == "0" \
                    and not (i == r and oj == c):
                findings.append(Finding(
                    "schedule.steal-conservation",
                    f"device ({r},{c}): stolen item {item} scheduled in "
                    "the own-items segment — it would execute before its "
                    "moved tile arrives",
                    subject="steal3d"))
            if suffix == "1" and (i == r and oj == c):
                findings.append(Finding(
                    "schedule.steal-conservation",
                    f"device ({r},{c}): own item {item} scheduled in the "
                    "stolen segment — serialized behind the move rounds "
                    "for no reason",
                    subject="steal3d"))
            if int(lay["dev"][i, k_a, oj]) != d:
                findings.append(Finding(
                    "schedule.steal-exactly-once",
                    f"item {item} executes on device ({r},{c}) but the "
                    f"assignment placed it on device "
                    f"{divmod(int(lay['dev'][i, k_a, oj]), g)}",
                    subject="steal3d"))
            got[item + (stored,)] += 1
            if len(findings) >= _MAX_PER_RULE:
                return got
    return got


def check_steal(plan, a_h) -> List[Finding]:
    """steal3d exactly-once + conservation over the plan's aux arrays."""
    if plan.steal is None:
        return []
    sp = plan.steal
    g = sp.g
    n_dev = g * g
    sparse_a = sp.a_kind == "bsr"
    sa = a_h.grid_structure() if sparse_a else None
    findings: List[Finding] = []
    lay = _steal_layout(sp, sa)
    aux = sp.aux

    # -- exactly-once: decode every segment, compare against the assignment
    segs = [("0", True), ("1", False)] if sp.overlap else [("", False)]
    got: Counter = Counter()
    for seg in segs:
        got += _decode_steal_pairs(sp, sa, lay, aux, seg, findings)
    want: Counter = Counter()
    for i in range(g):
        for k in range(g):
            for j in range(g):
                if sparse_a:
                    for sl in np.nonzero(sa.real[i, k])[0]:
                        want[(i, k, j, int(sl))] += 1
                else:
                    want[(i, k, j, 0)] += 1
    for key, n in want.items():
        if got.get(key, 0) != n and len(findings) < _MAX_PER_RULE:
            i, k, j, sl = key
            findings.append(Finding(
                "schedule.steal-exactly-once",
                f"work item ({i},{k},{j}) stored slot {sl} is accumulated "
                f"{got.get(key, 0)} time(s) across all devices instead of "
                "exactly once — the result would be "
                f"{'missing' if got.get(key, 0) == 0 else 'double-counted'}"
                " this block product",
                subject="steal3d"))
    for key in got:
        if key not in want and len(findings) < _MAX_PER_RULE:
            findings.append(Finding(
                "schedule.steal-exactly-once",
                f"pair lists accumulate {key[:3]} stored slot {key[3]}, "
                "which is not real structural work",
                subject="steal3d"))

    # -- the stacked executor's lists: B1 multiplies exactly those products
    st = plan._steal
    if sparse_a and st is not None:
        n_want = sum(want.values())
        for s, seg in enumerate(st.segments):
            table = seg.get("table")
            if table is not None and table.real_blocks != int(
                    seg["real"].sum()):
                findings.append(Finding(
                    "schedule.steal-exactly-once",
                    f"segment {s}: B1's table multiplies "
                    f"{table.real_blocks} blocks but the segment lists "
                    f"{int(seg['real'].sum())} real pairs",
                    subject="steal3d"))
        if st.real_pairs != n_want:
            findings.append(Finding(
                "schedule.steal-exactly-once",
                f"the stacked executor's pair lists hold {st.real_pairs} "
                f"real pairs, but the work grid has {n_want} real block "
                "products — B1 would skip or repeat some",
                subject="steal3d"))

    # -- conservation: move rounds ship exactly the needed tiles ----------
    n_real_tile = sa.real.sum(axis=2) if sparse_a else None
    for d in range(n_dev):
        for t in lay["need_a"][d]:
            delta = (d // g - t[0]) % g
            if delta not in sp.a_deltas and not (
                    sp.wire == "packed" and int(n_real_tile[t]) == 0):
                findings.append(Finding(
                    "schedule.steal-conservation",
                    f"device {divmod(d, g)} needs moved A tile {t} at hop "
                    f"{delta} but no such move round exists — the item "
                    "would compute on a stale pool slot",
                    subject="steal3d"))
        for t in lay["need_b"][d]:
            delta = (d % g - t[1]) % g
            if delta not in sp.b_deltas:
                findings.append(Finding(
                    "schedule.steal-conservation",
                    f"device {divmod(d, g)} needs moved B tile {t} at hop "
                    f"{delta} but no such move round exists",
                    subject="steal3d"))
    for delta in sp.a_deltas:
        arr = aux[f"amk{delta}"]
        for d in range(n_dev):
            s = ((d // g - delta) % g, d % g)
            for m, t in enumerate(lay["a_lists"][delta][d]):
                if int(arr[s[0], s[1], m]) != t[1]:
                    findings.append(Finding(
                        "schedule.steal-conservation",
                        f"A move round delta={delta}: source {s} packs "
                        f"panel position {int(arr[s[0], s[1], m])} into "
                        f"lane {m} but receiver {divmod(d, g)} expects "
                        f"tile {t} (panel position {t[1]}) — the thief "
                        "computes with the wrong tile",
                        subject="steal3d"))
                    break
    for delta in sp.b_deltas:
        arr = aux[f"bmk{delta}"]
        for d in range(n_dev):
            s = (d // g, (d % g - delta) % g)
            for m, t in enumerate(lay["b_lists"][delta][d]):
                if int(arr[s[0], s[1], m]) != t[0]:
                    findings.append(Finding(
                        "schedule.steal-conservation",
                        f"B move round delta={delta}: source {s} packs "
                        f"panel position {int(arr[s[0], s[1], m])} into "
                        f"lane {m} but receiver {divmod(d, g)} expects "
                        f"tile {t} (panel position {t[0]})",
                        subject="steal3d"))
                    break

    # -- conservation: every off-owner partial rides home -----------------
    dummy_idx = sp.n_out - 1
    packed = sp.wire == "packed"
    for d in range(n_dev):
        r, c = divmod(d, g)
        for (i, j), o in lay["out_idx"][d].items():
            if o == 0:
                continue
            if i == r:
                delta, deltas, what = (j - c) % g, sp.row_deltas, "row"
            else:
                delta, deltas, what = (i - r) % g, sp.col_deltas, "col"
            if delta not in deltas and not (
                    packed and not lay["out_rows"][d].get((i, j))):
                findings.append(Finding(
                    "schedule.steal-conservation",
                    f"device ({r},{c}) computes a partial for output tile "
                    f"({i},{j}) but no {what} reduce round at hop {delta} "
                    "exists — the partial never rides home",
                    subject="steal3d"))
    for deltas, key_of, prefix in (
            (sp.row_deltas, lambda r, c, delta: (r, (c + delta) % g), "r"),
            (sp.col_deltas, lambda r, c, delta: ((r + delta) % g, c), "c")):
        for delta in deltas:
            sel = aux[f"{prefix}send{delta}"]
            for d in range(n_dev):
                r, c = divmod(d, g)
                want_o = lay["out_idx"][d].get(key_of(r, c, delta),
                                               dummy_idx)
                if int(sel[r, c]) != want_o:
                    findings.append(Finding(
                        "schedule.steal-conservation",
                        f"{prefix}send{delta}[{r},{c}] selects output "
                        f"slot {int(sel[r, c])} but device ({r},{c})'s "
                        f"partial for that round lives in slot {want_o} — "
                        "the wrong partial (or junk) rides home",
                        subject="steal3d"))
    if packed:
        nbr = sa.tile_nbr
        for deltas, out_of, src_of, prefix in (
                (sp.row_deltas,
                 lambda d, delta: (d // g, (d % g + delta) % g),
                 lambda d, delta: (d // g) * g + (d % g - delta) % g, "r"),
                (sp.col_deltas,
                 lambda d, delta: ((d // g + delta) % g, d % g),
                 lambda d, delta: ((d // g - delta) % g) * g + d % g, "c")):
            for delta in deltas:
                row = aux[f"{prefix}row{delta}"]
                tgt = aux[f"{prefix}tgt{delta}"]
                rows_of = [sorted(lay["out_rows"][d].get(
                    out_of(d, delta), ())) for d in range(n_dev)]
                for d in range(n_dev):
                    r, c = divmod(d, g)
                    mine = rows_of[d]
                    src = rows_of[src_of(d, delta)]
                    ok = list(row[r, c, :len(mine)]) == mine \
                        and list(tgt[r, c, :len(src)]) == src \
                        and (tgt[r, c, len(src):] == nbr).all()
                    if not ok:
                        findings.append(Finding(
                            "schedule.steal-conservation",
                            f"packed reduce round {prefix}{delta} at "
                            f"device ({r},{c}): shipped rows "
                            f"{list(row[r, c])} / targets "
                            f"{list(tgt[r, c])} disagree with the "
                            f"partial's touched rows {mine} (receiver "
                            f"expects {src}; padding must land on the "
                            f"dummy row {nbr})",
                            subject="steal3d"))
                        break
    return findings


def check_survivor_coverage(assignment, g: int,
                            survivors=None) -> List[Finding]:
    """``schedule.survivor-coverage``: a rebuilt assignment matches the
    surviving mesh.

    The elastic-recovery gate (``repro_torch.runtime.replan``): after
    device loss, the steal3d :class:`~repro_torch.core.schedule.
    Assignment3D` is
    rebuilt for a shrunken ``g x g`` grid.  This rule proves the rebuilt
    assignment covers *exactly* that grid's work: the work grid has the
    new shape, every (i, k, j) item is assigned (no ``-1`` holes), every
    referenced device id is a live position of the new mesh (``[0,
    g^2)``), and — when the surviving device collection is given — the
    new grid actually fits on it.  Locality/makespan invariants stay with
    ``validate_assignment``; this is purely the coverage contract.
    """
    rule = "schedule.survivor-coverage"
    findings: List[Finding] = []
    dev = np.asarray(assignment.dev if hasattr(assignment, "dev")
                     else assignment)
    if dev.shape != (g, g, g):
        return [Finding(rule,
                        f"assignment work grid has shape {dev.shape}, "
                        f"expected {(g, g, g)} for the surviving "
                        f"{g}x{g} mesh", subject="steal3d")]
    if not np.issubdtype(dev.dtype, np.integer):
        return [Finding(rule,
                        f"assignment device ids must be integers, got "
                        f"dtype {dev.dtype}", subject="steal3d")]
    if survivors is not None:
        n_surv = survivors if isinstance(survivors, int) \
            else len(tuple(survivors))
        if g * g > n_surv:
            findings.append(Finding(
                rule,
                f"a {g}x{g} grid needs {g * g} devices but only "
                f"{n_surv} survive", subject="steal3d"))
    unassigned = int((dev < 0).sum())
    if unassigned:
        holes = np.argwhere(dev < 0)[:3].tolist()
        findings.append(Finding(
            rule,
            f"{unassigned} work item(s) unassigned (dev < 0), e.g. "
            f"{holes} — recovery would silently drop their block "
            "products", subject="steal3d"))
    dead = int((dev >= g * g).sum())
    if dead:
        ids = sorted(set(int(d) for d in dev[dev >= g * g].ravel()))[:4]
        findings.append(Finding(
            rule,
            f"{dead} work item(s) assigned to device ids {ids} outside "
            f"the surviving mesh's [0, {g * g}) — those positions no "
            "longer exist", subject="steal3d"))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
RULES = (
    ("schedule.ppermute-bijection",
     "every ppermute permutation is a complete, self-send-free bijection, "
     "and the tile maps composed from them are what the body reads"),
    ("schedule.steal-exactly-once",
     "steal3d pair lists accumulate each (i,k,j) block product exactly "
     "once across devices"),
    ("schedule.steal-conservation",
     "steal3d move/reduce rounds conserve tiles and partials; pair lists "
     "stay sorted with full slot coverage"),
    ("schedule.wire-contract",
     "packed-wire pack_idx/consume maps/slot_map/dmap satisfy the "
     "bsr_spmm_raw contract with inert padding proven inert, and each "
     "launch reads the tile its maps were built for"),
    ("schedule.sparse-pairs-exactly-once",
     "sparse-output pair lists accumulate each structural product "
     "exactly once, slot-sorted with full coverage"),
    ("schedule.balance-identity",
     "balance permutations compose to identity through the epilogue"),
    ("schedule.survivor-coverage",
     "a rebuilt steal3d assignment covers exactly the surviving mesh's "
     "work items: every (i,k,j) assigned, only surviving devices "
     "referenced, grid fits the survivor count"),
)

# the port's own rule (the JAX package plans no grid rank by rank)
RANK_RULES = (
    ("schedule.rank-slice",
     "a rank's pair lists, consume maps and steal3d segments are its "
     "position's slice of the plan every rank builds alike, and its "
     "kernel tables multiply exactly their real entries"),
)


def _guard(rule: str, fn, *args) -> List[Finding]:
    try:
        return fn(*args)
    except Exception as e:                     # noqa: BLE001
        # a decode crash on corrupt metadata is a detection, not a pass
        return [Finding(
            rule,
            f"checker could not decode the plan's metadata "
            f"({type(e).__name__}: {e}) — the arrays do not satisfy the "
            "layout contract's shapes/ranges",
        )]


def check_plan(plan, a=None, b=None, *, _on_ranks: bool = False
               ) -> List[Finding]:
    """Run every schedule rule that applies to ``plan``.

    ``a`` / ``b`` are the plan's operands (handles preferred); structure-
    dependent rules are skipped when they are absent.
    """
    from repro_torch.core import api as _api
    findings = _guard("schedule.ppermute-bijection", check_perms, plan)
    if a is None or b is None:
        return findings
    a_h, b_h = _api._coerce_pair(a, b, g=plan.geom.g,
                                 allow_pad=plan._allow_pad,
                                 device=plan.executor.device,
                                 on_ranks=_on_ranks)
    return findings + _operand_rules(plan, a_h, b_h)


def _operand_rules(plan, a_h, b_h) -> List[Finding]:
    """The rules that read the operands' structure."""
    findings = []
    findings += _guard("schedule.balance-identity", check_balance,
                       plan, a_h, b_h)
    if plan.steal is not None:
        findings += _guard("schedule.steal-exactly-once", check_steal,
                           plan, a_h)
    if plan.symbolic is not None:
        findings += _guard("schedule.sparse-pairs-exactly-once",
                           check_sparse_pairs, plan, a_h, b_h)
    findings += _guard("schedule.wire-contract", check_wire, plan, a_h, b_h)
    return findings


# ---------------------------------------------------------------------------
# plans on a process grid
# ---------------------------------------------------------------------------
def _rank_handles(plan, a, b):
    from repro_torch.core import api as _api
    return _api._coerce_pair(a, b, g=plan.geom.g, allow_pad=plan._allow_pad,
                             device=plan.executor.device, on_ranks=True)


def check_rank_plan(plan, a=None, b=None) -> List[Finding]:
    """Every schedule rule over a plan on a process grid: the rules of
    :func:`check_plan` on its stacked twin, then ``schedule.rank-slice``
    on the rank's own lists.  ``a`` / ``b`` as :func:`check_plan`'s (a
    steal3d or packed plan's twin needs their structure)."""
    if a is None or b is None:
        return _guard("schedule.ppermute-bijection", check_perms, plan)
    a_h, b_h = _rank_handles(plan, a, b)
    twin = plan.stacked_twin(a_h, b_h)
    # the permutations and tile maps the rank itself composes, the
    # operand rules on the plan every rank builds alike
    findings = _guard("schedule.ppermute-bijection", check_perms, plan, twin)
    findings += _operand_rules(twin, a_h, b_h)
    return findings + _guard("schedule.rank-slice", check_rank_slice, plan,
                             twin)


def _mismatch(rule, what, got, want, subject) -> List[Finding]:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape == want.shape and np.array_equal(got, want):
        return []
    return [Finding(rule, f"{what} is not the plan's slice for this rank "
                    f"(shape {got.shape} against {want.shape}) — the rank "
                    "would run another position's work", subject=subject)]


def check_rank_slice(plan, twin) -> List[Finding]:
    """schedule.rank-slice: the rank's device lists against its position's
    rows of the host plan (``twin``), its kernel tables against their real
    entries."""
    rule = "schedule.rank-slice"
    name = plan.algorithm.name
    g = plan.geom.g
    pos = plan.executor.position
    i, j = divmod(pos, g)
    findings: List[Finding] = []
    if plan.symbolic is not None:
        real = np.asarray(plan._pair_real)
        for t, (mine, full) in enumerate(zip(plan._pairs, twin._pairs)):
            for k in ("pa", "pb", "ps"):
                findings += _mismatch(rule, f"step {t} list {k!r}",
                                      mine[k].cpu().numpy(),
                                      full[k].numpy()[pos:pos + 1],
                                      f"{name}/step {t}")
            table = mine.get("table")
            n_real = int(real[i, j, t].sum())
            if table is not None and table.real_pairs != n_real:
                findings.append(Finding(
                    rule, f"step {t}: B2's table multiplies "
                    f"{table.real_pairs} pairs, the rank's list has "
                    f"{n_real} real ones", subject=f"{name}/step {t}"))
    elif plan.steal is None and plan._host_aux is not None:
        host = plan._host_aux
        for t, step in enumerate(plan._aux):
            for k, v in step.items():
                findings += _mismatch(rule, f"step {t} consume map {k!r}",
                                      v.cpu().numpy().reshape(-1),
                                      np.asarray(host[k][i, j, t]).reshape(
                                          -1), f"{name}/step {t}")
        if plan.algorithm.on_ranks.wire_planner is not None:
            # the rank planner's flat pool: the stacked maps plus the base
            # of each inner step's tile in the gathered pool
            from repro_torch.core.api import _summa_bases
            stacked = _host_steps(twin._aux, list(host), g)
            for k, arr in host.items():
                if "gidx" not in k and "dmap" not in k:
                    continue
                cap = twin._wire_caps[k[0]]
                want = stacked[k] + _summa_bases(g, cap)[..., None]
                findings += _mismatch(
                    rule, f"consume map {k!r} of the flat pool",
                    np.asarray(arr).reshape(want.shape), want, name)
    if plan.steal is not None:
        aux = plan.steal.aux
        names = (("pa0", "pb0", "ps0"), ("pa1", "pb1", "ps1")) \
            if plan.steal.overlap else (("pa", "pb", "ps"),)
        for s_i, (seg, keys) in enumerate(zip(plan._steal.segments, names)):
            for k, key in zip(("pa", "pb", "ps"), keys):
                findings += _mismatch(rule, f"segment {s_i} list {k!r}",
                                      seg[k].cpu().numpy().reshape(-1),
                                      np.asarray(aux[key][i, j]).reshape(-1),
                                      "steal3d")
            table = seg.get("table")
            if table is not None and table.real_blocks != int(
                    seg["real"].sum()):
                findings.append(Finding(
                    rule, f"segment {s_i}: B1's table multiplies "
                    f"{table.real_blocks} blocks, the rank's list has "
                    f"{int(seg['real'].sum())} real pairs",
                    subject="steal3d"))
    return findings[:_MAX_PER_RULE]
