"""What each rank of a process grid runs for ``test_torch_grid.py``.

The ranks import this module (``repro_torch.launch.grid.run_grid`` starts
them from a fresh interpreter), so it imports nothing of JAX: the cases
and their inputs come from ``torch_jax_child``, whose JAX parts are
imported only inside its JAX functions.
"""
from __future__ import annotations

import torch

import torch_jax_child as child

CPU = torch.device("cpu")


def _handles(kind: str, balance: str, g: int, ops: dict):
    from repro_torch.core.api import DistBSR, DistDense
    a_h = DistBSR.from_dense(ops["a"], g=g, block_size=child.BLOCK,
                             balance=balance, device=CPU)
    if kind == "spmm":
        return a_h, DistDense.for_rhs(ops["b"], a_h)
    return a_h, DistBSR.from_dense(ops["s"], g=g, block_size=child.BLOCK,
                                   device=CPU)


def _bytes(ex, plan) -> dict:
    """What this rank sent in the multiply just run, by phase, beside the
    plan's cost dict and C tile."""
    geom = plan.geom
    return {"body": ex.bytes_sent("body"), "place": ex.bytes_sent("place"),
            "epilogue": ex.bytes_sent("epilogue"),
            "net_bytes_per_step": plan.cost_model()["net_bytes_per_step"],
            "c_tile_bytes": geom.tm * geom.tn * geom.out_dtype.itemsize,
            "algorithm": plan.algorithm.name, "overlap": geom.overlap}


def dense_case(ex, name: str, ops: dict):
    """One of ``child.CASES`` on the grid: (global result, bytes)."""
    from repro_torch.core.api import matmul, plan_matmul
    _, alg, kind, balance, overlap = next(c for c in child.CASES
                                          if c[0] == name)
    kw = dict(algorithm=alg, overlap=overlap, mesh=ex)
    if kind == "dense":
        x, y = ops["x"], ops["y"]
        out = matmul(x, y, g=ex.g, **kw)
        plan = plan_matmul(x, y, g=ex.g, **kw)
    else:
        a_h, b_h = _handles(kind, balance, ex.g, ops)
        out = matmul(a_h, b_h, **kw)
        plan = plan_matmul(a_h, b_h, **kw)
    sent = _bytes(ex, plan)
    return out.to_global().numpy(), sent


def sparse_case(ex, name: str, ops: dict):
    """One of ``child.SPARSE_CASES`` on the grid: (result fields, bytes of
    its last multiply)."""
    from repro_torch.core import api
    from repro_torch.core.api import DistBSR, DistDense
    _, alg, kind, kw = next(c for c in child.SPARSE_CASES if c[0] == name)
    handle = lambda n: DistBSR.from_dense(ops[n], g=ex.g,
                                          block_size=child.BLOCK, device=CPU)
    out = child.run_sparse_case(
        api, alg, kind, dict(kw, mesh=ex), handle,
        lambda n, a_h: DistDense.for_rhs(ops[n], a_h))
    sent = {"body": ex.bytes_sent("body"), "place": ex.bytes_sent("place")}
    if kind == "sparse":            # A @ S, one sparse-output multiply
        plan = api.plan_matmul(handle("a"), handle("s"), output="sparse",
                               algorithm=alg, mesh=ex, **kw)
        sent.update(_bytes(ex, plan), body=sent["body"], place=sent["place"])
    on_grid = isinstance(out, DistBSR) and out.on_grid
    return child.result_fields(out.to_global()), sent, on_grid


def shift_peers(ex) -> dict:
    """Each shift's peers as the exchange saw them: per (axis, sign), the
    position whose tile this rank received."""
    pos = {"row": ex.i, "col": ex.j}
    out = {}
    for axis in ("row", "col"):
        for sign in (1, -1):
            got = ex.shift({"p": torch.tensor([pos[axis]])}, axis, sign)
            out[(axis, sign)] = (int(got["p"][0]), pos[axis])
    return out


def pools(ex, ops: dict) -> dict:
    """The A pool each B1 call of summa_ag and summa_bcast reads on this
    rank (its leading dimension: tiles held), padded and packed."""
    from repro_torch.core import api
    seen = []
    raw = api.kops.bsr_spmm_raw
    a_h, b_h = _handles("spmm", "none", ex.g, ops)
    wc = a_h.packed_operand().wire_capacity

    def spy(blocks, *args, **kw):
        # a packed pool is one flat buffer of wire_capacity slots a tile
        seen.append(blocks.shape[0] if kw.get("gidx") is None
                    else blocks.shape[1] // wc)
        return raw(blocks, *args, **kw)

    out = {}
    api.kops.bsr_spmm_raw = spy
    try:
        for alg in ("summa_ag", "summa_bcast"):
            for wire in ("padded", "packed"):
                seen.clear()
                api.matmul(a_h, b_h, algorithm=alg, wire=wire, mesh=ex)
                out[(alg, wire)] = list(seen)
    finally:
        api.kops.bsr_spmm_raw = raw
    return out


def cache_keys(ex, ops: dict) -> dict:
    """Plans of the same operands on the grid and stacked: distinct, and
    neither a hit for the other."""
    from repro_torch.core import api
    a_h, b_h = _handles("spmm", "none", ex.g, ops)
    api.clear_plan_cache()
    api.cache_stats(reset=True)
    on_grid = api.plan_matmul(a_h, b_h, mesh=ex)
    stacked = api.plan_matmul(a_h, b_h)
    again = api.plan_matmul(a_h, b_h, mesh=ex)
    stats = api.cache_stats()["plans"]
    return {"distinct": on_grid is not stacked, "reused": again is on_grid,
            "stacked_on_ranks": stacked.on_ranks,
            "grid_on_ranks": on_grid.on_ranks,
            "hits": stats["hits"], "misses": stats["misses"]}


def grid_cases(ex) -> dict:
    """Every case of the JAX child on this grid, with the checks' data;
    the results themselves from rank 0 only (the others equal them)."""
    ops = child.inputs()
    dense, sparse, sent, sparse_sent, on_grid = {}, {}, {}, {}, {}
    for name, *_ in child.CASES:
        dense[name], sent[name] = dense_case(ex, name, ops)
    for name, *_ in child.SPARSE_CASES:
        sparse[name], sparse_sent[name], on_grid[name] = sparse_case(
            ex, name, ops)
    out = {"rank": ex.rank, "sent": sent, "sparse_sent": sparse_sent,
           "on_grid": on_grid, "peers": shift_peers(ex),
           "pools": pools(ex, ops), "cache": cache_keys(ex, ops),
           "transport": ex.transport}
    if ex.rank == 0:
        out["dense"], out["sparse"] = dense, sparse
    return out


def fail_on_rank(ex, bad: int):
    """Raise on rank ``bad``; the others wait in a collective."""
    if ex.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    ex.barrier()


def hang(ex):
    """Never return (the grid's deadline must end it)."""
    import time
    time.sleep(600)


def card_cases(ex) -> dict:
    """Every schedule's SpMM on the grid (card tiles, host-staged when the
    transport is gloo) against the stacked executor on this rank's card,
    and a sparse output through each sparse schedule: the largest error of
    each, and the bytes staged."""
    from repro_torch.core.api import (DistBSR, DistDense, algorithms,
                                      matmul, sparse_algorithms)
    ops = child.inputs()
    a_h, b_h = _handles("spmm", "none", ex.g, ops)
    s_h = DistBSR.from_dense(ops["s"], g=ex.g, block_size=child.BLOCK,
                             device=CPU)
    a_c = DistBSR.from_dense(ops["a"], g=ex.g, block_size=child.BLOCK,
                             device=ex.device)
    b_c = DistDense.for_rhs(ops["b"], a_c)
    s_c = DistBSR.from_dense(ops["s"], g=ex.g, block_size=child.BLOCK,
                             device=ex.device)
    err, staged = {}, 0
    for alg in algorithms():
        for wire in ("padded", "packed"):
            got = matmul(a_h, b_h, algorithm=alg, wire=wire, mesh=ex)
            staged += ex.staged_bytes
            want = matmul(a_c, b_c, algorithm=alg, wire=wire)
            err[(alg, wire)] = float(
                (got.to_global() - want).abs().max().item())
    for alg in sparse_algorithms():
        got = matmul(a_h, s_h, algorithm=alg, output="sparse", mesh=ex)
        staged += ex.staged_bytes
        want = matmul(a_c, s_c, algorithm=alg, output="sparse")
        err[(alg, "sparse")] = float(
            (got.densify() - want.densify()).abs().max().item())
    return {"err": err, "staged_bytes": staged, "transport": ex.transport,
            "device": str(ex.device)}
