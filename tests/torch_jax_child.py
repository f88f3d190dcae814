"""JAX reference results for the port's parity tests (``test_torch_api.py``).

The JAX engine needs one device per tile, so results at g > 1 come from a
child process whose XLA backend was started with 9 host devices::

    env = repro.runtime.platform.subprocess_env(9, overlap=False)
    python tests/torch_jax_child.py OUT.npz 2 3

It writes, for each grid size and each case of :data:`CASES` and
:data:`SPARSE_CASES`, the JAX package's ``matmul(algorithm=...,
impl="ref")`` result for the case's schedule (a sparse result as its
``TiledBSR`` fields, see :func:`result_fields`), the results of
:data:`NONFINITE_CASES`, plus the fields of the
JAX ``TiledBSR`` that the interop case hands to the port.  The inputs are made here from seeded numpy
and are imported by the test, so both packages see the same matrices.
"""
from __future__ import annotations

import sys

import numpy as np

BLOCK = 4

# The schedules the port has besides ring_c, in the JAX package's
# registration order.
OTHER_ALGORITHMS = ("summa_bcast", "summa_ag", "ring_a", "ring_c_bidir")

# (operand kind, balance of the left operand, overlap) by case name
_DENSE = (
    ("spmm-none-on", "spmm", "none", "on"),
    ("spmm-none-off", "spmm", "none", "off"),
    ("spmm-rows-off", "spmm", "rows", "off"),
    ("spmm-cols-on", "spmm", "cols", "on"),
    ("spgemm-none-on", "spgemm", "none", "on"),
    ("spgemm-none-off", "spgemm", "none", "off"),
    ("spgemm-cols-off", "spgemm", "cols", "off"),
    ("dense-on", "dense", "none", "on"),
    ("dense-off", "dense", "none", "off"),
)

# steal3d's dense-output cases (its assignment, pair lists and rounds are
# structure-specialised, so a few cases cover the body): SpMM with overlap
# on and off and with balanced rows, dense-output SpGEMM, dense x dense
_STEAL = ("spmm-none-on", "spmm-none-off", "spmm-rows-off", "spgemm-none-off",
          "dense-on")

# (case name, schedule, operand kind, balance of the left operand, overlap):
# ring_c's cases keep their names, the other schedules' are
# "<schedule>:<case>"
CASES = tuple((name, "ring_c", *rest) for name, *rest in _DENSE) + tuple(
    (f"{alg}:{name}", alg, *rest)
    for alg in OTHER_ALGORITHMS for name, *rest in _DENSE) + tuple(
    (f"steal3d:{name}", "steal3d", *rest)
    for name, *rest in _DENSE if name in _STEAL)

# Sparse outputs and the packed wire: (case name, schedule, kind, matmul
# keywords).  "sparse" is A @ S with output="sparse"; "auto" A @ S with
# output="auto" (a threshold of 1.0 resolves to sparse, 0.0 to dense);
# "chain" the cube (S @ S) @ S, both multiplies sparse; "packed-spmm" /
# "packed-spgemm" the dense-output packed body on A @ B / A @ S.
_SPARSE = (
    ("sparse-padded-on", "sparse", dict(wire="padded", overlap="on")),
    ("sparse-padded-off", "sparse", dict(wire="padded", overlap="off")),
    ("sparse-packed-on", "sparse", dict(wire="packed", overlap="on")),
    ("sparse-packed-off", "sparse", dict(wire="packed", overlap="off")),
    ("sparse-wire-auto", "sparse", dict()),
    ("auto-default", "auto", dict()),
    ("auto-below", "auto", dict(sparse_threshold=1.0)),
    ("auto-above", "auto", dict(sparse_threshold=0.0)),
    ("chain-padded", "chain", dict(wire="padded")),
    ("chain-packed", "chain", dict(wire="packed", overlap="off")),
    ("packed-spmm-on", "packed-spmm", dict(wire="packed", overlap="on")),
    ("packed-spmm-off", "packed-spmm", dict(wire="packed", overlap="off")),
    ("packed-spgemm-on", "packed-spgemm", dict(wire="packed", overlap="on")),
    ("packed-spgemm-off", "packed-spgemm",
     dict(wire="packed", overlap="off")),
)
# the other schedules' packed bodies, and the SUMMAs' sparse outputs
_PACKED = ("packed-spmm-off", "packed-spgemm-on")
_SUMMA_SPARSE = ("sparse-padded-on", "sparse-packed-off", "auto-below")
SPARSE_CASES = tuple((name, "ring_c", *rest) for name, *rest in _SPARSE) \
    + tuple((f"{alg}:{name}", alg, *rest)
            for alg in OTHER_ALGORITHMS + ("steal3d",)
            for name, *rest in _SPARSE
            if name in _PACKED
            or (name in _SUMMA_SPARSE and alg.startswith("summa")))

# SpMM on a B with an inf, a NaN and a -inf planted (:func:`nonfinite_b`):
# (case name, schedule, matmul keywords).  The NaN mask of C depends on
# which blocks each schedule lists (padding, coverage, the packed wire's
# consume lists), so it is held to the JAX package's exactly.
NONFINITE_CASES = (
    ("nonfinite:ring_c-padded", "ring_c", dict(wire="padded")),
    ("nonfinite:ring_c-packed", "ring_c", dict(wire="packed")),
    ("nonfinite:summa_bcast", "summa_bcast", dict(wire="padded")),
)


def inputs() -> dict:
    """The operands of every case, as float32 numpy arrays."""
    rng = np.random.default_rng(0)

    def sparse(m, n, density, seed):
        r = np.random.default_rng(seed)
        return (r.standard_normal((m, n)) * (r.random((m, n)) < density)
                ).astype(np.float32)

    # mass in the first row and column blocks, so that balance="rows" and
    # "cols" both shrink the tile capacity at g = 2 and 3
    a = sparse(48, 40, 0.01, 7)
    a[:12, :] += sparse(12, 40, 0.5, 8)
    a[:, :8] += sparse(48, 8, 0.5, 9)
    return {
        "a": a,
        "b": rng.standard_normal((40, 9)).astype(np.float32),
        "s": sparse(40, 40, 0.1, 12),
        "x": rng.standard_normal((10, 7)).astype(np.float32),
        "y": rng.standard_normal((7, 5)).astype(np.float32),
    }


def nonfinite_b(ops: dict) -> np.ndarray:
    """``ops["b"]`` with an inf in its first block-row (the B chunk that
    capacity padding and coverage blocks name), a NaN in a middle one and
    a -inf in its last."""
    b = ops["b"].copy()
    b[1, 3] = np.inf
    b[22, 5] = np.nan
    b[-2, 7] = -np.inf
    return b


def oracle(kind: str, ops: dict) -> np.ndarray:
    """The dense float64 product each case computes."""
    if kind == "dense":
        return ops["x"].astype(np.float64) @ ops["y"]
    rhs = ops["b"] if kind == "spmm" else ops["s"]
    return ops["a"].astype(np.float64) @ rhs


def sparse_oracle(kind: str, ops: dict) -> np.ndarray:
    """The dense float64 product each sparse case computes."""
    a, s = ops["a"].astype(np.float64), ops["s"].astype(np.float64)
    if kind == "chain":
        return s @ s @ s
    if kind == "packed-spmm":
        return a @ ops["b"]
    return a @ s


def run_sparse_case(api, algorithm: str, kind: str, kw: dict, handle,
                    dense_rhs):
    """One sparse case through an API module (``repro.core.api`` or
    ``repro_torch.core.api``); ``handle(x)`` wraps a numpy operand as a
    DistBSR, ``dense_rhs(x, a_h)`` a dense right operand."""
    kw = dict(kw, algorithm=algorithm)
    if kind == "chain":
        s_h = handle("s")
        c2 = api.matmul(s_h, s_h, output="sparse", **kw)
        return api.matmul(c2, s_h, output="sparse", **kw)
    a_h = handle("a")
    if kind == "packed-spmm":
        return api.matmul(a_h, dense_rhs("b", a_h), **kw)
    output = {"sparse": "sparse", "auto": "auto"}.get(kind, "dense")
    return api.matmul(a_h, handle("s"), output=output, **kw)


def result_fields(out) -> dict:
    """A result as numpy arrays: ``dense`` for a tensor or array, else the
    output handle's ``blocks``, ``rows``, ``cols``, ``counts`` and ``meta``
    (capacity, store capacity, shape, logical shape)."""
    tiled = getattr(out, "tiled", None)
    if tiled is None:
        return {"dense": _numpy(out)}
    fields = {f: _numpy(getattr(tiled, f)) for f in ("blocks", "rows", "cols",
                                                     "counts")}
    fields["meta"] = np.asarray([tiled.capacity, tiled.store_capacity,
                                 *tiled.shape, *out.logical_shape])
    fields["dense_value"] = _numpy(out.densify())
    return fields


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):                 # a torch tensor
        return x.detach().cpu().float().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def jax_sparse_result(algorithm: str, kind: str, kw: dict, g: int,
                      ops: dict) -> dict:
    import jax.numpy as jnp
    from repro.core import api
    return result_fields(run_sparse_case(
        api, algorithm, kind, dict(kw, impl="ref"),
        lambda name: api.DistBSR.from_dense(ops[name], g=g,
                                            block_size=BLOCK),
        lambda name, a_h: api.DistDense.for_rhs(jnp.asarray(ops[name]),
                                                a_h)))


def jax_tiled(g: int, balance: str, ops: dict):
    from repro.core.api import DistBSR
    return DistBSR.from_dense(ops["a"], g=g, block_size=BLOCK,
                              balance=balance)


def jax_result(algorithm: str, kind: str, balance: str, overlap: str, g: int,
               ops: dict) -> np.ndarray:
    """``repro.core.api.matmul`` with the case's schedule and the jnp
    reference kernel."""
    import jax.numpy as jnp
    from repro.core.api import DistBSR, DistDense, matmul
    kw = dict(algorithm=algorithm, impl="ref", overlap=overlap)
    if kind == "dense":
        return np.asarray(matmul(jnp.asarray(ops["x"]), jnp.asarray(ops["y"]),
                                 g=g, **kw))
    a_h = jax_tiled(g, balance, ops)
    if kind == "spmm":
        b_h = DistDense.for_rhs(jnp.asarray(ops["b"]), a_h)
    else:
        b_h = DistBSR.from_dense(ops["s"], g=g, block_size=BLOCK)
    return np.asarray(matmul(a_h, b_h, **kw))


def jax_nonfinite_result(algorithm: str, kw: dict, g: int,
                         ops: dict) -> np.ndarray:
    """``repro.core.api.matmul`` of A and :func:`nonfinite_b` with the
    case's schedule and the jnp reference kernel."""
    import jax.numpy as jnp
    from repro.core.api import DistDense, matmul
    a_h = jax_tiled(g, "none", ops)
    b_h = DistDense.for_rhs(jnp.asarray(nonfinite_b(ops)), a_h)
    return np.asarray(matmul(a_h, b_h, algorithm=algorithm, impl="ref",
                             **kw))


def main(argv) -> int:
    out, grids = argv[1], [int(x) for x in argv[2:]]
    import jax
    need = max(g * g for g in grids)
    if len(jax.devices()) < need:
        raise SystemExit(f"needs {need} devices, has {len(jax.devices())}")
    ops = inputs()
    res = {}
    for g in grids:
        for name, alg, kind, balance, overlap in CASES:
            res[f"{name}/g{g}"] = jax_result(alg, kind, balance, overlap, g,
                                             ops)
        for name, alg, kind, kw in SPARSE_CASES:
            for field, value in jax_sparse_result(alg, kind, kw, g,
                                                  ops).items():
                res[f"{name}/g{g}/{field}"] = value
        for name, alg, kw in NONFINITE_CASES:
            res[f"{name}/g{g}"] = jax_nonfinite_result(alg, kw, g, ops)
        t = jax_tiled(g, "none", ops).tiled
        for field in ("blocks", "rows", "cols", "counts"):
            res[f"tiled-{field}/g{g}"] = np.asarray(getattr(t, field))
        res[f"tiled-meta/g{g}"] = np.asarray(
            [*t.shape, *t.logical_shape, t.capacity])
    np.savez(out, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
