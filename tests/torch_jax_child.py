"""JAX reference results for the port's parity tests (``test_torch_api.py``).

The JAX engine needs one device per tile, so results at g > 1 come from a
child process whose XLA backend was started with 9 host devices::

    env = repro.runtime.platform.subprocess_env(9, overlap=False)
    python tests/torch_jax_child.py OUT.npz 2 3

It writes, for each grid size and each case of :data:`CASES`, the JAX
package's ``matmul(algorithm="ring_c", impl="ref")`` result, plus the
fields of the JAX ``TiledBSR`` that the interop case hands to the port.
The inputs are made here from seeded numpy and are imported by the test, so
both packages see the same matrices.
"""
from __future__ import annotations

import sys

import numpy as np

BLOCK = 4

# (case name, operand kind, balance of the left operand, overlap)
CASES = (
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


def oracle(kind: str, ops: dict) -> np.ndarray:
    """The dense float64 product each case computes."""
    if kind == "dense":
        return ops["x"].astype(np.float64) @ ops["y"]
    rhs = ops["b"] if kind == "spmm" else ops["s"]
    return ops["a"].astype(np.float64) @ rhs


def jax_tiled(g: int, balance: str, ops: dict):
    from repro.core.api import DistBSR
    return DistBSR.from_dense(ops["a"], g=g, block_size=BLOCK,
                              balance=balance)


def jax_result(kind: str, balance: str, overlap: str, g: int,
               ops: dict) -> np.ndarray:
    """``repro.core.api.matmul`` with the ring_c schedule and the jnp
    reference kernel."""
    import jax.numpy as jnp
    from repro.core.api import DistBSR, DistDense, matmul
    kw = dict(algorithm="ring_c", impl="ref", overlap=overlap)
    if kind == "dense":
        return np.asarray(matmul(jnp.asarray(ops["x"]), jnp.asarray(ops["y"]),
                                 g=g, **kw))
    a_h = jax_tiled(g, balance, ops)
    if kind == "spmm":
        b_h = DistDense.for_rhs(jnp.asarray(ops["b"]), a_h)
    else:
        b_h = DistBSR.from_dense(ops["s"], g=g, block_size=BLOCK)
    return np.asarray(matmul(a_h, b_h, **kw))


def main(argv) -> int:
    out, grids = argv[1], [int(x) for x in argv[2:]]
    import jax
    need = max(g * g for g in grids)
    if len(jax.devices()) < need:
        raise SystemExit(f"needs {need} devices, has {len(jax.devices())}")
    ops = inputs()
    res = {}
    for g in grids:
        for name, kind, balance, overlap in CASES:
            res[f"{name}/g{g}"] = jax_result(kind, balance, overlap, g, ops)
        t = jax_tiled(g, "none", ops).tiled
        for field in ("blocks", "rows", "cols", "counts"):
            res[f"tiled-{field}/g{g}"] = np.asarray(getattr(t, field))
        res[f"tiled-meta/g{g}"] = np.asarray(
            [*t.shape, *t.logical_shape, t.capacity])
    np.savez(out, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
