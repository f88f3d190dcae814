"""JAX reference results for ``test_torch_sharded.py``.

The JAX package's expert ring and ``compressed_psum`` need a device per
rank, so they run in a child process whose XLA backend was started with 4
host devices::

    env = repro.runtime.platform.subprocess_env(4, overlap=False)
    python tests/torch_jax_sharded_child.py OUT.npz

It writes, for R = 2 and 4, ``ring_moe_forward``'s output and aux losses
on a ``(1, R)`` mesh at the JAX selftest's ``selftest_ring`` size, and
``compressed_psum`` over a 2-device axis for two steps of error feedback.
The inputs come from :func:`ring_inputs` and :func:`psum_inputs` (seeded
numpy), which the port's ranks import too.
"""
from __future__ import annotations

import sys

import numpy as np

RING_SIZES = (2, 4)
PSUM_RANKS = 2
PSUM_STEPS = 2
PSUM_SHAPES = {"w": (8, 6), "b": (5,)}


def ring_config(n: int) -> dict:
    """``selftest_ring``'s layer at ``n`` ranks, as ModelConfig keywords
    (``moe`` the MoEConfig keywords)."""
    return dict(name="moe-ring-selftest", family="moe", n_layers=1,
                d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                vocab_size=64, compute_dtype="float32",
                moe=dict(n_experts=n * 2, top_k=2, d_ff_expert=32,
                         capacity_factor=16.0))


def ring_inputs(n: int) -> dict:
    """Parameters and tokens of the ring case at ``n`` ranks (float32)."""
    rng = np.random.default_rng(100 + n)
    e, d, f = 2 * n, 16, 32
    return {
        "router": (rng.standard_normal((d, e)) / 4).astype(np.float32),
        "w_gate": (rng.standard_normal((e, d, f)) / 4).astype(np.float32),
        "w_up": (rng.standard_normal((e, d, f)) / 4).astype(np.float32),
        "w_down": (rng.standard_normal((e, f, d)) / 6).astype(np.float32),
        "x": rng.standard_normal((2, n * 4, d)).astype(np.float32),
    }


def psum_inputs() -> np.ndarray:
    """Per step, per rank, per tensor: the gradients summed by
    ``compressed_psum`` (float32)."""
    rng = np.random.default_rng(7)
    return {f"{k}/{s}/{r}": rng.standard_normal(shape).astype(np.float32)
            for s in range(PSUM_STEPS) for r in range(PSUM_RANKS)
            for k, shape in PSUM_SHAPES.items()}


def _ring(n: int, res: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.models import moe as moe_mod
    from repro.models.config import ModelConfig, MoEConfig

    kw = ring_config(n)
    cfg = ModelConfig(**dict(kw, moe=MoEConfig(**kw["moe"])))
    ins = ring_inputs(n)
    p = {k: jnp.asarray(v) for k, v in ins.items() if k != "x"}
    x = jnp.asarray(ins["x"])
    y_dense, aux_dense = moe_mod.moe_forward(p, x, cfg)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n),
                ("data", "model"))
    with set_mesh(mesh):
        p_sh = {k: jax.device_put(v, NamedSharding(
            mesh, P("model", None, None) if k != "router" else P(None,
                                                                 None)))
            for k, v in p.items()}
        y, aux = jax.jit(lambda pp, xx: moe_mod.ring_moe_forward(
            pp, xx, cfg))(p_sh, x)
    res[f"ring{n}/y"] = np.asarray(y)
    res[f"ring{n}/y_dense"] = np.asarray(y_dense)
    for k in ("moe_aux", "moe_z", "moe_dropped"):
        res[f"ring{n}/{k}"] = np.asarray(aux[k])
        res[f"ring{n}/dense_{k}"] = np.asarray(aux_dense[k])


def _psum(res: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.compat import shard_map
    from repro.optim.compression import ErrorFeedbackState, compressed_psum

    grads = psum_inputs()
    mesh = Mesh(np.array(jax.devices()[:PSUM_RANKS]), ("data",))
    names = sorted(PSUM_SHAPES)

    def body(gs, rs):
        out, ef = compressed_psum(gs, "data", ErrorFeedbackState(rs))
        return out, ef.residual

    spec = {k: P("data") for k in names}
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                          out_specs=(spec, spec)))
    resid = {k: jnp.zeros((PSUM_RANKS * PSUM_SHAPES[k][0],)
                          + PSUM_SHAPES[k][1:], jnp.float32) for k in names}
    for s in range(PSUM_STEPS):
        gs = {k: jnp.concatenate([jnp.asarray(grads[f"{k}/{s}/{r}"])
                                  for r in range(PSUM_RANKS)]) for k in names}
        summed, resid = f(gs, resid)
        for k in names:
            rows = PSUM_SHAPES[k][0]
            for r in range(PSUM_RANKS):
                res[f"psum/{k}/{s}/{r}/sum"] = np.asarray(
                    summed[k][r * rows:(r + 1) * rows])
                res[f"psum/{k}/{s}/{r}/resid"] = np.asarray(
                    resid[k][r * rows:(r + 1) * rows])


def main(argv) -> int:
    import jax
    if len(jax.devices()) < max(RING_SIZES):
        raise SystemExit(f"needs {max(RING_SIZES)} devices, has "
                         f"{len(jax.devices())}")
    res: dict = {}
    for n in RING_SIZES:
        _ring(n, res)
    _psum(res)
    np.savez(argv[1], **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
