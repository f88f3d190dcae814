"""JAX reference results for ``test_torch_sharded.py``.

The JAX package's expert ring and ``compressed_psum`` need a device per
rank, so they run in a child process whose XLA backend was started with 4
host devices::

    env = repro.runtime.platform.subprocess_env(4, overlap=False)
    python tests/torch_jax_sharded_child.py OUT.npz

It writes, for R = 2 and 4, ``ring_moe_forward``'s output and aux losses
on a ``(1, R)`` mesh at the JAX selftest's ``selftest_ring`` size, the
gradients of :func:`ring_loss` through it (``jax.grad``) and through
``moe_forward``, and
``compressed_psum`` over a 2-device axis for two steps of error feedback.
The inputs come from :func:`ring_inputs` and :func:`psum_inputs` (seeded
numpy), which the port's ranks import too.

For ``test_torch_tp.py`` it runs on one device::

    python tests/torch_jax_sharded_child.py tp DIR

and reads, for each case of :data:`TP_ARCHS`, the JAX package's weights,
batch and tokens that the test wrote (:func:`tp_write_inputs`) to write
``DIR/jax_tp.pt``: ``lm.loss_fn``'s loss and share of dropped tokens,
and, but for the cases of :data:`TP_LOSS_CASES`, ``lm.prefill`` and
:data:`TP_SERVE`'s decode steps (logits, and each layer's cache after the
prefill and after each step) and JAX's ``cache_specs`` sanitized on each
mesh of :data:`TP_MESHES`, one dict a layer.  ``fam DIR`` does the same
for ``test_torch_tp_families.py``'s cases (:data:`FAM_ARCHS`, meshes
:data:`FAM_MESHES`) into ``DIR/jax_fam.pt``: an encoder's "prefill" is
its ``transformer.forward`` logits on the loss batch's frames (it has no
cache and no decode), a vlm's prompt carries its patches.
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


def ring_loss(layer, cfg):
    """``sum(y**2) + moe_aux + moe_z`` of ``layer(p, x, cfg)``: the
    scalar whose gradients the ring's backward is held to (JAX's arrays
    or the port's tensors)."""
    def loss(p, x):
        y, aux = layer(p, x, cfg)
        return (y * y).sum() + aux["moe_aux"] + aux["moe_z"]
    return loss


def psum_inputs() -> np.ndarray:
    """Per step, per rank, per tensor: the gradients summed by
    ``compressed_psum`` (float32)."""
    rng = np.random.default_rng(7)
    return {f"{k}/{s}/{r}": rng.standard_normal(shape).astype(np.float32)
            for s in range(PSUM_STEPS) for r in range(PSUM_RANKS)
            for k, shape in PSUM_SHAPES.items()}


#: the tensor-parallel program's cases: the four dense families' smoke
#: configs, llama3-8b's with 16 kv heads (a cache split by head) and
#: gemma2-9b's on a model axis of 8, which its 4 q heads do not divide
#: (attention whole on every rank, the rest split); the two MoE families'
#: smoke configs (8 experts, top-2) with ``moe_dispatch_groups`` the mesh's
#: batch shards (``/g2`` on ``(2, 2)``), arctic's on ``(1, 8)`` too (its 4
#: q heads do not divide the axis, as its 56 do not divide 16), and OLMoE's
#: at capacity factor 1 with one dispatch group over both batch shards of
#: ``(2, 2)``, where tokens drop (``/cap1``)
TP_ARCHS = ("qwen2.5-3b", "llama3-8b", "gemma2-9b", "qwen1.5-110b", "kv16",
            "olmoe-1b-7b", "arctic-480b", "olmoe-1b-7b/g2", "arctic-480b/g2",
            "olmoe-1b-7b/cap1", "olmoe-1b-7b/aux")
TP_MESHES = ((1, 2), (2, 2), (1, 4), (1, 8))
TP_MOE_CASES = tuple((f"{a}{'/g2' if m[0] == 2 else ''}", m)
                     for a in ("olmoe-1b-7b", "arctic-480b")
                     for m in TP_MESHES[:3]) + (("olmoe-1b-7b/cap1", (2, 2)),
                                                ("arctic-480b", (1, 8)))
TP_CASES = tuple((a, m) for a in TP_ARCHS[:4] for m in TP_MESHES[:3]) \
    + (("kv16", (1, 2)), ("gemma2-9b", (1, 8))) + TP_MOE_CASES
#: the loss alone: OLMoE's with an aux loss weight of 1 and two dispatch
#: groups on ``(2, 2)``, whose batch shards route differently
TP_LOSS_CASES = (("olmoe-1b-7b/aux", (2, 2)),)
#: the loss's batch; the serving check: prompts of ``prompt`` tokens, past
#: gemma2's smoke window of 16, then ``steps`` decode steps
TP_BATCH = dict(batch=4, seq=16, seed=1)
TP_SERVE = dict(batch=4, prompt=18, steps=3, max_len=24)
#: what a MoE case changes in its family's smoke config
TP_MOE = {"g2": dict(moe_dispatch_groups=2),
          "cap1": dict(moe=dict(capacity_factor=1.0)),
          "aux": dict(moe_dispatch_groups=2, moe=dict(aux_loss=1.0))}

#: the recurrent, SSM and frontend families' cases: their smoke configs
#: on (1, 2), (2, 2) and (1, 4); recurrentgemma-2b's on (1, 8), where its
#: 4 q heads do not divide the axis (attention whole, the RG-LRU's
#: channels one gate block a rank); Mamba shaped like mamba2-130m on 16
#: (``/d48``: d_model 48, so 6 heads and 230 columns of ``in_proj`` that 4
#: does not divide while the conv's 128 channels, the norm and
#: ``out_proj``'s 96 rows do, and a vocabulary of 502 that does not divide
#: the axis either) on (1, 4); and an RG-LRU 48 wide on (1, 3)
#: (``/w48``: 16 channels a rank, gate blocks of 6, so a rank's channels
#: end inside a block; nothing else divides 3: every other layer whole)
FAM_ARCHS = ("mamba2-130m", "recurrentgemma-2b", "hubert-xlarge",
             "llava-next-mistral-7b", "mamba2-130m/d48",
             "recurrentgemma-2b/w48")
FAM_MESHES = ((1, 2), (2, 2), (1, 4), (1, 8), (1, 3))
FAM_CASES = tuple((a, m) for a in FAM_ARCHS[:4] for m in FAM_MESHES[:3]) \
    + (("recurrentgemma-2b", (1, 8)), ("mamba2-130m/d48", (1, 4)),
       ("recurrentgemma-2b/w48", (1, 3)))
FAM_VARIANTS = {"d48": dict(d_model=48, vocab_size=502),
                "w48": dict(lru_width=48)}


def tp_config(get_config, name: str):
    """A case's config from either package's ``get_config``."""
    import dataclasses
    if name == "kv16":
        return dataclasses.replace(get_config("llama3-8b", smoke=True),
                                   name="llama3-8b-smoke-kv16", n_heads=16,
                                   n_kv_heads=16)
    arch, _, variant = name.partition("/")
    cfg = get_config(arch, smoke=True)
    if not variant:
        return cfg
    change = dict(TP_MOE.get(variant) or FAM_VARIANTS[variant])
    if "moe" in change:
        change["moe"] = dataclasses.replace(cfg.moe, **change["moe"])
    return dataclasses.replace(cfg, name=f"{cfg.name}-{variant}", **change)


def tp_write_inputs(tmp: str, archs=TP_ARCHS) -> None:
    """Each case's JAX weights (``init_params`` from ``PRNGKey(i)``), loss
    batch and serving tokens (and a vlm's prompt patches), as numpy, to
    ``tmp/<case>.pt``."""
    import os

    import jax
    import torch

    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import transformer as jtf
    for i, name in enumerate(archs):
        cfg = tp_config(get_config, name)
        params = jtf.init_params(cfg, jax.random.PRNGKey(i))
        batch = {k: np.asarray(v) for k, v in SyntheticLM(
            cfg, TP_BATCH["batch"], TP_BATCH["seq"],
            seed=TP_BATCH["seed"])(0).items()}
        rng = np.random.default_rng(i)
        toks = rng.integers(
            0, cfg.vocab_size, (TP_SERVE["batch"], TP_SERVE["prompt"]
                                + TP_SERVE["steps"])).astype(np.int32)
        saved = {"params": jax.tree.map(np.asarray, params),
                 "batch": batch, "tokens": toks}
        if cfg.frontend == "vlm":
            saved["patches"] = rng.standard_normal(
                (TP_SERVE["batch"], cfg.num_patches,
                 cfg.frontend_dim)).astype(np.float32)
        torch.save(saved, os.path.join(tmp, f"{_file(name)}.pt"))


def serve_max_len(cfg) -> int:
    """The cache length of a case's serving check: the prompt's patches
    too, for a vlm."""
    return TP_SERVE["max_len"] + (cfg.num_patches
                                  if cfg.frontend == "vlm" else 0)


def _file(name: str) -> str:
    """A case's file name in the test's directory."""
    return name.replace("/", "_")


def _layer_specs(cfg, caches, dims) -> list:
    """JAX's ``cache_specs`` sanitized on a ``(data, model)`` mesh of
    ``dims`` against the grouped cache shapes, one dict a layer (the
    stacking dimension dropped), in ``convert.unstack_layers``' order."""
    from jax.sharding import AbstractMesh

    from repro.launch.mesh import sanitize_spec
    from repro.models import transformer as jtf
    mesh = AbstractMesh(dims, ("data", "model"))
    specs = jtf.cache_specs(cfg)
    out = []
    for gi, (unit, n_units) in enumerate(jtf.layer_plan(cfg)):
        group = [{k: tuple(sanitize_spec(s, caches[gi][li][k].shape,
                                         mesh))[1:]
                  for k, s in specs[gi][li].items()}
                 for li in range(len(unit))]
        out += [group[li] for _ in range(n_units)
                for li in range(len(unit))]
    return out


def _tp(tmp: str, archs, meshes, out_name: str) -> None:
    import os

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config
    from repro.models import lm
    from repro.models import transformer as jtf
    from repro_torch.configs import get_config as tget
    from repro_torch.models.convert import unstack_layers
    out = {}
    n, steps = TP_SERVE["prompt"], TP_SERVE["steps"]
    loss_only = {a for a, _ in TP_LOSS_CASES}
    for name in archs:
        cfg = tp_config(get_config, name)
        saved = torch.load(os.path.join(tmp, f"{_file(name)}.pt"),
                           weights_only=False)
        params = jax.tree.map(jnp.asarray, saved["params"])
        batch = {k: jnp.asarray(v) for k, v in saved["batch"].items()}
        loss, metrics = lm.loss_fn(params, batch, cfg)
        out[name] = {"loss": float(loss),
                     "dropped": float(metrics["dropped"])}
        if name in loss_only:
            continue
        if cfg.is_encoder:
            logits = jtf.forward(params, {"frames": batch["frames"]}, cfg)[0]
            out[name].update(serve=[(np.asarray(logits), [])], specs={})
            continue
        toks = saved["tokens"]
        prompt = {"tokens": jnp.asarray(toks[:, :n])}
        if "patches" in saved:
            prompt["patches"] = jnp.asarray(saved["patches"])
        logits, caches, pos = lm.prefill(
            params, prompt, cfg, serve_max_len(cfg), jnp.float32)
        seen = [(logits, caches)]
        step = lm.make_decode_step(cfg)
        for t in range(n, n + steps):
            logits, caches = step(params, jnp.asarray(toks[:, t:t + 1]),
                                  caches, pos)
            pos = pos + 1
            seen.append((logits, caches))
        tcfg = tp_config(tget, name)
        grouped = jax.tree.map(np.asarray, caches)
        out[name].update(
            serve=[(np.asarray(lg), unstack_layers(
                tcfg, jax.tree.map(np.asarray, c))) for lg, c in seen],
            specs={dims: _layer_specs(cfg, grouped, dims)
                   for dims in meshes})
    torch.save(out, os.path.join(tmp, out_name))


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
        # jax.grad through the ring's hops: the gradients of RING_LOSS
        gp, gx = jax.jit(jax.grad(ring_loss(moe_mod.ring_moe_forward, cfg),
                                  argnums=(0, 1)))(p_sh, x)
    dp, dx = jax.grad(ring_loss(moe_mod.moe_forward, cfg),
                      argnums=(0, 1))(p, x)
    for k in p:
        res[f"ring{n}/grad/{k}"] = np.asarray(gp[k])
        res[f"ring{n}/dense_grad/{k}"] = np.asarray(dp[k])
    res[f"ring{n}/grad/x"] = np.asarray(gx)
    res[f"ring{n}/dense_grad/x"] = np.asarray(dx)
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
    if argv[1] == "tp":
        _tp(argv[2], TP_ARCHS, TP_MESHES, "jax_tp.pt")
        return 0
    if argv[1] == "fam":
        _tp(argv[2], FAM_ARCHS, FAM_MESHES, "jax_fam.pt")
        return 0
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
