"""What each rank runs for ``test_torch_fsdp_layers.py``.

The ranks import this module (``repro_torch.launch.grid`` starts them from
a fresh interpreter), so it imports nothing of JAX.  Every result is
plain Python or numpy.

A rank runs the ``"fsdp_tp"`` program under an ``OpRecorder`` with
``ShardedModel._gathered`` (one FSDP unit's gather: the top level, or a
layer) and ``MeshComm.sum_group`` (a unit's gradients summed onto the
shards) wrapped to mark the stream, and returns the stream compacted:
``("gather", unit, held)`` where a unit's gather starts (``held``: the
bytes of other layers' gathered parameters still alive then),
``("gathered", unit)`` once it holds them, ``("dropped", unit, alive)``
where it gives them back (``alive``: the bytes of its gathered parameters
still alive), ``("sum", n)`` for a gradient sum of ``n`` tensors, and
``("product",)`` for a run of products (matmuls).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import numpy as np
import torch

TRAIN = dict(batch=4, seq=16, seed=0)
RING_TRAIN = dict(steps=2, batch=4, seq=16, lr=1e-3, seed=0, log_every=0)
SERVE = dict(prompt=6, max_len=8)


def config(arch: str, remat: bool, **extra):
    """``arch``'s smoke config with ``remat`` (and, for a MoE, ``moe``
    keywords in ``extra["moe"]``)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    moe = extra.pop("moe", None)
    if moe:
        extra["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, remat=remat, **extra)


def ring_config(remat: bool = True, impl: str = "ring"):
    """OLMoE's smoke config at a capacity where no token drops."""
    return config("olmoe-1b-7b", remat, moe_impl=impl,
                  moe=dict(capacity_factor=16.0))


def _nbytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


@contextlib.contextmanager
def _marked(sm, rec):
    """``sm._gathered`` and ``sm.comm.sum_group`` marking ``rec``'s
    stream inside the block (module docstring)."""
    alive = {}                  # unit -> [(weakref, bytes)] gathered
    orig_gathered, orig_sum = sm._gathered, sm.comm.sum_group

    def held(unit):
        return sum(n for u, refs in alive.items() if u not in ("", unit)
                   for r, n in refs if r() is not None)

    @contextlib.contextmanager
    def gathered(prefix):
        rec.mark({"gather": prefix, "held": held(prefix)})
        group = [(o, leaf) for g in sm._unit(prefix) for o, leaf, _ in g]
        shards = {(id(o), leaf): o._parameters[leaf] for o, leaf in group}
        try:
            with orig_gathered(prefix):
                refs = []
                for o, leaf in group:
                    t = o._parameters[leaf]
                    if t.untyped_storage()._cdata != \
                            shards[(id(o), leaf)].untyped_storage()._cdata:
                        refs.append((weakref.ref(t), _nbytes(t)))
                alive[prefix] = refs
                del t
                rec.mark({"gathered": prefix})
                yield
        finally:        # a recomputation may stop early, by an exception
            rec.mark({"dropped": prefix, "alive": sum(
                n for r, n in alive[prefix] if r() is not None)})

    def sum_group(grads, placements, axes):
        rec.mark({"sum": len(grads)})
        return orig_sum(grads, placements, axes)

    sm._gathered = gathered
    sm.comm.sum_group = sum_group
    try:
        yield
    finally:
        del sm._gathered, sm.comm.sum_group


def _compact(events) -> list:
    out = []
    for ev in events:
        if "gather" in ev:
            out.append(("gather", ev["gather"], ev["held"]))
        elif "gathered" in ev:
            out.append(("gathered", ev["gathered"]))
        elif "dropped" in ev:
            out.append(("dropped", ev["dropped"], ev["alive"]))
        elif "sum" in ev:
            out.append(("sum", ev["sum"]))
        elif "dims" in ev and (not out or out[-1] != ("product",)):
            out.append(("product",))
    return out


def _units(sm) -> dict:
    """Each unit's groups' sizes (tensors a group) and its parameter
    bytes gathered (whole over the batch axes)."""
    out = {}
    for prefix in [""] + [f"layers.{i}." for i in range(sm.cfg.n_layers)]:
        out[prefix] = [len(g) for g in sm._unit(prefix)]
    return out


def _step_stream(mesh, cfg) -> dict:
    """One train step of ``cfg`` on ``mesh``, its stream marked."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.op_analysis import OpRecorder
    from repro_torch.models import sharded
    from repro_torch.optim import AdamW
    sm = sharded.ShardedModel.init(cfg, mesh, seed=0, device="cpu")
    opt = AdamW(lr=1e-3)
    state = opt.init(sm.local)
    raw = SyntheticLM(cfg, TRAIN["batch"], TRAIN["seq"],
                      seed=TRAIN["seed"])(0)
    batch = {k: torch.as_tensor(v) for k, v in raw.items()}
    rec = OpRecorder()
    with _marked(sm, rec), rec:
        _, _, metrics = sharded.make_sharded_train_step(cfg, opt)(
            sm, state, batch)
    return {"stream": _compact(rec.events), "units": _units(sm),
            "loss": float(metrics["loss"]),
            "shard_bytes": sm.local_bytes()}


def _serve_stream(mesh, cfg) -> dict:
    """A prefill and one decode step of ``cfg`` on ``mesh``, marked."""
    from repro_torch.launch.op_analysis import OpRecorder
    from repro_torch.models import sharded
    sm = sharded.ShardedModel.init(cfg, mesh, seed=0, device="cpu")
    rows = TRAIN["batch"]
    _, placements = sharded.cache_shards(cfg, rows, SERVE["max_len"], mesh,
                                         torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (rows, SERVE["prompt"] + 1)))
    toks = sharded.place_batch({"tokens": toks}, mesh)["tokens"]
    rec = OpRecorder()
    with _marked(sm, rec), rec:
        _, caches, pos = sharded.sharded_prefill(
            sm, {"tokens": toks[:, :SERVE["prompt"]]}, cfg,
            SERVE["max_len"], placements, cache_dtype=torch.float32)
        sharded.make_sharded_decode_step(cfg)(
            sm, toks[:, -1:], caches, placements, pos)
    return {"stream": _compact(rec.events), "units": _units(sm)}


def _ring_train(mesh, remat: bool) -> dict:
    """``train(mesh=)`` with the expert ring, its shards and moments, the
    ring's hops and drops."""
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    moe.reset_ring_stats()
    st = train(ring_config(remat), mesh=mesh, device="cpu", **RING_TRAIN)
    sm = st["params"]
    placed = {n: (t.detach().numpy().copy(),
                  [(m, pl.dim) for m, pl in enumerate(sm.placements[n])
                   if pl.is_shard()])
              for n, t in sm.local_named().items()}
    return {"losses": st["losses"], "grad_norms": st["grad_norms"],
            "dropped": st["dropped"], "params": placed,
            "hops": moe.ring_stats["hops"],
            "backward_hops": moe.ring_stats["backward_hops"],
            "ring_dropped": int(moe.ring_stats["dropped"])}


def fsdp_ranks(dev, dims) -> dict:
    """Every case of ``test_torch_fsdp_layers.py`` on a ``(data, model)``
    mesh of ``dims``."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(dims), ("data", "model"), device_type="cpu")
    out = {"coord": [int(c) for c in mesh.get_coordinate()]}
    for arch in ("qwen2.5-3b", "olmoe-1b-7b"):
        for remat in (True, False):
            out[f"train/{arch}/{remat}"] = _step_stream(
                mesh, config(arch, remat))
        out[f"serve/{arch}"] = _serve_stream(mesh, config(arch, True))
    for remat in (True, False):
        out[f"ring/{remat}"] = _ring_train(mesh, remat)
    return out
