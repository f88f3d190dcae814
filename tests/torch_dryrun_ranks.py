"""Rank functions for the dry-run tests (importable by spawned ranks; no
JAX): the cells of ``launch/dryrun.py`` run for real on gloo ranks, each
recorded by ``launch/op_analysis.py``, and the sharded serving programs
those cells describe (``models/sharded.py``) on weights and tokens the
test wrote from the JAX package's."""
from __future__ import annotations

import os

MESH = (2, 2)
#: the serving check: one arch per cache kind (global attention; Mamba;
#: RG-LRU with local attention), prompts of ``prompt`` tokens, then
#: ``steps`` decode steps fed the next tokens of the same rows
SERVE_ARCHS = ("qwen2.5-3b", "mamba2-130m", "recurrentgemma-2b")
SERVE = dict(batch=4, prompt=8, steps=3, max_len=16)


def cell_rank(device, cells, dims=MESH):
    """Each ``(arch, kind, seq, batch)`` smoke cell recorded on this
    rank's real step over a ``dims`` mesh of gloo ranks: flops, collective
    bytes by kind, argument bytes and ``MeshComm.sent`` (numbers only)."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(tuple(dims), ("data", "model"), device_type="cpu")
    out = []
    for arch, kind, seq, batch in cells:
        cfg = dryrun.cell_config(get_config(arch, smoke=True), "single")
        rec = dryrun.record_cell(cfg, Shape(kind, kind, seq, batch), mesh,
                                 device, fake=False, transport=True)
        st = rec["stats"]
        out.append({"dot_flops": st.dot_flops,
                    "collective_bytes": dict(st.collective_bytes),
                    "collective_count": dict(st.collective_count),
                    "collective_sent": dict(st.collective_sent),
                    "arguments": rec["arguments"],
                    "argument_size_in_bytes":
                        rec["memory"]["argument_size_in_bytes"],
                    "sent": rec["sent"]})
    return out


def serve_rank(device, tmp: str) -> dict:
    """``sharded_prefill`` and ``make_sharded_decode_step`` on a ``MESH``
    of gloo ranks, float32 caches: this rank's mesh coordinate and, for
    each arch, its logits and cache shards after the prefill and after
    each decode step (numpy)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert, sharded
    mesh = make_mesh(MESH, ("data", "model"), device_type="cpu")
    n, p = SERVE["prompt"], SERVE["steps"]
    out = {"coord": [int(c) for c in mesh.get_coordinate()]}
    for arch in SERVE_ARCHS:
        saved = torch.load(os.path.join(tmp, f"{arch}.pt"),
                           weights_only=False)
        cfg = get_config(arch, smoke=True)
        sm = sharded.ShardedModel.place(
            convert.params_from_jax(saved["params"], cfg, "cpu"), mesh)
        _, placements = sharded.cache_shards(
            cfg, SERVE["batch"], SERVE["max_len"], mesh, torch.float32,
            device="cpu")
        toks = sharded.place_batch(
            {"tokens": torch.from_numpy(saved["tokens"])}, mesh)["tokens"]
        logits, caches, pos = sharded.sharded_prefill(
            sm, {"tokens": toks[:, :n]}, cfg, SERVE["max_len"], placements,
            cache_dtype=torch.float32)
        res = {"logits": [logits.numpy()],
               "caches": [[{k: v.numpy().copy() for k, v in c.items()}
                           for c in caches]]}
        step = sharded.make_sharded_decode_step(cfg)
        for t in range(n, n + p):
            logits, caches = step(sm, toks[:, t:t + 1], caches, placements,
                                  pos)
            pos = pos + 1
            res["logits"].append(logits.numpy())
            res["caches"].append([{k: v.numpy().copy()
                                   for k, v in c.items()}
                                  for c in caches])
        out[arch] = res
    return out


def ranks(device, cells, tmp: str) -> dict:
    """Everything the dry-run tests run on the 4 ranks."""
    return {"cells": cell_rank(device, cells),
            "serve": serve_rank(device, tmp)}
