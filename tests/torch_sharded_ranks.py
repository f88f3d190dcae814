"""What each rank runs for ``test_torch_sharded.py``.

The ranks import this module (``repro_torch.launch.grid`` starts them from
a fresh interpreter), so it imports nothing of JAX: the inputs come from
``torch_jax_sharded_child`` and ``torch_jax_child``, whose JAX parts are
imported only inside their JAX functions, or from files the test wrote.
Every result is returned as numpy (or plain Python), which pickles
without the rank process.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import torch_jax_child as grid_child
import torch_jax_sharded_child as child

CPU = torch.device("cpu")
TRAIN_ARCH = "qwen2.5-3b"
TRAIN = dict(steps=2, batch=4, seq=16, lr=1e-3, seed=0, log_every=0)


def ring_cfg(n: int):
    from repro_torch.models.config import ModelConfig, MoEConfig
    kw = child.ring_config(n)
    return ModelConfig(**dict(kw, moe=MoEConfig(**kw["moe"])))


def _moe_cases(n: int) -> dict:
    """The ring, expert parallelism and the single-process layer on a
    ``(1, n)`` mesh, this rank holding its experts."""
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import Params
    cfg = ring_cfg(n)
    ins = {k: torch.from_numpy(v) for k, v in child.ring_inputs(n).items()}
    mesh = make_mesh((1, n), ("data", "model"), device_type="cpu")
    r, el = mesh.get_coordinate()[1], cfg.moe.n_experts // n
    experts = ("w_gate", "w_up", "w_down")
    local = Params(router=ins["router"],
                   **{k: ins[k][r * el:(r + 1) * el] for k in experts})
    whole = Params(router=ins["router"], **{k: ins[k] for k in experts})
    out = {}
    with torch.no_grad(), set_mesh(mesh):
        moe.reset_ring_stats()
        y, aux = moe.ring_moe_forward(local, ins["x"], cfg)
        out["ring_hops"] = moe.ring_stats["hops"]
        out["ring_whole_experts"] = moe.ring_moe_forward(
            whole, ins["x"], cfg)[0].numpy()
        y_ep, aux_ep = moe.moe_forward(local, ins["x"], cfg)
    y_one, aux_one = moe.moe_forward(whole, ins["x"], cfg)
    out.update(ring=y.numpy(), ep=y_ep.numpy(), one=y_one.numpy())
    for k in ("moe_aux", "moe_z", "moe_dropped"):
        out[f"ring_{k}"] = float(aux[k])
        out[f"ep_{k}"] = float(aux_ep[k])
        out[f"one_{k}"] = float(aux_one[k])
    return out


def _psum_cases() -> dict:
    """``compressed_psum`` over the data axis of a ``(2, 1)`` mesh for
    the child's steps, this rank's gradients."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.optim import ErrorFeedbackState, compressed_psum
    mesh = make_mesh((child.PSUM_RANKS, 1), ("data", "model"),
                     device_type="cpu")
    r = dist.get_rank()
    grads = child.psum_inputs()
    out, ef = {}, None
    with set_mesh(mesh):
        for s in range(child.PSUM_STEPS):
            g = {k: torch.from_numpy(grads[f"{k}/{s}/{r}"])
                 for k in child.PSUM_SHAPES}
            ef = ef or ErrorFeedbackState.init(g)
            summed, ef = compressed_psum(g, "data", ef)
            for k in g:
                out[f"{k}/{s}/sum"] = summed[k].numpy()
                out[f"{k}/{s}/resid"] = ef.residual[k].numpy()
    return out


def two_ranks(dev) -> dict:
    """Everything the file runs on 2 ranks."""
    return {"moe": _moe_cases(2), "psum": _psum_cases()}


# ---------------------------------------------------------------------------
# 4 ranks: the ring and expert parallelism, the sharded train step, the
# verifier on a 2x2 grid's plans
# ---------------------------------------------------------------------------
def _train_cases(tmp: str) -> dict:
    """The JAX weights' loss on a (2, 2) mesh; train(mesh=) for 2 steps,
    straight and stopped after 1 and resumed; each rank's shard bytes."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, shard_bytes
    from repro_torch.launch.train import train
    from repro_torch.models import convert, sharded
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    saved = torch.load(os.path.join(tmp, "llama.pt"), weights_only=False)
    cfg = get_config("llama3-8b", smoke=True)
    params = convert.params_from_jax(saved["params"], cfg, "cpu")
    sm = sharded.ShardedModel.place(params, mesh)
    batch = {k: torch.from_numpy(v) for k, v in saved["batch"].items()}
    out["loss"] = float(sharded.sharded_loss(sm, batch, cfg)[0])

    cfg = get_config(TRAIN_ARCH, smoke=True)
    st = train(cfg, mesh=mesh, device="cpu", **TRAIN)
    sm = st["params"]
    out["losses"] = st["losses"]
    out["grad_norms"] = st["grad_norms"]
    out["params"] = {n: t.numpy() for n, t in sm.gather().items()}
    want = sum(shard_bytes(sm.shapes[n], p.dtype, sm.placements[n], mesh)
               for n, p in sm.local_named().items())
    out["bytes"] = {"params": sm.local_bytes(), "want": want,
                    "moments": sum(t.numel() * t.element_size()
                                   for k in ("mu", "nu")
                                   for t in st["opt"][k].values()),
                    "whole": sum(int(np.prod(s)) * 4
                                 for s in sm.shapes.values())}
    ckpt = os.path.join(tmp, "ckpt")
    train(cfg, mesh=mesh, device="cpu", ckpt_dir=ckpt, stop_after=1,
          **TRAIN)
    dist.barrier()
    st = train(cfg, mesh=mesh, device="cpu", ckpt_dir=ckpt, **TRAIN)
    out["resumed_losses"] = st["losses"]
    out["resumed_params"] = {n: t.numpy()
                             for n, t in st["params"].gather().items()}
    return out


def verifier_combos():
    """(case name, schedule, right operand, output, wire, overlap) of the
    dispatch matrix the verifier is held on at g = 2."""
    from repro_torch.core import api
    out = []
    for alg in api.algorithms():
        for wire in ("padded", "packed"):
            out.append((f"{alg}-spmm-{wire}", alg, "b", "dense", wire,
                        "off"))
        out.append((f"{alg}-spgemm-padded-on", alg, "s", "dense", "padded",
                    "on"))
    for alg in api.sparse_algorithms():
        for wire in ("padded", "packed"):
            out.append((f"{alg}-sparse-{wire}", alg, "s", "sparse", wire,
                        "off"))
    return out


def verifier_handles(ops: dict, g: int):
    from repro_torch.core.api import DistBSR, DistDense
    a_h = DistBSR.from_dense(ops["a"], g=g, block_size=grid_child.BLOCK,
                             device=CPU)
    return {"a": a_h, "b": DistDense.for_rhs(ops["b"], a_h, device=CPU),
            "s": DistBSR.from_dense(ops["s"], g=g,
                                    block_size=grid_child.BLOCK, device=CPU)}


def bad_ring_perm(g, sign=1):
    """Every position sends to position 0: no permutation."""
    return tuple(((d + sign) % g, 0) for d in range(g))


def verifier_findings(check, lint, plan_fn, handles) -> dict:
    """Fast and full findings (as text) of every combo, and of ring_c
    under a corrupt ring permutation."""
    from repro_torch.analysis import schedule_check
    out = {}
    for name, alg, rhs, output, wire, overlap in verifier_combos():
        a_h, b_h = handles["a"], handles[rhs]
        plan = plan_fn(a_h, b_h, algorithm=alg, output=output, wire=wire,
                       overlap=overlap, cache=False)
        fast = check(plan, a_h, b_h)
        full = lint(plan, a_h, b_h) if not fast else []
        out[name] = ([str(f) for f in fast], [str(f) for f in full])
    plan = plan_fn(handles["a"], handles["b"], algorithm="ring_c",
                   cache=False)
    good = schedule_check._ring_perm
    schedule_check._ring_perm = bad_ring_perm
    try:
        out["corrupt-ring-perm"] = (
            [str(f) for f in check(plan, handles["a"], handles["b"])], [])
    finally:
        schedule_check._ring_perm = good
    return out


def _verifier_cases(dev) -> dict:
    """The verifier on the plans of a 2x2 grid's ranks; ``validate=`` on
    them; a rank whose list is not its slice."""
    from repro_torch import analysis
    from repro_torch.core import api
    from repro_torch.core.dist import make_grid_mesh
    from repro_torch.core.executor import GroupExecutor
    mesh = make_grid_mesh(2, backend="gloo", device_type="cpu")
    ex = GroupExecutor(mesh, dev)
    handles = verifier_handles(grid_child.inputs(), 2)

    def plan_fn(a, b, **kw):
        return api.plan_matmul(a, b, mesh=ex, **kw)

    out = {"findings": verifier_findings(
        analysis.check_rank_plan, analysis.lint_rank_plan, plan_fn,
        handles)}
    validated = {}
    for mode in ("fast", "full"):
        for name, alg, rhs, output, wire, overlap in verifier_combos():
            plan = plan_fn(handles["a"], handles[rhs], algorithm=alg,
                           output=output, wire=wire, overlap=overlap,
                           cache=False, validate=mode)
            validated[f"{name}/{mode}"] = sorted(plan._validated)
    out["validated"] = validated
    plan = plan_fn(handles["a"], handles["s"], algorithm="ring_c",
                   output="sparse", cache=False)
    plan._pairs[0]["pa"] = plan._pairs[0]["pa"].flip(-1)
    out["moved_list"] = [f.rule for f in analysis.check_rank_plan(
        plan, handles["a"], handles["s"])]
    return out


def four_ranks(dev, tmp: str) -> dict:
    """Everything the file runs on 4 ranks."""
    return {"moe": _moe_cases(4), "train": _train_cases(tmp),
            "verifier": _verifier_cases(dev)}


# ---------------------------------------------------------------------------
# 9 ranks: recovery onto the survivors' 2x2 grid
# ---------------------------------------------------------------------------
RECOVERY = dict(scale=6, edgefactor=8, seed=0, block_size=4, width=48,
                devices=9, lost=5)


def recovery_operands():
    from repro_torch.core.bsr import rmat_matrix
    cfg = RECOVERY
    a = rmat_matrix(scale=cfg["scale"], edgefactor=cfg["edgefactor"],
                    seed=cfg["seed"])
    b = np.random.default_rng(cfg["seed"]).standard_normal(
        (a.shape[1], cfg["width"])).astype(np.float32)
    return a, b


def survivors():
    from repro_torch.runtime.faultinject import DeviceLoss
    return DeviceLoss(RECOVERY["devices"], RECOVERY["lost"],
                      seed=RECOVERY["seed"]).survivors()


def recovery(ex) -> dict:
    """steal3d on the 3x3 grid, the seeded loss, recovery on the ranks:
    this rank's C tile (None outside the new grid) and what it sent."""
    from repro_torch.core.api import DistBSR, DistDense
    from repro_torch.runtime.replan import ElasticReplanner, ReplanConfig
    a, b = recovery_operands()
    a3 = DistBSR.from_dense(a, g=3, block_size=RECOVERY["block_size"],
                            device=CPU)
    b3 = DistDense.for_rhs(b, a3, device=CPU)
    ex.reset_counters()
    rec = ElasticReplanner(config=ReplanConfig(validate="full")) \
        .recover_from_loss(a3, b3, survivors(), mesh=ex)
    out = {"rank": ex.rank, "g": rec.g, "reshard_bytes": ex.bytes_sent(
        "place"), "tile": None}
    if rec.plan is not None:
        c = rec.plan(rec.a, rec.b)
        out.update(tile=c.tile.numpy(), position=rec.plan.executor.position,
                   validated=sorted(rec.plan._validated),
                   on_grid=rec.a.on_grid,
                   whole=c.to_global().numpy())
    return out
