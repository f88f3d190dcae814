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
import torch.utils._python_dispatch

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
    # the gradients of child.ring_loss through the ring (this rank's
    # experts) and through the single-process dense layer
    moe.reset_ring_stats()
    with set_mesh(mesh):
        out["ring_grad"] = _grads(moe.ring_moe_forward, cfg, local,
                                  ins["x"])
    out["ring_backward_hops"] = moe.ring_stats["backward_hops"]
    out["one_grad"] = _grads(moe.moe_forward, cfg, whole, ins["x"])
    for k in ("moe_aux", "moe_z", "moe_dropped"):
        out[f"ring_{k}"] = float(aux[k])
        out[f"ep_{k}"] = float(aux_ep[k])
        out[f"one_{k}"] = float(aux_one[k])
    return out


def _grads(layer, cfg, p, x) -> dict:
    """The gradients of ``child.ring_loss(layer)`` with respect to ``p``'s
    tensors (leaves made of them) and ``x``, by name."""
    from repro_torch.models.common import Params
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in p.named_parameters()}
    leaves["x"] = x.detach().clone().requires_grad_(True)
    q = Params()
    for k, t in leaves.items():
        if k != "x":
            q._parameters[k] = t
    child.ring_loss(layer, cfg)(q, leaves["x"]).backward()
    return {k: t.grad.numpy() for k, t in leaves.items()}


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


# ---------------------------------------------------------------------------
# the tensor-parallel program (test_torch_tp.py): 2 or 4 ranks a mesh
# ---------------------------------------------------------------------------
TP_TRAIN = dict(steps=2, batch=4, seq=16, lr=1e-3, seed=0, log_every=0)


def block_of(x: np.ndarray, splits, coord, sizes) -> np.ndarray:
    """The block of ``x`` at mesh ``coord`` under (mesh dim, tensor dim)
    splits in mesh order (``launch.mesh.local_chunk``)."""
    for m, d in splits:
        n = x.shape[d] // sizes[m]
        x = np.take(x, range(coord[m] * n, (coord[m] + 1) * n), axis=d)
    return x


def shard_of(x: np.ndarray, spec, coord: dict, sizes: dict) -> np.ndarray:
    """The block of ``x`` a mesh position holds under a JAX spec."""
    index = []
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        pos, parts = 0, 1
        for a in names:
            pos, parts = pos * sizes[a] + coord[a], parts * sizes[a]
        size = x.shape[d] // parts
        index.append(slice(pos * size, (pos + 1) * size))
    return x[tuple(index)]


def _placed(local: dict, placements: dict) -> dict:
    """numpy shards and their placements as (mesh dim, tensor dim) pairs
    of the split dimensions."""
    return {n: (t.detach().numpy().copy(),
                [(m, pl.dim) for m, pl in enumerate(placements[n])
                 if pl.is_shard()])
            for n, t in local.items()}


def _watching_comm(mesh, dev):
    """A recording comm that notes each transfer whose operand is a
    parameter (at rest, or as the step gathered it): (kind, axis).  The
    watched tensors are kept, so that no other tensor takes their storage
    when the step frees them."""
    from repro_torch.launch.op_analysis import OpRecorder, RecordingComm

    class Watching(RecordingComm):
        def __init__(self):
            super().__init__(mesh, dev, OpRecorder())
            self.watched, self.moved, self.kept = set(), [], []

        def watch(self, tensors):
            self.kept += tensors
            self.watched |= {t.untyped_storage()._cdata for t in tensors}

        def _note(self, t, axis, kind):
            if t.untyped_storage()._cdata in self.watched:
                self.moved.append((kind, axis))

        def gather_full(self, local, placements):
            out = super().gather_full(local, placements)
            self.watch([out])
            return out

        def gather_group(self, shards, placements, axes):
            # the shards travel in one flat buffer (a copy): noted here
            if any(t.untyped_storage()._cdata in self.watched
                   for t in shards):
                self.moved += [("all-gather", a)
                               for a in self.split_axes(placements, axes)]
            out = super().gather_group(shards, placements, axes)
            self.watch(out)
            return out

        def all_gather(self, t, axis, dim):
            self._note(t, axis, "all-gather")
            return super().all_gather(t, axis, dim)

        def all_reduce(self, t, axes, op="sum"):
            for a in axes:
                self._note(t, a, "all-reduce")
            return super().all_reduce(t, axes, op)

        def reduce_scatter(self, t, axis, dim):
            self._note(t, axis, "reduce-scatter")
            return super().reduce_scatter(t, axis, dim)

        def all_to_all(self, t, axis, split_dim, cat_dim):
            self._note(t, axis, "all-to-all")
            return super().all_to_all(t, axis, split_dim, cat_dim)

    return Watching()


class _Scatters(torch.utils._python_dispatch.TorchDispatchMode):
    """Notes the shape of every 4-d tensor an ``index_put`` fills (a MoE
    layer's dispatch buffer)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.index_put_,
                                   torch.ops.aten.index_put) \
                and out.dim() == 4:
            self.shapes.append(tuple(out.shape))
        return out


def _tp_case(name: str, tmp: str, mesh, dims) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import convert, sharded
    cfg = child.tp_config(get_config, name)
    saved = torch.load(os.path.join(tmp, f"{child._file(name)}.pt"),
                       weights_only=False)
    out = {"coord": [int(c) for c in mesh.get_coordinate()]}
    # the loss of JAX's weights, the dispatch buffers' shapes noted
    sm = sharded.ShardedModel.place(
        convert.params_from_jax(saved["params"], cfg, "cpu"), mesh)
    out["program"] = sm.program
    batch = {k: torch.from_numpy(v) for k, v in saved["batch"].items()}
    with _Scatters() as scatters:
        loss, metrics = sharded.sharded_loss(sm, batch, cfg)
    out.update(loss=float(loss), dropped=float(metrics["dropped"]),
               scatters=scatters.shapes)
    if (name, tuple(dims)) in child.TP_LOSS_CASES:
        return out
    # prefill and decode of JAX's weights, float32 caches (an encoder's
    # forward logits on the loss batch's frames)
    row = (dims[0] > 1 and name in dict(child.FAM_CASES)
           and not cfg.is_encoder)
    if cfg.is_encoder:
        frames = sharded.place_batch({"frames": batch["frames"]}, mesh)
        out["serve"] = [(sharded.sharded_prefill(sm, frames, cfg, 0)
                         .numpy(), [])]
    else:
        out["serve"] = _serve(sm, cfg, saved, mesh)
    if row:
        # one row, which the batch axes do not split
        out["serve_row"] = _serve(sm, cfg, _first_row(saved), mesh)
    out.update(_train_and_moves(cfg, mesh, saved, row))
    return out


def _first_row(saved: dict) -> dict:
    """The serving inputs of ``saved``'s first row only."""
    return {**saved, **{k: saved[k][:1] for k in ("tokens", "patches")
                        if k in saved}}


def _prompt(saved, mesh):
    """This rank's rows of the serving tokens, and its prompt: the first
    ``TP_SERVE["prompt"]`` of them (and a vlm's patches)."""
    from repro_torch.models import sharded
    toks = sharded.place_batch(
        {"tokens": torch.from_numpy(saved["tokens"])}, mesh)["tokens"]
    prompt = {"tokens": toks[:, :child.TP_SERVE["prompt"]]}
    if "patches" in saved:
        prompt["patches"] = sharded.place_batch(
            {"patches": torch.from_numpy(saved["patches"])},
            mesh)["patches"]
    return toks, prompt


def _serve(sm, cfg, saved, mesh) -> list:
    """The prefill's and each decode step's logits and cache shards."""
    from repro_torch.models import sharded
    n, steps = child.TP_SERVE["prompt"], child.TP_SERVE["steps"]
    max_len = child.serve_max_len(cfg)
    _, placements = sharded.cache_shards(cfg, saved["tokens"].shape[0],
                                         max_len, mesh, torch.float32,
                                         device="cpu")
    toks, prompt = _prompt(saved, mesh)
    logits, caches, pos = sharded.sharded_prefill(
        sm, prompt, cfg, max_len, placements, cache_dtype=torch.float32)
    serve = [(logits.numpy(), [{k: v.numpy().copy() for k, v in c.items()}
                               for c in caches])]
    step = sharded.make_sharded_decode_step(cfg)
    for t in range(n, n + steps):
        logits, caches = step(sm, toks[:, t:t + 1], caches, placements, pos)
        pos = pos + 1
        serve.append((logits.numpy(), [{k: v.numpy().copy()
                                        for k, v in c.items()}
                                       for c in caches]))
    return serve


def _train_and_moves(cfg, mesh, saved, row: bool = False) -> dict:
    """2 train steps from the port's init (losses, norms, shards and
    moments); a third step, a prefill and a decode step with every
    transfer of a parameter noted (with ``row``, a decode step of one row
    too)."""
    from repro_torch.launch.mesh import shard_bytes, use_comm
    from repro_torch.launch.train import train
    from repro_torch.models import sharded
    from repro_torch.optim import AdamW
    out = {}
    # 2 train steps from the port's init
    st = train(cfg, mesh=mesh, device="cpu", **TP_TRAIN)
    sm = st["params"]
    out["train"] = {
        "losses": st["losses"], "grad_norms": st["grad_norms"],
        "dropped": st["dropped"],
        "params": _placed(sm.local_named(), sm.placements),
        "mu": _placed(st["opt"]["mu"], sm.placements),
        "nu": _placed(st["opt"]["nu"], sm.placements),
        "param_bytes": sm.local_bytes(),
        "want_bytes": sum(shard_bytes(sm.shapes[k], p.dtype,
                                      sm.placements[k], mesh)
                          for k, p in sm.local_named().items()),
        "moment_bytes": sum(t.numel() * t.element_size()
                            for k in ("mu", "nu")
                            for t in st["opt"][k].values())}
    # one more step, every transfer of a parameter noted
    comm = _watching_comm(mesh, CPU)
    with use_comm(comm):
        sm = sharded.ShardedModel.init(cfg, mesh, seed=0, device="cpu")
        comm.watch([p.data for p in sm.local.parameters()])
        opt = AdamW(lr=1e-3)
        from repro_torch.data.pipeline import SyntheticLM
        raw = SyntheticLM(cfg, 4, 16, seed=0)(0)
        sharded.make_sharded_train_step(cfg, opt)(
            sm, opt.init(sm.local), {k: torch.as_tensor(v)
                                     for k, v in raw.items()})
        out["moved"] = sorted(set(comm.moved))
        comm.moved.clear()
        if not cfg.is_encoder:
            # a prefill, then one decode step, its transfers noted apart
            n, max_len = child.TP_SERVE["prompt"], child.serve_max_len(cfg)
            _, placements = sharded.cache_shards(
                cfg, child.TP_SERVE["batch"], max_len, mesh, torch.float32,
                device="cpu")
            toks, prompt = _prompt(saved, mesh)
            _, caches, pos = sharded.sharded_prefill(
                sm, prompt, cfg, max_len, placements,
                cache_dtype=torch.float32)
            comm.moved.clear()
            sharded.make_sharded_decode_step(cfg)(
                sm, toks[:, n:n + 1], caches, placements, pos)
            out["moved_decode"] = sorted(set(comm.moved))
            if row:
                # one row: the decode step's transfers noted apart
                row = _first_row(saved)
                _, placements = sharded.cache_shards(
                    cfg, 1, max_len, mesh, torch.float32, device="cpu")
                toks, prompt = _prompt(row, mesh)
                _, caches, pos = sharded.sharded_prefill(
                    sm, prompt, cfg, max_len, placements,
                    cache_dtype=torch.float32)
                comm.moved.clear()
                sharded.make_sharded_decode_step(cfg)(
                    sm, toks[:, n:n + 1], caches, placements, pos)
                out["moved_row_decode"] = sorted(set(comm.moved))
    out.setdefault("moved_decode", sorted(set(comm.moved)))
    return out


def fam_ranks(dev, tmp: str, dims) -> dict:
    """Every case of ``child.FAM_CASES`` on this ``(data, model)`` mesh
    of ``dims``, by name (``test_torch_tp_families.py``)."""
    from repro_torch.launch.mesh import make_mesh
    dims = tuple(dims)
    mesh = make_mesh(dims, ("data", "model"), device_type="cpu")
    return {name: _tp_case(name, tmp, mesh, dims)
            for name, m in child.FAM_CASES if m == dims}


COLLECTIVES = ("copy_to", "reduce_from", "gather_slice", "gather_sum",
               "exchange")


def collective_inputs(op: str, j: int):
    """The input and upstream gradient (float64) that model coordinate
    ``j`` feeds ``op`` (each rank its own)."""
    gen = torch.Generator().manual_seed(1000 * COLLECTIVES.index(op) + j)
    shape = (4, 8)
    return (torch.randn(shape, generator=gen, dtype=torch.float64),
            torch.randn((4, 8 * 4) if op.startswith("gather") else
                        (1, 32) if op == "exchange" else shape,
                        generator=gen, dtype=torch.float64))


def _collectives(mesh) -> dict:
    """Each autograd collective of ``MeshComm`` over ``model`` (4 ranks):
    its output and the input's gradient for this rank's inputs."""
    from repro_torch.launch.mesh import mesh_comm
    comm = mesh_comm(mesh, CPU)
    j = comm.index("model")
    calls = {"copy_to": lambda x: comm.copy_to(x, "model"),
             "reduce_from": lambda x: comm.reduce_from(x, "model"),
             "gather_slice": lambda x: comm.gather_along(x, "model", 1),
             "gather_sum": lambda x: comm.gather_along(x, "model", 1,
                                                       grad="sum"),
             "exchange": lambda x: comm.exchange(x, "model", 0, 1)}
    out = {"j": j}
    for op in COLLECTIVES:
        x, g = collective_inputs(op, j)
        x.requires_grad_(True)
        y = calls[op](x)
        y.backward(g)
        out[op] = (y.detach().numpy(), x.grad.numpy())
    return out


def tp_ranks(dev, tmp: str, dims) -> dict:
    """Every case of ``child.TP_CASES`` (and the loss of those of
    ``child.TP_LOSS_CASES``) on this ``(data, model)`` mesh of
    ``dims``, by name (and on ``(1, 4)`` the autograd collectives, under
    ``"collectives"``)."""
    from repro_torch.launch.mesh import make_mesh
    dims = tuple(dims)
    mesh = make_mesh(dims, ("data", "model"), device_type="cpu")
    out = {name: _tp_case(name, tmp, mesh, dims)
           for name, m in child.TP_CASES + child.TP_LOSS_CASES if m == dims}
    if dims == (1, 4):
        out["collectives"] = _collectives(mesh)
    return out
