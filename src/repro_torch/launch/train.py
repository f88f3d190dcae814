"""End-to-end training loop and its command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 30 --batch 4 --seq 32 --device cpu

Port of ``repro/launch/train.py`` (the card unless ``--device cpu``):
config registry, the synthetic data pipeline with prefetch, AdamW with a
cosine schedule, checkpoint/restart, straggler detection and preemption
handling.  Without a mesh it trains on one device.  With ``mesh=`` (a
``(data, model)`` ``DeviceMesh``, :func:`build_mesh`; every rank of it
calls :func:`train`) the parameters and moments live as each rank's
shards, placed by their sanitized specs, each rank takes its shard of
the batch, and the step is ``models/sharded.py``'s (the reference's GSPMD
step, as an explicit program on each rank: FSDP x tensor parallelism for
the attention LMs, dense and MoE, ZeRO-3 for the recurrent and frontend
families, ``sharded.program``).
:func:`selftest_parallel_equivalence` holds the sharded loss against the
single-process one.

A checkpoint is labelled with the number of steps it holds, and a resumed
job starts at that step.  The reference labels its periodic and
preemption checkpoints with the index of the step just taken, so a job
resumed from one of them takes that step's batch twice; its final
checkpoint (the one its resume test reads) is labelled as here.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np


def build_mesh(n_devices: Optional[int] = None, *, device_type="cuda"):
    """The ``(data, model)`` mesh over the world's ranks (all of them by
    default): ``choose_mesh_shape(n, max_model=16)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.elastic import choose_mesh_shape
    n = n_devices or dist.get_world_size()
    data, model = choose_mesh_shape(n, max_model=16)
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          seed: int = 0, device=None, log_every: int = 10,
          resume: bool = True, max_restarts: int = 3,
          stop_after: Optional[int] = None, params=None, mesh=None):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` (the card by default; a machine without one raises).

    ``stop_after`` stops early (crash/preemption emulation) while keeping
    the LR schedule pinned to the job's total ``steps``: a restarted job
    must see the same schedule.  ``params`` (a model on ``device``) is
    trained in place of a fresh ``init_params(cfg, seed)``, which draws
    other numbers on the CPU than on the card.  Returns ``{"params",
    "opt", "losses", "grad_norms", "aux", "dropped", "step_s"}``: the
    model, the optimizer state, and per step taken the loss, the gradient
    norm, the aux losses, the share of dropped token-expert assignments
    and the wall seconds (the card's work waited for).

    With ``mesh`` (collective: every rank of the mesh calls it alike),
    ``params`` may be a :class:`~repro_torch.models.sharded.ShardedModel`;
    a fresh one is ``ShardedModel.init(cfg, mesh, seed=seed)``, the
    single-process init cut to this rank's shards.  The returned
    ``params`` is the placed model and ``opt`` the rank's shards of the
    state; checkpoints hold the whole state (rank 0 writes it) and
    restore each rank's shards."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.models import lm, transformer as tf
    from repro_torch.obs import sync_elapsed
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import (PreemptionSignal, RestartableLoop,
                                     StragglerDetector)
    from repro_torch.runtime.device import resolve_device

    dev = resolve_device(device)
    opt = AdamW(lr=cosine_schedule(lr, max(steps // 20, 1), steps))
    if mesh is not None:
        from repro_torch.models import sharded
        if params is None:
            params = sharded.ShardedModel.init(cfg, mesh, seed=seed,
                                               device=dev)
        opt_state = opt.init(params.local)
        step_fn = sharded.make_sharded_train_step(cfg, opt)
    else:
        if params is None:
            params = tf.init_params(cfg, seed=seed, device=dev)
        opt_state = opt.init(params)
        step_fn = lm.make_train_step(cfg, opt)

    def saved(opt_state):
        """The optimizer state as a checkpoint holds it (placed on a
        mesh)."""
        if mesh is None:
            return opt_state
        return dict(opt_state, mu=params.placed_like(opt_state["mu"]),
                    nu=params.placed_like(opt_state["nu"]))

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        start_step, _, _ = mgr.restore(None, (params, saved(opt_state)))
        print(f"[train] resumed from step {start_step}")

    source = SyntheticLM(cfg, batch, seq, seed=seed)
    prefetch = Prefetcher(source, depth=2, start_step=start_step)
    straggler = StragglerDetector()
    preempt = PreemptionSignal(install=False)
    state = {"params": params, "opt": opt_state, "losses": [],
             "grad_norms": [], "aux": [], "dropped": [], "step_s": []}

    def recover() -> int:
        if not mgr:
            return 0
        s, _, _ = mgr.restore(None, (state["params"], saved(state["opt"])))
        return s

    def body(step: int):
        t0 = time.perf_counter()
        raw = prefetch.get(step)
        dev_batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in raw.items()}
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], dev_batch)
        dt = sync_elapsed(t0, metrics)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        state["losses"].append(loss)
        state["grad_norms"].append(gnorm)
        state["aux"].append(float(metrics["aux"]))
        state["dropped"].append(float(metrics["dropped"]))
        state["step_s"].append(dt)
        if straggler.observe(step, dt):
            print(f"[straggler] step {step} took {dt:.2f}s "
                  f"(mean {straggler.mean:.2f}s)")
        if log_every and step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorm:.3f} {dt * 1e3:.0f}ms")
        done = step + 1
        if mgr and done % ckpt_every == 0:
            mgr.save(done, state["params"], saved(state["opt"]),
                     extra={"loss": loss})
        if preempt.requested:
            if mgr:
                mgr.save(done, state["params"], saved(state["opt"]))
                mgr.wait()
            raise SystemExit(0)

    total = min(stop_after, steps) if stop_after else steps
    loop = RestartableLoop(total, recover, max_restarts=max_restarts,
                           on_restart=lambda s, e: print(
                               f"[restart] step {s}: {e}"))
    end = start_step
    try:
        end = loop.run(body, start_step)
    finally:
        prefetch.close()
        if mgr:
            mgr.save(end, state["params"], saved(state["opt"]))
            mgr.wait()
            if mesh is not None:
                params.comm.all_reduce(torch.zeros(1, device=dev),
                                       mesh.mesh_dim_names)   # written
    return state


# ---------------------------------------------------------------------------
# DP/TP equivalence selftest (launch/selftest.py)
# ---------------------------------------------------------------------------
def _parallel_rank(dev, n_devices: int) -> float:
    """One rank: |loss on the (data, model) mesh - single-process loss|."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, sharded, transformer as tf

    cfg = get_config("llama3-8b", smoke=True)
    params = tf.init_params(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(cfg, 4, 16, seed=1)(0).items()}
    with torch.no_grad():
        loss_ref, _ = lm.loss_fn(params, batch, cfg)
    data = max(1, n_devices // 2)
    mesh = make_mesh((data, n_devices // data), ("data", "model"),
                     device_type=dev.type)
    sm = sharded.ShardedModel.place(params, mesh)
    loss_sh, _ = sharded.sharded_loss(sm, batch, cfg)
    return abs(float(loss_ref) - float(loss_sh))


def selftest_parallel_equivalence(n_devices: int, device=None) -> bool:
    """loss(sharded over (data, model) on ``n_devices`` ranks) ==
    loss(single process), same batch (the reference's 1e-3)."""
    from repro_torch.launch.grid import run_ranks
    errs = run_ranks(n_devices, _parallel_rank, n_devices, device=device,
                     timeout_s=300)
    return max(errs) < 1e-3


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card)")
    args = p.parse_args(argv)

    from repro_torch.configs import get_config
    cfg = get_config(args.arch, smoke=args.smoke)
    state = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                  lr=args.lr, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, seed=args.seed,
                  device=args.device)
    losses = state["losses"]
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"[train] first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
              f"last-{k} mean loss {np.mean(losses[-k:]):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
