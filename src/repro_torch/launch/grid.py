"""Run a function on every rank of a ``g x g`` process grid.

    from repro_torch.launch.grid import run_grid
    results = run_grid(2, my_module.rank_fn, arg, backend="gloo",
                       device="cpu", timeout_s=120)

:func:`run_grid` starts ``g * g`` ranks with ``torch.multiprocessing``'s
spawn start method (a caller that has initialised CUDA cannot fork), joins
them in a ``gloo`` or ``nccl`` process group through a ``FileStore`` in a
temporary directory (no network), builds the grid's ``DeviceMesh``
(:func:`repro_torch.core.dist.make_grid_mesh`) and a
:class:`~repro_torch.core.executor.GroupExecutor` on each rank's device,
and calls ``fn(executor, *args)`` there.  It returns every rank's result
in rank order (each must pickle).  ``fn`` must live in an importable
module: the ranks start from a fresh interpreter and import it, never the
caller's ``__main__``.

A rank that raises fails the call with that rank's traceback; a grid that
runs past ``timeout_s`` is killed, every rank, and the call raises.  The
process group's own timeout is bounded by the same limit, so a hung
collective ends the rank instead of waiting out the default 30 minutes.

The JAX package has no counterpart: there, one process drives every
device of the mesh.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue as _queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List

__all__ = ["run_grid", "GridError"]


class GridError(RuntimeError):
    """A rank failed, died or outlived the grid's deadline."""


@contextlib.contextmanager
def _fresh_main():
    """Start spawned children without the caller's ``__main__``: spawn
    re-runs the parent's main script (or module) in every child unless its
    file and module name are hidden while the processes start."""
    main = sys.modules.get("__main__")
    saved = {k: main.__dict__[k] for k in ("__file__", "__spec__")
             if main is not None and k in main.__dict__}
    for k in saved:
        if k == "__spec__":
            main.__spec__ = None
        else:
            del main.__dict__[k]
    try:
        yield
    finally:
        main.__dict__.update(saved)


def _rank_entry(rank: int, g: int, store_path: str, backend: str,
                device, fn: Callable, args: tuple, results,
                timeout_s: float) -> None:
    """One rank: join the group, build the mesh and executor, run ``fn``."""
    import torch
    import torch.distributed as dist

    from ..core.dist import BACKENDS, make_grid_mesh
    from ..core.executor import GroupExecutor
    from ..runtime.device import rank_device, strict_fp32
    try:
        dev = rank_device(rank, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            # the host's cores shared among the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (g * g)))
            torch.cuda.set_device(dev)
            strict_fp32()
        store = dist.FileStore(store_path, g * g)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=g * g,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_grid_mesh(g, backend=backend,
                                  device_type=BACKENDS[backend])
            out = fn(GroupExecutor(mesh, dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:       # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
        raise


def _failures(g: int, failed: dict, results, grace_s: float = 3.0) -> str:
    """Every failed rank's traceback: a rank's failure makes its peers'
    collectives fail too, so the ranks that report within ``grace_s`` of
    the first are listed with it (the one that raised first may not be
    the first to report)."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        try:
            rank, status, value = results.get(timeout=0.2)
        except _queue.Empty:
            continue
        if status == "error":
            failed[rank] = value
    return "\n".join(f"rank {r} of the {g}x{g} grid failed:\n{failed[r]}"
                     for r in sorted(failed))


def run_grid(g: int, fn: Callable, *args, backend: str = "gloo",
             device=None, timeout_s: float = 300.0) -> List:
    """``fn(executor, *args)`` on each of the ``g * g`` ranks of a grid;
    their results in rank order.

    ``device`` is the ranks' compute device: ``"cpu"``, or ``None`` /
    ``"cuda"`` for the cards, rank r on card ``r % device_count``.
    ``backend`` is the transport (``"gloo"``: host tensors, card tiles
    staged; ``"nccl"``: one card per rank, checked before anything
    starts).
    """
    import torch.multiprocessing as mp

    from ..core.dist import BACKENDS, check_layout
    check_layout(g, backend, BACKENDS.get(backend, "?"))
    if getattr(fn, "__module__", "__main__") == "__main__":
        raise ValueError("run_grid needs a function of an importable module "
                         "(the ranks import it; they never run __main__)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_grid_")
    procs = []
    try:
        with _fresh_main():
            for rank in range(g * g):
                p = ctx.Process(
                    target=_rank_entry, daemon=True,
                    args=(rank, g, os.path.join(tmp, "store"), backend,
                          device, fn, args, results, timeout_s))
                p.start()
                procs.append(p)
        got, deadline = {}, time.monotonic() + timeout_s
        while len(got) < len(procs):
            try:
                rank, status, value = results.get(timeout=1.0)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    left = sorted(set(range(g * g)) - set(got))
                    raise GridError(
                        f"the {g}x{g} grid ran past its {timeout_s:.0f} s "
                        f"deadline; ranks {left} had not finished") from None
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead and results.empty():
                    raise GridError(
                        f"rank {dead[0]} of the {g}x{g} grid died (exit "
                        f"code {procs[dead[0]].exitcode}) without a result")
                continue
            if status == "error":
                raise GridError(_failures(g, {rank: value}, results))
            got[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(g * g)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
