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

:func:`run_ranks` starts ``n`` ranks the same way, with the same
deadline, traceback and kill rules, for a program whose mesh is not a
``g x g`` tile grid (the LM stack's ``(data, model)`` meshes of
``launch/mesh.py``): each rank joins a ``gloo`` world and calls
``fn(device, *args)`` with its compute device, and ``fn`` builds its own
mesh.

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

__all__ = ["run_grid", "run_ranks", "GridError"]


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


def _grid_body(dev, g: int, backend: str, fn: Callable, *args):
    """A grid rank's program: the grid's mesh and executor, then ``fn``."""
    from ..core.dist import BACKENDS, make_grid_mesh
    from ..core.executor import GroupExecutor
    mesh = make_grid_mesh(g, backend=backend, device_type=BACKENDS[backend])
    return fn(GroupExecutor(mesh, dev), *args)


def _rank_entry(rank: int, n: int, store_path: str, backend: str,
                device, fn: Callable, args: tuple, results,
                timeout_s: float) -> None:
    """One rank: join the world of ``n``, run ``fn(device, *args)``."""
    import torch
    import torch.distributed as dist

    from ..runtime.device import rank_device, strict_fp32
    try:
        dev = rank_device(rank, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            # the host's cores shared among the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
            torch.cuda.set_device(dev)
            strict_fp32()
        store = dist.FileStore(store_path, n)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:       # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
        raise


def _failures(what: str, failed: dict, results,
              grace_s: float = 3.0) -> str:
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
    return "\n".join(f"rank {r} of {what} failed:\n{failed[r]}"
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
    from ..core.dist import BACKENDS, check_layout
    check_layout(g, backend, BACKENDS.get(backend, "?"))
    _importable(fn, "run_grid")
    return _spawn(g * g, f"the {g}x{g} grid", _grid_body,
                  (g, backend, fn) + args, backend, device, timeout_s)


def run_ranks(n: int, fn: Callable, *args, device=None,
              timeout_s: float = 300.0) -> List:
    """``fn(device, *args)`` on each of ``n`` ranks joined in one ``gloo``
    world (``device`` the rank's compute device, as :func:`run_grid` sets
    it); their results in rank order.  ``fn`` builds its own mesh
    (``launch.mesh.make_mesh``)."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    _importable(fn, "run_ranks")
    return _spawn(n, f"the {n} ranks", fn, args, "gloo", device, timeout_s)


def _importable(fn: Callable, who: str) -> None:
    if getattr(fn, "__module__", "__main__") == "__main__":
        raise ValueError(f"{who} needs a function of an importable module "
                         "(the ranks import it; they never run __main__)")


def _spawn(n: int, what: str, fn: Callable, args: tuple, backend: str,
           device, timeout_s: float) -> List:
    """Start ``n`` ranks running ``fn(device, *args)``; their results in
    rank order, or :class:`GridError` with the failed ranks' tracebacks,
    a dead rank's exit code or the ranks past the deadline (all killed)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_grid_")
    procs = []
    try:
        with _fresh_main():
            for rank in range(n):
                p = ctx.Process(
                    target=_rank_entry, daemon=True,
                    args=(rank, n, os.path.join(tmp, "store"), backend,
                          device, fn, args, results, timeout_s))
                p.start()
                procs.append(p)
        got, deadline = {}, time.monotonic() + timeout_s
        while len(got) < len(procs):
            try:
                rank, status, value = results.get(timeout=1.0)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    left = sorted(set(range(n)) - set(got))
                    raise GridError(
                        f"{what} ran past the {timeout_s:.0f} s deadline; "
                        f"ranks {left} had not finished") from None
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead and results.empty():
                    raise GridError(
                        f"rank {dead[0]} of {what} died (exit code "
                        f"{procs[dead[0]].exitcode}) without a result")
                continue
            if status == "error":
                raise GridError(_failures(what, {rank: value}, results))
            got[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
