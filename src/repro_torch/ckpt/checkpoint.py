"""Atomic, async checkpointing of a model and its optimizer state.

Port of ``repro/ckpt/checkpoint.py``, with its layout and guarantees:
``<dir>/step_<N>/shard_0.npz`` plus ``manifest.json``, written into a
staging directory and committed by an atomic rename (a crashed writer never
corrupts the latest checkpoint); at most ``keep`` checkpoints are kept;
saves run on a background thread, one at a time, from a host snapshot
taken when :meth:`CheckpointManager.save` is called, so training goes on
while the files are written.

Keys are the port's own: a model's parameters by name
(``named_parameters()``), and dicts flattened with ``/`` (the optimizer
state's ``step``, ``gnorm``, ``mu/<name>``, ``nu/<name>``).  numpy has no
bfloat16, so bfloat16 tensors are stored as their int16 bits and the
manifest records every key's dtype.  :meth:`CheckpointManager.restore`
copies the values into the tensors of ``like`` in place, on their devices;
a manifest whose keys or shapes differ from ``like``'s raises
``ValueError``.

A state placed on a mesh (DTensors: ``repro_torch.models.sharded``) is
saved whole: every rank gathers each tensor from its shards when
:meth:`CheckpointManager.save` is called (a collective, so every rank
calls it) and rank 0 alone writes.  A restore copies each rank's shard of
the saved values into its DTensors, so a checkpoint restores onto any
mesh whose placements divide the shapes, as the reference's
``shardings`` argument re-shards it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tensors by key: a module (or a model placed on a mesh) by parameter
    name, a dict's entries under ``<key>/``; a tuple or list's items share
    the prefix (so the pair ``(model, opt_state)`` gives parameter names
    beside ``mu/...``)."""
    if isinstance(tree, nn.Module) or hasattr(tree, "named_parameters"):
        return {prefix + n: p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    if isinstance(tree, (tuple, list)):
        flat = {}
        for v in tree:
            part = _flatten(v, prefix)
            clash = flat.keys() & part.keys()
            if clash:
                raise ValueError(f"checkpoint keys appear twice: "
                                 f"{sorted(clash)}")
            flat.update(part)
        return flat
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{prefix!r}")


def _placed(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (never a view of the tensor: the next step
    updates it in place); bfloat16 as its int16 bits.  A DTensor is
    gathered whole first (collective)."""
    if _placed(t):
        from ..launch.mesh import mesh_comm
        local = t.to_local()
        t = mesh_comm(t.device_mesh, local.device).gather_full(
            local, t.placements)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state, extra: Optional[Dict] = None):
        """Snapshot to host memory now; write (possibly async) and commit."""
        flat = _flatten((params, opt_state))
        dtypes = {k: str(v.dtype).removeprefix("torch.")
                  for k, v in flat.items()}
        host = {k: _to_host(v) for k, v in flat.items()}
        extra = dict(extra or {})
        if self._thread is not None:
            self._thread.join()          # one outstanding save at a time
        if any(_placed(v) for v in flat.values()) and dist.is_initialized() \
                and dist.get_rank() != 0:
            return                       # rank 0 writes the gathered state

        def write():
            stage = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage, exist_ok=True)
            np.savez(os.path.join(stage, "shard_0.npz"), **host)
            manifest = {
                "step": step,
                "time": time.time(),
                "keys": sorted(host),
                "dtypes": dtypes,
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "extra": extra,
            }
            with open(os.path.join(stage, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(stage, final)      # atomic commit
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Tuple
                ) -> Tuple[int, Tuple, Dict]:
        """Load checkpoint ``step`` (the latest if None) into ``like``, a
        ``(model, opt_state)`` pair (or any tree :func:`_flatten` takes),
        in place: each tensor keeps its device and dtype.  Returns (step,
        like, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = _flatten(like)
        if sorted(flat_like) != manifest["keys"]:
            missing = set(manifest["keys"]) ^ set(flat_like)
            raise ValueError(f"checkpoint/model structure mismatch: {missing}")
        wrong = {k: (manifest["shapes"][k], list(t.shape))
                 for k, t in flat_like.items()
                 if manifest["shapes"][k] != list(t.shape)}
        if wrong:
            raise ValueError(f"checkpoint/model shape mismatch (saved, "
                             f"model): {wrong}")
        with np.load(os.path.join(path, "shard_0.npz")) as z, \
                torch.no_grad():
            for k, t in flat_like.items():
                value = _from_host(z[k], manifest["dtypes"][k])
                if _placed(t):
                    from ..launch.mesh import local_chunk
                    t.to_local().copy_(local_chunk(value, t.placements,
                                                   t.device_mesh))
                else:
                    t.copy_(value)
        return step, like, manifest.get("extra", {})
