"""Multi-pod dry run of the port's program on an H100 mesh.

Port of ``repro/launch/dryrun.py``.  For every (architecture x input shape
x mesh) cell this runs one rank's body of the port's own program
(``models/sharded.py``) under ``FakeTensorMode``, over a world of 256 or
512 ranks on the ``fake`` process-group backend, so that nothing is
allocated and no byte is sent.  Rank 0's recorded ops and transfers
(``launch/op_analysis.py``) give the record the JAX dry run writes:
memory, flops, collective bytes, and the roofline terms against the
H100's data-sheet constants (``core/roofline.py``), plus ``fits``,
whether the rank's peak fits the card's 80 GB, and ``program``, the
program the cell ran (``sharded.program``).  Every number is a prediction
from those constants, not a measurement.

Every config runs ``"fsdp_tp"``, JAX's FSDP x tensor-parallel program:
parameters gathered over the batch axes only, a layer at a time (again
in a train step's recomputation), each product partitioned
over ``model`` as GSPMD partitions the reference's
(``models/tensor_parallel.py``; a MoE layer's experts over ``model``, its
routing the global batch's; an SSM's or RG-LRU's heads and channels; a
frontend's projections), so a rank's product flops are JAX's.  A decode
step whose batch does not split over the batch axes (long_500k's one row)
gathers nothing and partitions its products over 'data' too.

* **train**: a :class:`~repro_torch.models.sharded.ShardedModel` with
  AdamW's moments, one ``make_sharded_train_step`` on rank 0's batch
  shard (``remat`` as the config sets it);
* **prefill**: ``sharded_prefill`` (the rank's cache shards written in
  place, or cut from a gathered ``lm.prefill``), ``transformer.forward``
  for an encoder;
* **decode**: ``make_sharded_decode_step`` on the rank's shard of
  ``init_cache`` under ``cache_specs``.

These are the dense model paths, as in JAX's dry run: the sparse serving
operators read real structure on the host and stay out.  The JAX module's
constants are a TPU v5e's and do not carry over; ``REPRO_DRYRUN_DEVICES``
has no counterpart (the world's size is the mesh's).  The fakes live on
the card's device type where the build has CUDA, else on the CPU (a
CPU-only build cannot run autograd on fake CUDA tensors); the counts do
not depend on it.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results are cached as JSON per cell (with the recorded op stream beside
each, ``<cell>.ops.json.gz``, for ``report.py --reanalyze``), so the sweep
is restartable.  ``REPRO_DRYRUN_MESH`` ("2,2", "2,4,4") runs a small
debug mesh; ``REPRO_MOE_IMPL`` overrides a MoE config's ``moe_impl``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import os
import sys
import time
import traceback
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import SHAPES, Shape, cell_supported, get_config, list_archs
from ..core.roofline import H100_SXM, H100_SXM_HBM_BYTES, H100_SXM_PEAK_OPS
from ..data.pipeline import make_batch_specs
from ..models.config import ModelConfig
from . import op_analysis
from .mesh import (P, batch_partition_spec, make_mesh, mesh_sizes,
                   set_mesh, use_comm)

__all__ = ["run_cell", "input_specs", "main", "InputSpec", "fake_world",
           "cell_config", "build_cell", "record_cell", "roofline_terms"]

# H100 80GB HBM3, 700 W (data sheet): bf16 tensor-core peak, HBM and
# NVLink (one direction's share) bandwidth, device memory
PEAK_FLOPS = H100_SXM_PEAK_OPS["bfloat16"]
HBM_BW = H100_SXM.mem_bw
NET_BW = H100_SXM.net_bw
HBM_BYTES = H100_SXM_HBM_BYTES

PRODUCTION_MESH = {"single": (16, 16), "multi": (2, 16, 16)}


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """One model input: its global shape and type, and its sharding spec
    (the batch dimension over the batch axes where they divide it)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: P

    def local_shape(self, mesh) -> Tuple[int, ...]:
        """This rank's shard's shape."""
        sizes = mesh_sizes(mesh)
        entry = self.spec[0]
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        split = math.prod(sizes[a] for a in axes)
        return (self.shape[0] // split,) + tuple(self.shape[1:])


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def input_specs(cfg: ModelConfig, shape: Shape, mesh) -> Dict[str, InputSpec]:
    """Stand-ins for every model input of this cell (``mesh`` a
    ``DeviceMesh`` or its ``{axis: size}``): exactly ``seq`` tokens at
    prefill (frames for audio, patches + text for a vlm), ``seq + 1`` at
    train (the label shift), one token at decode."""
    batch, seq = shape.batch, shape.seq
    b0 = batch_partition_spec(batch, mesh)[0]

    def spec(shp, dt):
        return InputSpec(tuple(shp), dt, P(b0, *([None] * (len(shp) - 1))))

    if shape.kind == "train":
        return {k: spec(shp, _torch_dtype(dt))
                for k, (shp, dt) in make_batch_specs(cfg, batch, seq).items()}
    if shape.kind == "prefill":
        # a prompt of exactly `seq` tokens: no label shift
        if cfg.frontend == "audio":
            return {"frames": spec((batch, seq, cfg.frontend_dim),
                                   torch.float32)}
        text = seq - (cfg.num_patches if cfg.frontend == "vlm" else 0)
        out = {"tokens": spec((batch, text), torch.int32)}
        if cfg.frontend == "vlm":
            out["patches"] = spec((batch, cfg.num_patches, cfg.frontend_dim),
                                  torch.float32)
        return out
    # decode: one token step with a cache of length shape.seq
    return {"tokens": spec((batch, 1), torch.int32)}


@contextlib.contextmanager
def fake_world(dims: Sequence[int]) -> Iterator:
    """A world of ``prod(dims)`` ranks on the ``fake`` backend (this
    process rank 0; no rank exists but this one and nothing is sent) and
    its mesh ``("data", "model")`` or ``("pod", "data", "model")``; the
    world is destroyed after the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own fake world; a process "
                           "group is already initialised here")
    dims = tuple(int(d) for d in dims)
    axes = ("pod", "data", "model")[-len(dims):]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(dims))
    try:
        yield make_mesh(dims, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _mesh_dims(mesh_kind: str, mesh_shape) -> Tuple[int, ...]:
    if mesh_shape is not None:
        return tuple(mesh_shape)
    debug = os.environ.get("REPRO_DRYRUN_MESH")
    if debug:       # e.g. "4,4" or "2,4,4": local debugging only
        return tuple(int(x) for x in debug.split(","))
    return PRODUCTION_MESH[mesh_kind]


def build_cell(cfg: ModelConfig, shape: Shape, mesh, device, *,
               uninitialised: bool = True, seed: int = 0
               ) -> Tuple[Dict[str, list], Callable]:
    """Rank 0's state for one cell, and its step: (the step's arguments by
    kind, ``"params"``, ``"moments"``, ``"batch"``, ``"cache"``, each a
    list of tensors; a thunk running the step and returning its
    outputs).  Build it inside ``use_comm`` of the comm that should carry
    the step's transfers.  ``uninitialised`` leaves the parameters
    undrawn (for ``FakeTensorMode``); the batch and caches are zeros."""
    from ..models import sharded
    from ..optim import AdamW
    sm = sharded.ShardedModel.init(cfg, mesh, seed=seed, device=device,
                                   uninitialised=uninitialised)
    params = list(sm.local.parameters())
    specs = input_specs(cfg, shape, mesh)
    batch = {k: torch.zeros(s.local_shape(mesh), dtype=s.dtype,
                            device=device) for k, s in specs.items()}
    args = {"params": params, "moments": [], "batch": list(batch.values()),
            "cache": []}
    if shape.kind == "train":
        opt = AdamW(lr=1e-4)
        state = opt.init(sm.local)
        args["moments"] = [state["step"], *state["mu"].values(),
                           *state["nu"].values(), state["gnorm"]]
        step = sharded.make_sharded_train_step(cfg, opt)

        def run():
            _, new, metrics = step(sm, state, batch, placed=True)
            return params, new, metrics
        return args, run
    if shape.kind == "prefill":
        placements = None
        if not cfg.is_encoder:
            _, placements = sharded.cache_shards(
                cfg, shape.batch, shape.seq, mesh, device=device)
        return args, lambda: sharded.sharded_prefill(sm, batch, cfg,
                                                     shape.seq, placements)
    caches, placements = sharded.cache_shards(cfg, shape.batch, shape.seq,
                                              mesh, device=device)
    args["cache"] = [t for c in caches for t in c.values()]
    step = sharded.make_sharded_decode_step(cfg)
    return args, lambda: step(sm, batch["tokens"], caches, placements,
                              shape.seq - 1)


def _storage_bytes(tensors) -> Tuple[int, set]:
    """Bytes of the distinct storages of ``tensors``, and their keys."""
    from torch.utils._pytree import tree_flatten
    seen, total = set(), 0
    for t in tree_flatten(tensors)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total, seen


def record_cell(cfg: ModelConfig, shape: Shape, mesh, device, *,
                fake: bool = True, transport: bool = False,
                seed: int = 0) -> Dict:
    """Build a cell's state and run its step once under an
    :class:`~repro_torch.launch.op_analysis.OpRecorder`, the transfers
    through a :class:`~repro_torch.launch.op_analysis.RecordingComm`
    (sending for real with ``transport``).  With ``fake`` the state and
    the step live under ``FakeTensorMode``: the dry run.  Without, the
    same program runs on real tensors (parameters drawn from ``seed``).
    Returns ``{"events", "memory" (the ``memory_analysis`` fields),
    "arguments" (bytes by kind), "stats", "sent"}`` (``sent``: the
    comm's ``MeshComm.sent``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    rec = op_analysis.OpRecorder()
    comm = op_analysis.RecordingComm(mesh, dev, rec, transport=transport)
    with FakeTensorMode() if fake else contextlib.nullcontext(), \
            use_comm(comm), set_mesh(mesh):
        args, run = build_cell(cfg, shape, mesh, dev, uninitialised=fake,
                               seed=seed)
        arg_bytes, arg_keys = _storage_bytes(list(args.values()))
        rec.hold(list(args.values()))
        with rec:
            out = run()
        out_bytes, _ = _storage_bytes(out)
        alias, _ = _storage_bytes([t for t in _tensors(out)
                                   if t.untyped_storage()._cdata in arg_keys])
        del out
    return {"events": rec.events, "sent": comm.sent,
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": rec.peak_bytes,
                       "alias_size_in_bytes": alias,
                       "generated_code_size_in_bytes": None},
            "arguments": {k: _storage_bytes(v)[0] for k, v in args.items()},
            "stats": rec.stats()}


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def roofline_terms(stats: op_analysis.OpStats, n_chips: int,
                   model_flops: float) -> Dict:
    """Per-rank roofline terms (seconds) on the H100's data-sheet rates:
    products at the bf16 peak, the fused memory traffic at the HBM rate,
    the bytes this rank puts on the wire at NVLink's one-direction share
    (the wire bytes, not the operands: an all-gather's operand is 1/n of
    what it moves)."""
    terms = {"compute_s": stats.dot_flops / PEAK_FLOPS,
             "memory_s": stats.hbm_bytes_fused / HBM_BW,
             "collective_s": stats.total_collective_sent / NET_BW}
    return {**terms, "bottleneck": max(terms, key=terms.get),
            "model_flops": model_flops,
            "useful_flops_ratio": (model_flops / (stats.dot_flops * n_chips)
                                   if stats.dot_flops else None)}


def _stats_record(stats: op_analysis.OpStats) -> Dict:
    return {"dot_flops": stats.dot_flops, "hbm_bytes": stats.hbm_bytes,
            "hbm_bytes_fused": stats.hbm_bytes_fused,
            "collective_bytes": stats.collective_bytes,
            "collective_count": stats.collective_count,
            "collective_sent": stats.collective_sent}


def _cost_record(stats: op_analysis.OpStats) -> Dict:
    """``cost_analysis``'s keys from the recorded stream: product flops and
    bytes accessed (transcendentals are not counted)."""
    return {"flops": stats.dot_flops, "bytes accessed": stats.hbm_bytes}


def cell_config(cfg: ModelConfig, mesh_kind: str) -> ModelConfig:
    """The config a cell runs: a MoE's dispatch groups are the production
    mesh's batch shards (16, or 32 on two pods), its ``moe_impl``
    ``REPRO_MOE_IMPL`` where that is set."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe_dispatch_groups=32 if mesh_kind == "multi" else 16,
        moe_impl=os.environ.get("REPRO_MOE_IMPL", cfg.moe_impl))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_path: Optional[str] = None, verbose: bool = True, *,
             cfg: Optional[ModelConfig] = None, shape: Optional[Shape] = None,
             mesh_shape: Optional[Sequence[int]] = None) -> Dict:
    """Trace one (arch, shape, mesh) cell under ``FakeTensorMode``; return
    the record dict.  ``cfg`` and ``shape`` replace the registry's
    (another size of the same cell), ``mesh_shape`` the production mesh
    (as ``REPRO_DRYRUN_MESH`` does)."""
    cfg = cell_config(cfg or get_config(arch), mesh_kind)
    shape = shape or SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape_name) if shape_name in SHAPES \
        else (True, None)
    from ..models.sharded import program
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "time": time.time(), "program": program(cfg)}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _dump(rec, out_path, verbose)
        return rec
    dims = _mesh_dims(mesh_kind, mesh_shape)
    # fake CUDA tensors where the build has CUDA; a CPU-only build aborts
    # on autograd over them, and the counts do not depend on the device
    device = "cuda" if torch.cuda.is_available() else "cpu"
    t0 = time.time()
    try:
        with fake_world(dims) as mesh:
            cell = record_cell(cfg, shape, mesh, device)
    except Exception as e:  # noqa: BLE001  (a cell's failure is its record)
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        _dump(rec, out_path, verbose)
        return rec
    t_trace = time.time() - t0
    n_chips = math.prod(dims)
    stats, mem = cell["stats"], cell["memory"]
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    rec.update(
        status="ok",
        n_chips=n_chips,
        mesh_shape=list(dims),
        device=device,
        compile_seconds=round(t_trace, 1),
        memory_analysis=mem,
        arguments=cell["arguments"],
        cost_analysis=_cost_record(stats),
        hlo_stats=_stats_record(stats),
        roofline=roofline_terms(stats, n_chips, _model_flops(cfg, shape)),
        fits=peak <= HBM_BYTES,
        peak_bytes=peak,
    )
    if out_path:    # keep the op stream for offline re-analysis
        with gzip.open(_ops_path(out_path), "wt") as f:
            json.dump(cell["events"], f)
    _dump(rec, out_path, verbose)
    return rec


def _ops_path(json_path: str) -> str:
    return json_path[:-len(".json")] + ".ops.json.gz"


def _model_flops(cfg: ModelConfig, shape: Shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D=batch x 1."""
    n = cfg.active_param_count()
    n_emb = cfg.vocab_size * cfg.d_model
    n_body = max(n - n_emb * (1 if cfg.tie_embeddings else 2), 1)
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_body * tokens
    if shape.kind == "prefill":
        return 2.0 * n_body * shape.batch * shape.seq
    return 2.0 * n_body * shape.batch  # one token per sequence


def _dump(rec: Dict, out_path: Optional[str], verbose: bool):
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2, default=float)
    if not verbose:
        return
    status = rec.get("status")
    if status == "ok":
        r = rec["roofline"]
        print(f"[ok] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:6s} {rec['program']:7s} "
              f"trace={rec['compile_seconds']}s "
              f"compute={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
              f"coll={r['collective_s']:.3e}s -> {r['bottleneck']}")
        print(f"     memory_analysis: {rec['memory_analysis']}")
        print(f"     peak {rec['peak_bytes'] / 1e9:.2f} GB a rank: "
              f"{'fits' if rec['fits'] else 'does not fit'} "
              f"{HBM_BYTES / 1e9:.0f} GB (data-sheet bound)")
        print(f"     cost_analysis: {rec['cost_analysis']}")
    elif status == "skipped":
        print(f"[skip] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:6s} -- {rec['reason']}")
    else:
        print(f"[ERR] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:6s} -- {rec.get('error')}")
        if rec.get("traceback"):
            print(rec["traceback"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true",
                   help="sweep every supported (arch x shape) cell")
    p.add_argument("--out-dir", default="results/torch_dryrun")
    p.add_argument("--force", action="store_true",
                   help="recompute cells with existing JSON")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs, shapes = list_archs(), list(SHAPES)
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        archs, shapes = [args.arch], [args.shape]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                out = os.path.join(
                    args.out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
                if not args.force and os.path.exists(out):
                    with open(out) as f:
                        rec = json.load(f)
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[cached] {arch} {shape_name} {mesh_kind} "
                              f"({rec['status']})")
                        continue
                rec = run_cell(arch, shape_name, mesh_kind, out)
                if rec.get("status") == "error":
                    failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
