"""Production mesh construction, sharding specs and the collectives of an
explicit rank body.

Port of ``repro/launch/mesh.py``.  A sharding spec is a :class:`P`, the
counterpart of ``jax.sharding.PartitionSpec``: a tuple with one entry per
tensor dimension, each ``None`` (replicated), a mesh axis name, or a tuple
of axis names (the dimension split over several axes, the first the
major one).  :func:`filter_spec`, :func:`sanitize_spec` and
:func:`batch_partition_spec` are pure functions of the spec, the shape and
the mesh's ``{axis: size}``; ``mesh`` may be a ``DeviceMesh`` or that
mapping.

On a ``torch.distributed.device_mesh.DeviceMesh`` with dimensions
``("data", "model")`` or ``("pod", "data", "model")`` a spec becomes DTensor
placements, one per mesh dimension (:func:`placements_for`,
:func:`sanitized_placements`): ``Shard(d)`` where the axis splits tensor
dimension ``d``, ``Replicate()`` elsewhere.  A dimension split over several
axes is sharded in mesh-dimension order, which is DTensor's order, so a
spec must name them in that order (``("pod", "data")``); one that does not
is refused rather than reordered.

:func:`set_mesh` makes a mesh ambient for the models, as the JAX
package's ``set_mesh`` does.  The port runs the sharded LM stack as an
explicit program on each rank (the counterpart of ``shard_map``), and
:class:`MeshComm` holds the collectives such a body makes over one mesh
axis: a ring shift (``batch_isend_irecv``, JAX's ``ppermute``), an
all-gather and an all-reduce.  On the ``gloo`` transport a card tensor is
staged through host memory (gloo moves host tensors), copies it counts
and times; the computation stays on the card.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["P", "make_production_mesh", "make_mesh", "mesh_sizes",
           "filter_spec", "sanitize_spec", "batch_partition_spec",
           "placements_of", "placements_for", "sanitized_placements",
           "set_mesh", "current_mesh", "MeshComm", "mesh_comm",
           "local_chunk", "shard_bytes"]


class P(tuple):
    """A sharding spec: ``P("data", None, ("pod", "model"))``, one entry
    per tensor dimension (``jax.sharding.PartitionSpec``).  A tuple of one
    axis is that axis, as the reference's spec normalises it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _is_spec(x) -> bool:
    return isinstance(x, P)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or of a mapping, returned as
    a dict), in the mesh's dimension order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the initialised world (rank
    ``r`` at the row-major position ``r``) with dimension names
    ``axes``."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs an initialised "
                           f"process group of {n} ranks")
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: 16 x 16 ``("data", "model")``, or 2 x 16 x 16
    ``("pod", "data", "model")`` with ``multi_pod``, over an initialised
    world of 256 or 512 ranks.  It writes no flags: the JAX package's
    ``overlap=`` (XLA's async-collective flags) has no counterpart."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def filter_spec(spec: P, mesh) -> P:
    """Drop mesh axes a spec references that this mesh does not have
    (e.g. ``"pod"`` on the single-pod mesh)."""
    names = set(mesh_sizes(mesh))
    fixed = []
    for s in spec:
        if s is None:
            fixed.append(None)
        elif isinstance(s, tuple):
            keep = tuple(a for a in s if a in names)
            fixed.append(keep if keep else None)
        else:
            fixed.append(s if s in names else None)
    return P(*fixed)


def sanitize_spec(spec: P, shape, mesh) -> P:
    """:func:`filter_spec`, then drop axes whose size does not divide the
    tensor dimension (a tuple keeps its axes while their product
    divides)."""
    sizes = mesh_sizes(mesh)
    fixed = []
    for i, s in enumerate(filter_spec(spec, mesh)):
        dim = shape[i] if i < len(shape) else 1
        if s is None:
            fixed.append(None)
        elif isinstance(s, tuple):
            pick, prod = [], 1
            for a in s:
                if dim % (prod * sizes[a]) == 0:
                    pick.append(a)
                    prod *= sizes[a]
            fixed.append(tuple(pick) if pick else None)
        else:
            fixed.append(s if dim % sizes[s] == 0 else None)
    return P(*fixed)


def batch_partition_spec(batch_size: int, mesh, trailing: Tuple = ()) -> P:
    """Shard the batch dimension over ``("pod", "data")`` when divisible,
    else leave it unsharded (batch-1 long-context decode)."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    size = 1
    for a in axes:
        size *= sizes[a]
    if axes and batch_size % size == 0:
        return P(axes, *trailing)
    return P(None, *trailing)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements_of(spec: P, mesh) -> tuple:
    """One DTensor placement per mesh dimension for ``spec`` (already
    filtered to the mesh's axes): ``Shard(d)`` on the axes that split
    tensor dimension ``d``, ``Replicate()`` on the rest.  Refuses an axis
    named twice and a tuple whose axes are not in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec {spec!r} splits dimension {d} over {axes}, not in "
                f"the mesh's order {tuple(names)}: DTensor shards one "
                "dimension over several mesh dimensions in mesh order only")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec!r} uses mesh axis {a!r} "
                                 "twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def _tree_map(fn, tree, *rest):
    """``fn`` over the specs of a tree of dicts and lists (the other trees
    walked alongside, by key or index)."""
    if _is_spec(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def placements_for(spec_tree, mesh):
    """Tree of :class:`P` -> tree of placements on ``mesh``
    (``shardings_for``)."""
    return _tree_map(lambda s: placements_of(filter_spec(s, mesh), mesh),
                     spec_tree)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def sanitized_placements(spec_tree, shape_tree, mesh):
    """Placements with per-dimension divisibility filtering
    (``sanitized_shardings``); ``shape_tree`` holds tensors or shapes."""
    return _tree_map(
        lambda s, x: placements_of(sanitize_spec(s, _shape(x), mesh), mesh),
        spec_tree, shape_tree)


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------
_MESH: List = []


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of the models'
    rank bodies (``constrain``, ``ring_moe_forward``) inside the block."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    """The ambient mesh, or None outside :func:`set_mesh`."""
    return _MESH[-1] if _MESH else None


# ---------------------------------------------------------------------------
# shards of a tensor
# ---------------------------------------------------------------------------
def _coordinate(mesh) -> Tuple[int, ...]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    return tuple(int(c) for c in coord)


def local_chunk(full: torch.Tensor, placements, mesh,
                coord: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The piece of ``full`` that ``placements`` put at mesh coordinate
    ``coord`` (this rank's by default): each ``Shard(d)`` in mesh order
    cuts dimension ``d`` into equal parts and keeps the coordinate's (a
    view; the placements come from a sanitized spec, so they divide)."""
    coord = _coordinate(mesh) if coord is None else tuple(coord)
    sizes = list(mesh_sizes(mesh).values())
    out = full
    for m, pl in enumerate(placements):
        if pl.is_shard():
            d = pl.dim
            if out.shape[d] % sizes[m]:
                raise ValueError(f"dimension {d} of {tuple(full.shape)} "
                                 f"does not split {sizes[m]} ways")
            n = out.shape[d] // sizes[m]
            out = out.narrow(d, coord[m] * n, n)
    return out


def shard_bytes(shape, dtype: torch.dtype, placements, mesh) -> int:
    """Bytes of one rank's shard of a ``shape`` tensor under
    ``placements`` (every rank's is the same size)."""
    sizes = list(mesh_sizes(mesh).values())
    shape = list(shape)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            shape[pl.dim] //= sizes[m]
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------
class MeshComm:
    """The collectives of an explicit rank body over the axes of a
    ``DeviceMesh`` (each axis's subgroup), on the rank's ``device``.

    ``shift`` is JAX's ``ppermute`` with perm ``[((i + sign) % n, i)]``
    (coordinate i receives from i + sign) as a ``batch_isend_irecv``;
    ``all_gather`` concatenates every coordinate's tensor along a
    dimension in coordinate order; ``all_reduce`` sums (or averages) over
    one or more axes.  On ``gloo`` a card tensor is copied to the host
    for the transfer and back after it (timed in ``stage_s``); ``sent``
    counts the bytes this rank put on the wire, ``wait_s`` the host's
    waits for transfers.
    """

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.sizes = mesh_sizes(mesh)
        self.names = tuple(self.sizes)
        self.coord = dict(zip(self.names, _coordinate(mesh)))
        self._ranks = mesh.mesh
        flat = [int(r) for r in self._ranks.reshape(-1).tolist()]
        if any(b <= a for a, b in zip(flat, flat[1:])):
            raise ValueError(f"the mesh's ranks {flat} must increase "
                             "row-major")
        self._groups = {a: mesh.get_group(a) for a in self.names}
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._tag = 0
        self.reset_counters()

    def reset_counters(self) -> None:
        self.sent = 0
        self.stage_s = 0.0
        self.wait_s = 0.0

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``axis_index``)."""
        return self.coord[axis]

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def _peer(self, axis: str, d: int) -> int:
        """The global rank at coordinate ``d`` along ``axis`` from here."""
        idx = tuple(d if a == axis else self.coord[a] for a in self.names)
        return int(self._ranks[idx])

    # staging copies and transfer waits are host work: a copy to the host
    # returns once the bytes are there, gloo's wait once they arrived, and
    # a pageable copy to the card once the host may reuse its buffer
    def _host(self, t: torch.Tensor) -> torch.Tensor:  # analysis: allow(source.perf-counter-discipline)
        t = t.detach().contiguous()
        if not self.staged:
            return t
        t0 = time.perf_counter()
        h = t.cpu()
        self.stage_s += time.perf_counter() - t0
        return h

    def _back(self, h: torch.Tensor) -> torch.Tensor:  # analysis: allow(source.perf-counter-discipline)
        if not self.staged:
            return h
        t0 = time.perf_counter()
        t = h.to(self.device)
        self.stage_s += time.perf_counter() - t0
        return t

    def _wait(self, works) -> None:  # analysis: allow(source.perf-counter-discipline)
        t0 = time.perf_counter()
        for w in works:
            w.wait()
        self.wait_s += time.perf_counter() - t0

    def shift(self, tensors: Sequence[torch.Tensor], axis: str,
              sign: int = 1, *, wait: bool = True):
        """Ring shift of ``tensors`` along ``axis``: coordinate i receives
        the tensors of ``(i + sign) % n`` and sends its own to ``(i -
        sign) % n``.  With ``wait=False`` returns a function that waits
        and returns the received list (the transfer runs meanwhile)."""
        n, i = self.sizes[axis], self.coord[axis]
        tags = self._tag
        self._tag = (self._tag + len(tensors)) % (1 << 24)
        if n == 1 or sign % n == 0:
            out = list(tensors)
            return out if wait else (lambda: out)
        src = self._peer(axis, (i + sign) % n)
        dst = self._peer(axis, (i - sign) % n)
        group = self._groups[axis]
        ops, bufs, keep = [], [], []
        for k, t in enumerate(tensors):
            h = self._host(t)
            raw = _raw(h)       # bytes: any dtype rides either backend
            buf = torch.empty_like(raw)
            keep.append(raw)
            bufs.append((buf, h))
            self.sent += raw.numel()
            ops.append(dist.P2POp(dist.isend, raw, dst, group, tags + k))
            ops.append(dist.P2POp(dist.irecv, buf, src, group, tags + k))
        works = dist.batch_isend_irecv(ops)

        def result():
            self._wait(works)
            keep.clear()
            return [self._back(_typed(b, like)) for b, like in bufs]

        return result() if wait else result

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """Every coordinate's ``t`` along ``axis``, concatenated along
        ``dim`` in coordinate order."""
        n = self.sizes[axis]
        if n == 1:
            return t
        h = self._host(t)
        raw = _raw(h)
        bufs = [torch.empty_like(raw) for _ in range(n)]
        self.sent += raw.numel() * (n - 1)
        self._wait([dist.all_gather(bufs, raw, group=self._groups[axis],
                                    async_op=True)])
        return self._back(torch.cat([_typed(b, h) for b in bufs], dim=dim))

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op="sum"``) or averaged (``"mean"``, JAX's
        ``pmean``) over the coordinates of ``axes``: a new tensor, ``t``
        is left as it is."""
        axes = [a for a in axes if self.sizes[a] > 1]
        if not axes:
            return t.clone()
        h = self._host(t).clone()
        count = 1
        for a in axes:
            self.sent += h.numel() * h.element_size()
            self._wait([dist.all_reduce(h, group=self._groups[a],
                                        async_op=True)])
            count *= self.sizes[a]
        out = self._back(h)
        return out / count if op == "mean" else out

    def gather_full(self, local: torch.Tensor, placements) -> torch.Tensor:
        """The whole tensor from every rank's shard (``local``) under
        ``placements``: all-gathers over the sharding mesh dimensions, the
        last first (so a dimension split over several axes comes back in
        mesh order)."""
        out = local
        for m in reversed(range(len(self.names))):
            pl = placements[m]
            if pl.is_shard():
                out = self.all_gather(out, self.names[m], pl.dim)
        return out


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _typed(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.view(like.dtype).reshape(like.shape)


_COMMS: Dict[tuple, MeshComm] = {}


def mesh_comm(mesh, device) -> MeshComm:
    """The :class:`MeshComm` of ``mesh`` on ``device``, made once."""
    key = (id(mesh), str(torch.device(device)))
    comm = _COMMS.get(key)
    if comm is None or comm.mesh is not mesh:
        comm = _COMMS[key] = MeshComm(mesh, device)
    return comm
