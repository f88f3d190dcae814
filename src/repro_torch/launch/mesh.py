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
all-gather, an all-reduce, a reduce-scatter and an all-to-all (each part
sent straight to its owner), and, as ``torch.autograd.Function`` s for a
differentiated program, copy-to (identity forward, gradient summed),
reduce-from (summed forward, gradient passed), gather-along (gradient
sliced or reduce-scattered), exchange and a mean over several axes (the
gradient averaged too).  On the ``gloo``
transport a card tensor is staged through host memory (gloo moves host
tensors), copies it counts and times; the computation stays on the card.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["P", "make_production_mesh", "make_mesh", "mesh_sizes",
           "filter_spec", "sanitize_spec", "batch_partition_spec",
           "placements_of", "placements_for", "sanitized_placements",
           "set_mesh", "current_mesh", "MeshComm", "mesh_comm", "use_comm",
           "local_chunk", "local_shape", "shard_bytes"]


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


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``placements`` (every rank's is the same)."""
    sizes = list(mesh_sizes(mesh).values())
    shape = list(shape)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            shape[pl.dim] //= sizes[m]
    return tuple(shape)


def shard_bytes(shape, dtype: torch.dtype, placements, mesh) -> int:
    """Bytes of one rank's shard of a ``shape`` tensor under
    ``placements`` (every rank's is the same size)."""
    n = 1
    for s in local_shape(shape, placements, mesh):
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
    one or more axes, and :meth:`all_gather_over` gathers over several;
    ``reduce_scatter`` and ``all_to_all`` send each coordinate its part in
    one ``batch_isend_irecv``.  :meth:`copy_to`, :meth:`reduce_from`,
    :meth:`gather_along`, :meth:`exchange` and :meth:`mean_over` are the
    same transfers with the adjoint backward.  On ``gloo`` a card
    tensor is copied to the host for the transfer and back after it (timed
    in ``stage_s``); ``sent`` counts the bytes this rank put on the wire,
    ``wait_s`` the host's waits for transfers.

    The transfers themselves go through three methods, :meth:`_send_recv`
    (told which collective its sends make up), :meth:`_gather` and
    :meth:`_reduce`, each returning the works to wait on: a subclass that
    overrides them sees every transfer this class makes, with the shapes
    and byte counts its own code gave (``launch/op_analysis.py``'s
    recording comm).
    """

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.sizes = mesh_sizes(mesh)
        self.names = tuple(self.sizes)
        self.coord = dict(zip(self.names, _coordinate(mesh)))
        self._ranks = mesh.mesh.numpy()     # global ranks, host numbers
        flat = [int(r) for r in self._ranks.reshape(-1)]
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
        self.collectives = 0
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

    # the transport: each starts its transfer and returns the works
    def _send_recv(self, ops: List, kind: str = "collective-permute",
                   operand: Optional[int] = None) -> List:
        """Start the sends and receives of ``ops`` (``P2POp`` s).  ``kind``
        names the collective they make up (a reduce-scatter and an
        all-to-all are point-to-point exchanges with every peer here),
        ``operand`` its operand's bytes where that is more than the sends'
        (a recording comm reads both)."""
        return dist.batch_isend_irecv(ops)

    def _gather(self, bufs: List[torch.Tensor], t: torch.Tensor,
                group) -> List:
        """Start gathering every member's ``t`` of ``group`` into
        ``bufs``."""
        return [dist.all_gather(bufs, t, group=group, async_op=True)]

    def _reduce(self, t: torch.Tensor, group) -> List:
        """Start summing ``t`` over ``group``, in place."""
        return [dist.all_reduce(t, group=group, async_op=True)]

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
        works = self._send_recv(ops)
        self.collectives += 1

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
        self.collectives += 1
        self._wait(self._gather(bufs, raw, self._groups[axis]))
        return self._back(torch.cat([_typed(b, h) for b in bufs], dim=dim))

    def all_gather_over(self, t: torch.Tensor, axes: Sequence[str],
                        dim: int) -> torch.Tensor:
        """Every coordinate's ``t`` over ``axes`` (in mesh order, the first
        the major one), concatenated along ``dim``: the part of coordinate
        ``(i, j)`` of axes of sizes ``(n, m)`` at position ``i * m + j``
        (no gradient)."""
        for a in reversed([a for a in self.names if a in axes]):
            t = self.all_gather(t, a, dim)
        return t

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
            self.collectives += 1
            self._wait(self._reduce(h, self._groups[a]))
            count *= self.sizes[a]
        out = self._back(h)
        return out / count if op == "mean" else out

    def _exchange(self, parts: Sequence[torch.Tensor], axis: str,
                  kind: str) -> List[torch.Tensor]:
        """Coordinate i sends ``parts[d]`` to coordinate d (d != i) and
        receives, from every coordinate d, the part d holds for i: one
        ``batch_isend_irecv``.  The list by coordinate (``parts[i]`` at
        i, as it is)."""
        n, i = self.sizes[axis], self.coord[axis]
        tag = self._tag
        self._tag = (self._tag + 1) % (1 << 24)
        group = self._groups[axis]
        ops, got, keep = [], {}, []
        hs = [self._host(p) for p in parts]
        operand = sum(h.numel() * h.element_size() for h in hs)
        for d in range(n):
            if d == i:
                continue
            raw = _raw(hs[d])
            buf = torch.empty_like(_raw(hs[i]))
            keep.append(raw)
            got[d] = buf
            self.sent += raw.numel()
            peer = self._peer(axis, d)
            ops.append(dist.P2POp(dist.isend, raw, peer, group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag))
        self.collectives += 1
        self._wait(self._send_recv(ops, kind, operand))
        keep.clear()
        return [hs[i] if d == i else _typed(got[d], hs[i])
                for d in range(n)]

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """``t`` summed over the coordinates of ``axis``, this
        coordinate's part of the sum: ``dim`` cut into equal parts in
        coordinate order, each part sent straight to its owner, which
        adds what it receives in coordinate order."""
        n = self.sizes[axis]
        if n == 1:
            return t
        parts = [p.contiguous() for p in t.chunk(n, dim)]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways")
        got = self._exchange(parts, axis, "reduce-scatter")
        out = got[0].clone()
        for p in got[1:]:
            out += p
        return self._back(out)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """``split_dim`` of ``t`` cut into equal parts, part d sent to
        coordinate d; what every coordinate sent here concatenated along
        ``cat_dim`` in coordinate order (a shard along ``cat_dim`` becomes
        one along ``split_dim``)."""
        n = self.sizes[axis]
        if n == 1:
            return t
        if t.shape[split_dim] % n:
            raise ValueError(f"dimension {split_dim} of {tuple(t.shape)} "
                             f"does not split {n} ways")
        parts = [p.contiguous() for p in t.chunk(n, split_dim)]
        got = self._exchange(parts, axis, "all-to-all")
        return self._back(torch.cat(got, dim=cat_dim))

    # the same collectives as steps of a differentiated program: each a
    # torch.autograd.Function whose backward is its adjoint
    def copy_to(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Identity forward; the gradient summed over ``axis`` (the input
        of a layer whose ranks each compute a part from it)."""
        return _CopyTo.apply(x, self, axis) if self.sizes[axis] > 1 else x

    def reduce_from(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Partial sums over ``axis`` summed forward; the gradient passed
        through as it is (every rank's part needs all of it)."""
        return _ReduceFrom.apply(x, self, axis) \
            if self.sizes[axis] > 1 else x

    def gather_along(self, x: torch.Tensor, axis: str, dim: int,
                     grad: str = "slice") -> torch.Tensor:
        """All-gather along ``dim`` forward.  Backward, this coordinate's
        part of the gradient: sliced where every rank's gradient of the
        whole is the same (``grad="slice"``, a replicated consumer), or
        summed over ``axis`` first (``"sum"``, a reduce-scatter: each rank
        used a part of the whole)."""
        if self.sizes[axis] == 1:
            return x
        if grad not in ("slice", "sum"):
            raise ValueError(f"grad={grad!r}: 'slice' or 'sum'")
        return _GatherAlong.apply(x, self, axis, dim, grad)

    def exchange(self, x: torch.Tensor, axis: str, split_dim: int,
                 cat_dim: int) -> torch.Tensor:
        """:meth:`all_to_all` forward, the reverse exchange backward."""
        return _AllToAll.apply(x, self, axis, split_dim, cat_dim) \
            if self.sizes[axis] > 1 else x

    def mean_over(self, x: torch.Tensor, axes: Sequence[str]
                  ) -> torch.Tensor:
        """The mean over the coordinates of ``axes`` forward; backward, the
        mean of the coordinates' gradients (its adjoint: each coordinate's
        input counts once in every coordinate's output)."""
        axes = tuple(a for a in axes if self.sizes[a] > 1)
        return _MeanOver.apply(x, self, axes) if axes else x

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

    # a group of parameters (FSDP's unit: one layer's, of one type and
    # one split over the batch axes) as one flat buffer
    def split_axes(self, placements, axes) -> List[str]:
        """The axes of ``axes`` (in mesh order, size > 1) that split every
        tensor of a group under ``placements``: the same for each."""
        split = [a for a in self.names if a in axes and self.sizes[a] > 1
                 and placements[0][self.names.index(a)].is_shard()]
        for pl in placements:
            mine = [a for a in self.names if a in axes and self.sizes[a] > 1
                    and pl[self.names.index(a)].is_shard()]
            if mine != split:
                raise ValueError(f"a group's tensors are split over {split} "
                                 f"and {mine}: one flat buffer needs one")
        return split

    def _cuts(self, placements, split) -> List[Tuple[int, int]]:
        return [(self.sizes[a], placements[self.names.index(a)].dim)
                for a in split]

    def gather_group(self, shards: Sequence[torch.Tensor], placements,
                     axes: Sequence[str]) -> List[torch.Tensor]:
        """Each tensor whole over the ``axes`` that split it, from every
        rank's shards (``shards``, of one type, each under its
        ``placements``, which split them over the same axes): one flat
        buffer all-gathered over those axes (the last first, as
        :meth:`gather_full`), cut back into the tensors.  The other mesh
        axes' shards are kept."""
        split = self.split_axes(placements, axes)
        if not split:
            return list(shards)
        flat = torch.cat([s.reshape(-1) for s in shards])
        parts = self.all_gather_over(flat[None], split, 0)
        del flat
        out, off = [], 0
        for s, pl in zip(shards, placements):
            n = s.numel()
            pieces = parts[:, off:off + n].reshape(-1, *s.shape)
            out.append(_joined(pieces, self._cuts(pl, split)))
            off += n
        return out

    def sum_group(self, grads: Sequence[torch.Tensor], placements,
                  axes: Sequence[str]) -> List[torch.Tensor]:
        """This rank's shard of each of ``grads`` (whole over the ``axes``
        that split it, as :meth:`gather_group` gave it) summed over
        ``axes``: one flat buffer reduce-scattered over the axes that
        split the group (each rank's part sent to it, mesh order) and
        all-reduced over the rest."""
        split = self.split_axes(placements, axes)
        rest = [a for a in axes if a not in split]
        if split:
            cuts = [self._cuts(pl, split) for pl in placements]
            n = math.prod(size for size, _ in cuts[0])
            shapes = [_cut_shape(g.shape, c) for g, c in zip(grads, cuts)]
            t = grads[0].new_empty((n, sum(math.prod(s) for s in shapes)))
            off = 0
            for g, c, shape in zip(grads, cuts, shapes):
                k = math.prod(shape)
                t[:, off:off + k] = _pieces(g, c).reshape(n, k)
                off += k
            t = t.reshape(*[self.sizes[a] for a in split], -1)
            for i, a in enumerate(split):
                t = self.reduce_scatter(t, a, i)
            flat = t.reshape(-1)
        else:
            flat = torch.cat([g.reshape(-1) for g in grads])
            shapes = [g.shape for g in grads]
        flat = self.all_reduce(flat, rest) if rest else flat
        out, off = [], 0
        for shape in shapes:
            n = math.prod(shape)
            out.append(flat[off:off + n].view(shape))
            off += n
        return out

    def gather_params(self, shards: Sequence[torch.Tensor], placements,
                      axes: Sequence[str]) -> List[torch.Tensor]:
        """:meth:`gather_group` as a step of a differentiated program
        (FSDP's gather): backward, each gradient summed over ``axes``
        onto this rank's shard (:meth:`sum_group`, one flat buffer).
        With no axis of ``axes`` larger than 1 the shards are the
        tensors."""
        if all(self.sizes[a] == 1 for a in axes):
            return list(shards)
        return list(_GatherParams.apply(self, placements, tuple(axes),
                                        *shards))

    def shift_along(self, tensors: Sequence[torch.Tensor], axis: str,
                    sign: int = 1, *, wait: bool = True):
        """:meth:`shift` as a step of a differentiated program (JAX's
        ``ppermute`` under ``jax.grad``): backward, the gradients of the
        floating-point tensors ride the reverse hop (a shift by
        ``-sign``) back to the coordinates they came from; an integer
        tensor carries none.  ``wait=False`` as :meth:`shift`'s: the
        transfer runs until the returned function is called."""
        pending = self.shift(tensors, axis, sign, wait=False)
        n = self.sizes[axis]

        def result():
            if n == 1 or sign % n == 0:
                return pending()
            return list(_Shift.apply(pending, self, axis, sign, *tensors))

        return result() if wait else result


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, [ctx.axis]), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        return comm.all_reduce(x, [axis])

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm.all_reduce(x, axes, "mean")

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, ctx.axes, "mean"), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim, grad):
        ctx.comm, ctx.axis, ctx.dim, ctx.grad = comm, axis, dim, grad
        return comm.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axis, dim = ctx.comm, ctx.axis, ctx.dim
        if ctx.grad == "sum":
            g = comm.reduce_scatter(g, axis, dim)
        else:
            g = g.chunk(comm.size(axis), dim)[comm.index(axis)]
        return g, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, split_dim, cat_dim):
        ctx.comm, ctx.axis, ctx.dims = comm, axis, (split_dim, cat_dim)
        return comm.all_to_all(x, axis, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return (ctx.comm.all_to_all(g, ctx.axis, cat_dim, split_dim), None,
                None, None, None)


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, placements, axes, *shards):
        ctx.comm, ctx.placements, ctx.axes = comm, placements, axes
        out = comm.gather_group(shards, placements, axes)
        ctx.whole = [(o.shape, o.dtype, o.device) for o in out]
        # a shard that is its whole tensor is returned as a view of it
        return tuple(o.view_as(o) if o is s else o
                     for o, s in zip(out, shards))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dt, device=dev) if g is None
                 else g for g, (shape, dt, dev) in zip(grads, ctx.whole)]
        return (None, None, None,
                *ctx.comm.sum_group(grads, ctx.placements, ctx.axes))


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pending, comm, axis, sign, *tensors):
        ctx.comm, ctx.axis, ctx.sign = comm, axis, sign
        ctx.like = [(t.shape, t.dtype, t.device) if t.is_floating_point()
                    else None for t in tensors]
        out = pending()
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.like)
                                      if f is None])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        back = iter(ctx.comm.shift(
            [torch.zeros(*f[:1], dtype=f[1], device=f[2]) if g is None
             else g for g, f in zip(grads, ctx.like) if f is not None],
            ctx.axis, -ctx.sign))
        return (None, None, None, None,
                *[None if f is None else next(back) for f in ctx.like])


def _joined(pieces: torch.Tensor, cuts) -> torch.Tensor:
    """The tensor whose shards, in row-major order over mesh axes cutting
    it as ``cuts`` says ((axis size, tensor dimension) in mesh order), are
    ``pieces`` (stacked along a leading dimension)."""
    for size, d in reversed(cuts):
        t = pieces.reshape(-1, size, *pieces.shape[1:])
        pieces = t.movedim(1, d + 1).flatten(d + 1, d + 2)
    return pieces[0]


def _cut_shape(shape, cuts) -> Tuple[int, ...]:
    """The shape of one shard of a ``shape`` tensor under ``cuts``."""
    shape = list(shape)
    for size, d in cuts:
        shape[d] //= size
    return tuple(shape)


def _pieces(whole: torch.Tensor, cuts) -> torch.Tensor:
    """Every shard of ``whole`` under ``cuts`` (as :func:`_joined`'s),
    stacked along a leading dimension in row-major order (the inverse of
    :func:`_joined`; ``local_chunk``'s cut at each coordinate)."""
    t = whole[None]
    for size, d in cuts:
        shape = t.shape
        t = t.reshape(*shape[:d + 1], size, shape[d + 1] // size,
                      *shape[d + 2:])
        t = t.movedim(d + 1, 1).reshape(shape[0] * size, *shape[1:d + 1],
                                        shape[d + 1] // size, *shape[d + 2:])
    return t


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


@contextlib.contextmanager
def use_comm(comm: MeshComm) -> Iterator[MeshComm]:
    """Inside the block :func:`mesh_comm` gives ``comm`` for its mesh and
    device (a subclass that records the transfers, say); the previous one
    after it."""
    key = (id(comm.mesh), str(comm.device))
    saved = _COMMS.get(key)
    _COMMS[key] = comm
    try:
        yield comm
    finally:
        if saved is None:
            _COMMS.pop(key, None)
        else:
            _COMMS[key] = saved
