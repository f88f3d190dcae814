"""Executors: the g x g process grid stacked on one card, or one tile per
rank of a process group.

The JAX package runs each schedule body under ``shard_map``, one tile per
device, and moves tiles with ``lax.ppermute``.  Here all g² tiles of an
operand live stacked as ``[g, g, ...]`` tensors on one device:

* a ring ``ppermute`` along a mesh axis with perm ``[((d + sign) % g, d)]``
  — device d *receives* from device d + sign — is a roll of a ``[g*g]``
  tile map by ``-sign`` along grid dim 0 (``"row"`` axis) or 1 (``"col"``),
  a host composition that moves no data
  (:meth:`StackedExecutor.shift_map`): every body reads its step's tiles
  where they lie;
* a body's per-step local multiply runs on all g² tiles at once, with the
  tile index as a batch dimension (:meth:`StackedExecutor.batch`), so one
  kernel launch serves the whole grid.

:class:`GroupExecutor` runs the same schedules with one tile per rank of
a ``torch.distributed`` process group (``core/dist.py::make_grid_mesh``,
``launch/grid.py``): a ring shift is a point-to-point exchange on the
axis's subgroup (``batch_isend_irecv``, the JAX package's permutation), a
SUMMA broadcast a ``broadcast`` and an all-gather an ``all_gather``.  The
transport is explicit: ``nccl`` moves the card's tensors where each rank
has its own card; ``gloo`` moves host tensors, so a rank whose tiles lie on
the card stages them through pinned host buffers, copies it counts.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["StackedExecutor", "GroupExecutor", "AXES", "sub_grid"]

# mesh axis name -> grid dimension of the stacked tensors
AXES = {"row": 0, "col": 1}


class _TileMaps:
    """Host tile maps of a ``g x g`` grid (numpy): which placed tile each
    grid position reads after the ring shifts a schedule makes."""

    g: int

    def identity_map(self) -> np.ndarray:
        """The tile map of the placed stacks: position p reads tile p."""
        return np.arange(self.g * self.g)

    def shift_map(self, tile_map: np.ndarray, axis: str,
                  sign: int = 1) -> np.ndarray:
        """A ring shift as a composition of ``[g*g]`` tile maps (host
        numpy): position d along ``axis`` reads what position ``(d + sign)
        % g`` read.  ``tile_map[p]`` is the placed tile that grid position
        ``p = i * g + j`` reads; no tile moves."""
        grid = np.asarray(tile_map).reshape(self.g, self.g)
        return np.roll(grid, -sign, axis=AXES[axis]).reshape(-1)


class StackedExecutor(_TileMaps):
    """Runs schedule bodies over a ``g x g`` tile grid stacked on ``device``."""

    def __init__(self, g: int, device: torch.device):
        self.g = g
        self.device = torch.device(device)

    def shift(self, tree: Dict[str, torch.Tensor], axis: str,
              sign: int = 1) -> Dict[str, torch.Tensor]:
        """Ring shift of the tiles themselves: position d along ``axis``
        receives the tile at ``(d + sign) % g`` (the JAX bodies'
        ``_tree_ppermute``).  No body calls it (they compose
        :meth:`shift_map`); ``bench/faults.py``'s ``no_exchange`` patches
        it by name."""
        dim = AXES[axis]
        return {k: torch.roll(v, shifts=-sign, dims=dim)
                for k, v in tree.items()}

    def batch(self, x: torch.Tensor) -> torch.Tensor:
        """[g, g, *rest] -> [g*g, *rest]: the tile grid as a batch."""
        return x.reshape(self.g * self.g, *x.shape[2:])

    def unbatch(self, x: torch.Tensor) -> torch.Tensor:
        """[g*g, *rest] -> [g, g, *rest]."""
        return x.reshape(self.g, self.g, *x.shape[1:])


class _Exchange:
    """An exchange in flight: :meth:`result` waits for its transfers once
    (counting the host's wait) and returns the received tile tree; a
    staged receive is copied to the card first (``non_blocking``)."""

    def __init__(self, ex: "GroupExecutor", works: list, recv: Dict,
                 keep: list):
        self._ex, self._works, self._recv = ex, works, recv
        self._keep = keep            # send buffers alive until the wait
        self._tree: Optional[Dict[str, torch.Tensor]] = None

    # the host's wait for the transfer: gloo's wait returns once the bytes
    # are here; NCCL's only orders the current stream after the
    # communicator's, so there it times nothing of the device
    def result(self) -> Dict[str, torch.Tensor]:  # analysis: allow(source.perf-counter-discipline)
        if self._tree is None:
            t0 = time.perf_counter()
            for work in self._works:
                work.wait()
            self._ex.wait_s += time.perf_counter() - t0
            self._tree = {k: f() for k, f in self._recv.items()}
            self._keep = None
        return self._tree


class _Ready:
    """A tree that needs no transfer, with :class:`_Exchange`'s interface."""

    def __init__(self, tree: Dict[str, torch.Tensor]):
        self._tree = tree

    def result(self) -> Dict[str, torch.Tensor]:
        return self._tree


def _nbytes(tree: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


class GroupExecutor(_TileMaps):
    """Runs schedule bodies on one rank of a ``g x g`` process grid.

    ``mesh`` is :func:`~repro_torch.core.dist.make_grid_mesh`'s
    ``DeviceMesh`` (rank ``i * g + j`` at grid position (i, j)), or a
    square ``DeviceMesh`` over part of the world (the survivors of an
    elastic recovery, ``runtime/replan.py``) with ``group`` the process
    group of its ranks; ``device`` is the rank's compute device.  The
    rank holds its own tile of every operand; :meth:`batch` /
    :meth:`unbatch` see a one-tile grid,
    and the host tile maps (:meth:`identity_map`, :meth:`shift_map`) are the
    stacked executor's, so a plan knows which placed tile a rank holds at
    every step.  Exchanges take a tile tree (a dict of tensors, the same
    shapes on every rank) and return the received tree, or with
    ``wait=False`` an exchange whose ``result()`` waits for it.

    Every exchange moves raw bytes (``uint8`` views, so any dtype rides
    either backend).  ``sent`` records, per call, what this rank sent:
    ``(op, axis, bytes, phase)``, where a broadcast root counts its tile
    once per receiver and an all-gather its tile once per peer; ``phase``
    is :attr:`phase` at the call (``"body"`` inside a schedule body,
    ``"place"`` for placement rounds, ``"epilogue"``, ``"structure"``).
    Host staging (``gloo`` with card tiles) is counted in
    ``staged_bytes`` and timed in ``stage_s``; the host's waits for
    transfers in ``wait_s``.
    """

    def __init__(self, mesh, device, axis_row: str = "row",
                 axis_col: str = "col", group=None):
        self.mesh = mesh
        self.g = int(mesh.size(0))
        if tuple(mesh.shape) != (self.g, self.g):
            raise ValueError(f"expected a square grid mesh, got shape "
                             f"{tuple(mesh.shape)}")
        # the global rank at each grid position, increasing row-major (the
        # subgroups' ranks are sorted, so group order is position order)
        self._ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        if any(b <= a for a, b in zip(self._ranks, self._ranks[1:])):
            raise ValueError(f"the grid's ranks {self._ranks} must increase "
                             "row-major")
        if group is None and len(self._ranks) != dist.get_world_size():
            raise ValueError("a grid over part of the world needs the group "
                             "of its ranks (dist.new_group)")
        self._group = group       # all the grid's ranks (None: the world)
        self.rank = dist.get_rank()
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {self.rank} is not on the grid "
                             f"{self._ranks}")
        self.i, self.j = (int(c) for c in coord)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("backend 'nccl' moves card tensors; the rank's "
                             f"device is {self.device}")
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"unsupported backend {self.backend!r}")
        # gloo moves host tensors: card tiles stage through pinned buffers
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._wire_device = torch.device("cpu") if self.backend == "gloo" \
            else self.device
        self._groups = {"row": mesh.get_group(axis_row),
                        "col": mesh.get_group(axis_col)}
        # the staging copies' stream
        self._side = torch.cuda.Stream(self.device) if self.staged else None
        self._tag = 0
        self.phase = "body"
        self.sent: List[tuple] = []
        self.staged_bytes = 0
        self.stage_s = 0.0
        self.wait_s = 0.0

    @property
    def transport(self) -> str:
        """The backend, and whether card tiles stage through the host."""
        return f"{self.backend} (host-staged)" if self.staged \
            else self.backend

    # ---- grid arithmetic ---------------------------------------------
    @property
    def position(self) -> int:
        """This rank's grid position ``i * g + j``."""
        return self.i * self.g + self.j

    def _pos(self, axis: str) -> int:
        return self.i if axis == "row" else self.j

    def _peer(self, axis: str, d: int) -> int:
        """The global rank at position ``d`` along ``axis`` from here."""
        return self._ranks[d * self.g + self.j if axis == "row"
                           else self.i * self.g + d]

    def batch(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's tile as a one-tile grid: ``[*rest] -> [1, *rest]``."""
        return x[None]

    def unbatch(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, *rest] -> [*rest]``."""
        return x[0]

    # ---- counters ------------------------------------------------------
    def reset_counters(self) -> None:
        self.sent = []
        self.staged_bytes = 0
        self.stage_s = 0.0
        self.wait_s = 0.0

    def bytes_sent(self, phase: Optional[str] = None) -> int:
        """Bytes this rank sent since the last reset (of one phase)."""
        return sum(n for _, _, n, ph in self.sent
                   if phase is None or ph == phase)

    def _record(self, op: str, axis: str, nbytes: int) -> None:
        self.sent.append((op, axis, int(nbytes), self.phase))

    # ---- the transport ---------------------------------------------------
    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes on the transport's device: the tensor itself, or
        (staged) a pinned host copy made on a side stream after the
        current stream's work, waited for by an event before the send."""
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        if not self.staged:
            return raw
        t0 = time.perf_counter()
        host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            host.copy_(raw, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        raw.record_stream(self._side)
        done.synchronize()
        self.staged_bytes += raw.numel()
        self.stage_s += time.perf_counter() - t0
        return host

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        n = like.numel() * like.element_size()
        return torch.empty(n, dtype=torch.uint8, device=self._wire_device,
                           pin_memory=self.staged)

    def _from_wire(self, buf: torch.Tensor, like: torch.Tensor
                   ) -> torch.Tensor:
        """A received buffer as a tensor of ``like``'s shape and type on the
        rank's device."""
        if self.staged:
            # on the side stream, waited for by its event (the host holds
            # the bytes until then); the current stream then waits for it
            t0 = time.perf_counter()
            current = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._side):
                buf = buf.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._side)
            done.synchronize()
            current.wait_stream(self._side)
            buf.record_stream(current)
            self.staged_bytes += buf.numel()
            self.stage_s += time.perf_counter() - t0
        return buf.view(like.dtype).reshape(like.shape)

    def _next_tag(self, n: int) -> int:
        """Tags for the ``n`` messages of a point-to-point exchange.  Every
        rank makes the same sequence of exchange calls (a rank whose
        exchange moves nothing takes its tags all the same), so peers
        agree on them: gloo pairs messages by tag, NCCL by order, which
        the sequence also fixes."""
        tag = self._tag
        self._tag = (self._tag + n) % (1 << 24)
        return tag

    def _p2p(self, tree: Dict[str, torch.Tensor], send_to: int,
             recv_from: int, group, wait: bool, tag: int):
        ops, recv, keep = [], {}, []
        for n, (k, v) in enumerate(tree.items()):
            if v.numel() == 0:
                recv[k] = (lambda v=v: v)
                continue
            out, buf = self._to_wire(v), self._buffer(v)
            keep.append(out)
            ops.append(dist.P2POp(dist.isend, out, send_to, group, tag + n))
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, group,
                                  tag + n))
            recv[k] = (lambda buf=buf, v=v: self._from_wire(buf, v))
        works = dist.batch_isend_irecv(ops) if ops else []
        ex = _Exchange(self, works, recv, keep)
        return ex.result() if wait else ex

    # ---- exchanges -----------------------------------------------------
    def shift(self, tree: Dict[str, torch.Tensor], axis: str, sign: int = 1,
              *, wait: bool = True):
        """Ring shift along ``axis`` (the JAX bodies' ``_tree_ppermute``,
        perm ``[((d + sign) % g, d)]``): position d receives the tile of
        position ``(d + sign) % g`` and sends its own to ``(d - sign) %
        g``, on the axis's subgroup."""
        d = self._pos(axis)
        src = self._peer(axis, (d + sign) % self.g)
        dst = self._peer(axis, (d - sign) % self.g)
        tag = self._next_tag(len(tree))
        if src == self.rank:               # a shift by 0 (mod g) moves nothing
            self._record("shift", axis, 0)
            return tree if wait else _Ready(tree)
        self._record("shift", axis, _nbytes(tree))
        return self._p2p(tree, dst, src, self._groups[axis], wait, tag)

    def bcast(self, tree: Dict[str, torch.Tensor], axis: str, root: int, *,
              wait: bool = True):
        """The tile of position ``root`` along ``axis`` to every position of
        the axis (the JAX bodies' ``_tree_bcast``, a masked ``psum``): a
        ``broadcast`` on the subgroup.  The root keeps its own tree."""
        is_root = self._pos(axis) == root
        self._record("bcast", axis,
                     _nbytes(tree) * (self.g - 1) if is_root else 0)
        if self.g == 1:
            return tree if wait else _Ready(tree)
        src = self._peer(axis, root)
        works, recv, keep = [], {}, []
        for k, v in tree.items():
            if v.numel() == 0:
                recv[k] = (lambda v=v: v)
                continue
            buf = self._to_wire(v) if is_root else self._buffer(v)
            keep.append(buf)
            works.append(dist.broadcast(buf, src, group=self._groups[axis],
                                        async_op=True))
            recv[k] = (lambda v=v: v) if is_root else \
                (lambda buf=buf, v=v: self._from_wire(buf, v))
        ex = _Exchange(self, works, recv, keep)
        return ex.result() if wait else ex

    def all_gather(self, tree: Dict[str, torch.Tensor], axis: str, *,
                   wait: bool = True):
        """Every position's tile along ``axis``, stacked ``[g, *shape]`` in
        position order (``lax.all_gather``)."""
        self._record("all_gather", axis, _nbytes(tree) * (self.g - 1))
        works, recv, keep = [], {}, []
        for k, v in tree.items():
            if self.g == 1 or v.numel() == 0:
                recv[k] = (lambda v=v: v[None].expand(
                    self.g, *v.shape).contiguous())
                continue
            out = self._to_wire(v)
            bufs = [self._buffer(v) for _ in range(self.g)]
            keep.append(out)
            works.append(dist.all_gather(bufs, out,
                                         group=self._groups[axis],
                                         async_op=True))
            recv[k] = (lambda bufs=bufs, v=v: torch.stack(
                [self._from_wire(b, v) for b in bufs]))
        ex = _Exchange(self, works, recv, keep)
        return ex.result() if wait else ex

    def permute(self, tree: Dict[str, torch.Tensor], recv_from: int,
                send_to: int) -> Dict[str, torch.Tensor]:
        """One round of a tile permutation over the grid: receive the tile
        of position ``recv_from``, send this rank's to position
        ``send_to``."""
        tag = self._next_tag(len(tree))
        if recv_from == self.position and send_to == self.position:
            self._record("permute", "grid", 0)
            return tree
        self._record("permute", "grid", _nbytes(tree))
        return self._p2p(tree, self._ranks[send_to], self._ranks[recv_from],
                         self._group, True, tag)

    def gather_grid(self, tree: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Every rank's tile, ``[g, g, *shape]`` in grid order (for
        ``to_global``; not part of a multiply)."""
        out = {}
        for k, v in tree.items():
            bufs = [self._buffer(v) for _ in range(self.g * self.g)]
            dist.all_gather(bufs, self._to_wire(v), group=self._group)
            out[k] = torch.stack([self._from_wire(b, v) for b in bufs]
                                 ).reshape(self.g, self.g, *v.shape)
        return out

    def max_over_ranks(self, value: float) -> float:
        """The largest ``value`` over all ranks (an all-reduce)."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self._wire_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return float(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self._group)


def sub_grid(ex: GroupExecutor, positions) -> Optional[GroupExecutor]:
    """A square grid over ``positions`` of ``ex``'s grid (row-major, the
    first ``g * g`` of them for the largest ``g`` they fill): its
    executor on the ranks there, None elsewhere.  Collective over the
    world: every rank calls it (``dist.new_group`` and the ``DeviceMesh``
    subgroups are made by all)."""
    from torch.distributed.device_mesh import DeviceMesh
    positions = sorted(positions)
    g = int(np.sqrt(len(positions)))
    ranks = [ex._ranks[p] for p in positions[:g * g]]
    group = dist.new_group(ranks)
    mesh = DeviceMesh(ex.mesh.device_type, torch.tensor(ranks).reshape(g, g),
                      mesh_dim_names=ex.mesh.mesh_dim_names)
    if dist.get_rank() not in ranks:
        return None
    return GroupExecutor(mesh, ex.device, *mesh.mesh_dim_names, group=group)
