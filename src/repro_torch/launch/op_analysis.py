"""Op-level profiling for the roofline analysis.

The port's counterpart of ``repro/launch/hlo_analysis.py``.  The JAX module
parses a compiled module's optimized HLO; eager PyTorch has no such module,
so this one records the aten ops a function runs, in order, under a
``TorchDispatchMode`` (:class:`OpRecorder`, which ``analysis/op_lint.py``
runs too, adding its own fields and events), together with the transfers
of the port's collective layer
(``launch/mesh.py``'s :class:`~repro_torch.launch.mesh.MeshComm`, through
:class:`RecordingComm`).  It works alike on real tensors and under
``FakeTensorMode``, where nothing is allocated (``launch/dryrun.py``).

From the recorded stream (a list of JSON-able events, so a dry run can keep
it and re-read it) :func:`stats_of` accumulates an :class:`OpStats`:

* ``dot_flops`` — 2 x (output elements) x (contraction size) for each
  ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``matmul`` / ``dot``, and
  2 x (output elements) x (weight elements per output channel) for a
  convolution (``torch.einsum`` reaches aten as ``bmm``);
* ``hbm_bytes`` — operand plus output bytes of every recorded op but the
  views and plumbing (:data:`PLUMBING_OPS`), and of every transfer;
* ``hbm_bytes_fused`` — the same sum over the ops that still touch memory
  once elementwise chains fuse (:data:`MAJOR_OPS`: products, reductions,
  gather / scatter / index, cat, sort, copies, pad) and the transfers;
* ``collective_bytes`` and ``collective_count`` by kind
  (:data:`COLLECTIVE_KINDS`), summing *operand* bytes as the JAX module
  does, and ``collective_sent``, the bytes the rank puts on the wire as
  ``MeshComm.sent`` counts them (an all-gather sends its operand to each of
  the n - 1 others).

The port has no scanned loops: a layer loop is recorded once a layer, so no
trip counts are needed.  :func:`analyze_overlap` classifies each transfer by
the compute ops recorded between its issue and its wait, and
:func:`scope_op_counts` counts ops by the ``torch.profiler.record_function``
labels around them (JAX reads ``named_scope`` metadata).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .mesh import MeshComm

__all__ = ["analyze_ops", "analyze_overlap", "scope_op_counts", "stats_of",
           "OpStats", "OverlapReport", "OpRecorder", "RecordingComm",
           "COLLECTIVE_KINDS", "PRODUCT_OPS", "MAJOR_OPS", "PLUMBING_OPS"]

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: aten products whose flops count (by overload packet name)
PRODUCT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "dot",
                         "convolution", "_convolution"})

#: ops that move no bytes of their own: allocation, aliasing, metadata
PLUMBING_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "lift_fresh_copy", "_local_scalar_dense", "set_", "resize_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type",
})

#: ops that still touch memory after elementwise fusion
MAJOR_OPS = PRODUCT_OPS | frozenset({
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "var_mean", "var", "std", "norm",
    "linalg_vector_norm", "cumsum", "cumprod", "argmax", "argmin", "any",
    "all",
    # gather / scatter / index
    "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index_put", "_index_put_impl", "index_add",
    "index_copy", "take_along_dim", "embedding",
    "embedding_dense_backward", "masked_scatter",
    # cat, sort, copies, pad
    "cat", "stack", "sort", "argsort", "topk", "copy_", "_to_copy",
    "clone", "constant_pad_nd", "roll",
})

#: ops that hide a transfer in flight (JAX's dot, convolution, reduce)
COMPUTE_OPS = PRODUCT_OPS | frozenset({"sum", "mean", "amax", "logsumexp",
                                       "_softmax", "_log_softmax"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_dims(name: str, args, out) -> Tuple[int, int]:
    """(output elements, contraction size) of a product op."""
    out_t = out if isinstance(out, torch.Tensor) else out[0]
    n_out = out_t.numel()
    if name in ("convolution", "_convolution"):
        w = args[1]
        return n_out, math.prod(w.shape[1:])
    if name == "dot":
        return 1, args[0].numel()
    lhs = args[1] if name in ("addmm", "baddbmm") else args[0]
    return n_out, lhs.shape[-1]


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
class OpRecorder(TorchDispatchMode):
    """Records the aten ops run inside ``with recorder:``, and the
    transfers of a :class:`RecordingComm` built on it, as a list of events
    (:attr:`events`):

    * ``{"op", "in", "out", "view", "scope"}`` for an aten op (its overload
      packet's name, operand and output bytes, whether it is a view or
      plumbing, the ``record_function`` labels around it joined by ``/``),
      with ``"dims"`` (output elements, contraction size) on a product;
    * ``{"coll", "id", "bytes", "sent", "out", "blocking", "scope"}`` where a
      transfer starts (its kind, operand bytes, bytes sent, bytes
      received) and ``{"wait": id}`` where the host waits for it;
    * whatever a caller adds in order with :meth:`mark`.

    ``annotate(name, operands, output)``, if given, returns fields added to
    each aten op's event (the lint's: which operand storages it reads,
    whether it copies to the host).

    It also follows the storages the recorded ops create: each output's
    untyped storage is held by a weak reference, so :attr:`live_bytes` is
    what the run holds beyond the storages it was given
    (:meth:`hold`), and :attr:`peak_bytes` its largest value.  Under
    ``FakeTensorMode`` these are the bytes the run would allocate."""

    def __init__(self, annotate: Optional[Callable] = None):
        super().__init__()
        self.annotate = annotate
        self.events: List[Dict] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known: set = set()
        self._scopes: List[Tuple[Any, str]] = []
        self._next_id = 0

    # -- storages ---------------------------------------------------------
    def hold(self, tensors) -> None:
        """Storages already allocated before the run (its arguments): not
        counted as the run's own."""
        for t in tree_flatten(tensors)[0]:
            if isinstance(t, torch.Tensor):
                self._known.add(t.untyped_storage()._cdata)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        self._known.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key, n).atexit = False

    def _freed(self, key: int, n: int) -> None:
        self._known.discard(key)
        self.live_bytes -= n

    # -- events -----------------------------------------------------------
    def _scope(self) -> str:
        return "/".join(name for _, name in self._scopes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "profiler":
            if name == "_record_function_enter_new":
                self._scopes.append((out, args[0]))
            elif name == "_record_function_exit" and self._scopes:
                handles = [h for h, _ in self._scopes]
                at = next((k for k, h in enumerate(handles)
                           if h is args[0]), len(handles) - 1)
                del self._scopes[at]
            return out
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        ev = {"op": name, "in": sum(_nbytes(x) for x in ins),
              "out": sum(_nbytes(x) for x in outs),
              "view": bool(func.is_view) or name in PLUMBING_OPS,
              "scope": self._scope()}
        if name in PRODUCT_OPS:
            ev["dims"] = list(_product_dims(name, args, out))
        if self.annotate is not None:
            ev.update(self.annotate(name, ins, out))
        self.events.append(ev)
        for x in outs:
            self._track(x)
        return out

    def collective(self, kind: str, operand: int, sent: int, received: int,
                   blocking: bool) -> int:
        """A transfer starts; returns its id (for :meth:`waited`)."""
        i = self._next_id
        self._next_id += 1
        self.events.append({"coll": kind, "id": i, "bytes": operand,
                            "sent": sent, "out": received,
                            "blocking": blocking, "scope": self._scope()})
        return i

    def waited(self, i: int) -> None:
        self.events.append({"wait": i})

    def mark(self, event: Dict) -> None:
        """Adds a caller's event in order (neither an op nor a transfer:
        :func:`stats_of` skips it)."""
        self.events.append(event)

    def stats(self) -> "OpStats":
        return stats_of(self.events)


class _Pending:
    """The work of a recorded transfer: waits for the real works (if any)
    and records the wait."""

    def __init__(self, recorder: OpRecorder, i: int, works: Sequence):
        self.recorder, self.i, self.works = recorder, i, works

    def wait(self) -> bool:
        for w in self.works:
            w.wait()
        self.recorder.waited(self.i)
        return True


class RecordingComm(MeshComm):
    """A :class:`~repro_torch.launch.mesh.MeshComm` whose transfers are
    recorded on ``recorder``: kind, operand bytes, the bytes sent (as
    ``MeshComm.sent`` counts them), issue and wait.  With ``transport``
    the transfers run as the base class runs them; without, nothing is
    sent (a fake process group under ``FakeTensorMode``, where c10d is not
    called): the receive buffers keep what they held.  Everything else,
    shapes and byte counts included, is the base class's own code."""

    def __init__(self, mesh, device, recorder: OpRecorder,
                 transport: bool = True):
        super().__init__(mesh, device)
        self.recorder = recorder
        self.transport = transport
        self._blocking = True

    def shift(self, tensors, axis, sign=1, *, wait=True):
        self._blocking = wait
        try:
            return super().shift(tensors, axis, sign, wait=wait)
        finally:
            self._blocking = True

    def _start(self, kind, operand, sent, received, start, blocking):
        works = start() if self.transport else []
        i = self.recorder.collective(kind, operand, sent, received, blocking)
        return [_Pending(self.recorder, i, works)]

    def _send_recv(self, ops, kind="collective-permute", operand=None):
        out = sum(_nbytes(o.tensor) for o in ops if o.op is dist.isend)
        return self._start(kind, out if operand is None else operand, out,
                           out,
                           lambda: MeshComm._send_recv(self, ops, kind,
                                                       operand),
                           self._blocking)

    def _gather(self, bufs, t, group):
        b = _nbytes(t)
        return self._start("all-gather", b, b * (len(bufs) - 1),
                           b * len(bufs),
                           lambda: MeshComm._gather(self, bufs, t, group),
                           True)

    def _reduce(self, t, group):
        b = _nbytes(t)
        return self._start("all-reduce", b, b, b,
                           lambda: MeshComm._reduce(self, t, group), True)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------
def _per_kind(kind_type):
    return dataclasses.field(
        default_factory=lambda: {k: kind_type(0) for k in COLLECTIVE_KINDS})


@dataclasses.dataclass
class OpStats:
    """``HloStats``'s fields, plus ``collective_sent`` (bytes on the wire
    by kind)."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0        # every op but views and plumbing
    hbm_bytes_fused: float = 0.0  # major-op boundaries
    collective_bytes: Dict[str, float] = _per_kind(float)
    collective_count: Dict[str, int] = _per_kind(int)
    collective_sent: Dict[str, float] = _per_kind(float)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def total_collective_sent(self) -> float:
        return sum(self.collective_sent.values())

    def add(self, other: "OpStats", mult: float = 1.0):
        self.dot_flops += other.dot_flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.hbm_bytes_fused += other.hbm_bytes_fused * mult
        for k in COLLECTIVE_KINDS:
            self.collective_bytes[k] += other.collective_bytes[k] * mult
            self.collective_count[k] += int(other.collective_count[k] * mult)
            self.collective_sent[k] += other.collective_sent[k] * mult


def stats_of(events: Sequence[Dict]) -> OpStats:
    """Accumulate an :class:`OpStats` over a recorded stream."""
    st = OpStats()
    for ev in events:
        if "op" in ev:
            if "dims" in ev:
                n_out, k = ev["dims"]
                st.dot_flops += 2.0 * n_out * k
            if ev["view"]:
                continue
            moved = ev["in"] + ev["out"]
            st.hbm_bytes += moved
            if ev["op"] in MAJOR_OPS:
                st.hbm_bytes_fused += moved
        elif "coll" in ev:
            kind = ev["coll"]
            st.collective_bytes[kind] += ev["bytes"]
            st.collective_count[kind] += 1
            st.collective_sent[kind] += ev["sent"]
            moved = ev["bytes"] + ev["out"]
            st.hbm_bytes += moved
            st.hbm_bytes_fused += moved
    return st


def analyze_ops(fn: Callable, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`OpRecorder` and
    return the stats of its stream (the counterpart of ``analyze_hlo``)."""
    rec = OpRecorder()
    with rec:
        fn(*args, **kwargs)
    return rec.stats()


# ---------------------------------------------------------------------------
# overlap: does a transfer have compute to hide under?
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OverlapReport:
    """How a recorded run treats its transfers (see analyze_overlap).

    ``overlapped``: asynchronous transfers with at least one compute op
    recorded between the issue and the wait.  ``serialized``: asynchronous
    transfers waited for before any compute.  ``sync``: transfers made by
    a blocking call (``MeshComm.all_gather``, ``all_reduce``,
    ``shift(wait=True)``).
    """
    overlapped: int = 0
    serialized: int = 0
    sync: int = 0
    pairs: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)   # (kind, transfer name, compute ops between)

    @property
    def async_total(self) -> int:
        return self.overlapped + self.serialized

    @property
    def eligible_fraction(self) -> float:
        """Fraction of asynchronous transfers with compute to hide under."""
        return self.overlapped / self.async_total if self.async_total else 0.0


def analyze_overlap(events: Sequence[Dict]) -> OverlapReport:
    """Classify every recorded transfer.  An asynchronous one (a
    ``MeshComm.shift(wait=False)``) whose wait comes after at least one
    compute op (:data:`COMPUTE_OPS`) is *overlapped*: the program gives
    the transport room to run under that compute.  One waited for first
    is *serialized*; one made by a blocking call is *sync*."""
    report = OverlapReport()
    for idx, ev in enumerate(events):
        if "coll" not in ev:
            continue
        if ev["blocking"]:
            report.sync += 1
            continue
        compute, done = 0, False
        for later in events[idx + 1:]:
            if later.get("wait") == ev["id"]:
                done = True
                break
            if later.get("op") in COMPUTE_OPS:
                compute += 1
        if not done:
            continue            # never waited for: a truncated stream
        if compute:
            report.overlapped += 1
        else:
            report.serialized += 1
        report.pairs.append((ev["coll"], f"{ev['coll']}.{ev['id']}",
                             compute))
    return report


def scope_op_counts(events: Sequence[Dict], scope: Optional[str] = None
                    ) -> Dict[str, int]:
    """Count recorded ops and transfers per ``record_function`` label.

    Returns ``{label: n_events}`` over every label seen (the components
    of each event's scope path, deduplicated per event); with ``scope=``
    given, only labels containing that substring are counted."""
    counts: Dict[str, int] = {}
    for ev in events:
        seen = set()
        for comp in ev.get("scope", "").split("/"):
            comp = comp.strip()
            if not comp or comp in seen:
                continue
            seen.add(comp)
            if scope is not None and scope not in comp:
                continue
            counts[comp] = counts.get(comp, 0) + 1
    return counts
