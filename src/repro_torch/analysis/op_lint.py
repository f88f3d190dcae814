"""Op-trace lint: structural rules over the ops of one multiply.

The port's counterpart of ``repro/analysis/jaxpr_lint.py``.  Eager
PyTorch has no jaxpr to walk, so this pass runs one multiply of a plan's
body under a ``TorchDispatchMode`` and records, in order:

* every aten op (its name, and whether it reads the storage of a placed
  operand);
* every call of the ops that carry a kernel (``kernels.ops``: the local
  multiplies ``bsr_spmm`` and ``bsr_pair_accumulate``, and the wire's
  ``densify``), through ``ops.add_call_hook``: the CUDA kernels run behind
  ``ctypes``, where a dispatch mode cannot see them.  The ops run inside a
  local multiply's call are the kernel's own reads, not the body's; the
  ops of a ``densify`` call are the body's own data movement and count
  as such;
* every shift of the stacked executor (``StackedExecutor.shift`` and
  ``shift_map``): this executor's ppermutes.

Rules (stable ids):

* ``optrace.step-hot-loop`` — between a kernel plan's first and last
  local multiply the body runs no ``sort``, ``argsort``, ``scatter*``,
  ``index_put``, ``nonzero`` or ``unique``: structure work belongs to
  plan time.  Bound to kernel paths only (``impl`` resolving to
  ``"cuda"``), as ``jaxpr.scan-hot-loop`` binds to the Pallas paths: the
  plain versions accumulate with ``index_add_``.
* ``optrace.no-operand-copy`` — a dense-output body with a block-sparse A
  copies no placed operand (``roll``, ``index``, ``index_select``,
  ``gather``, ``take_along_dim`` on its storage) and rolls nothing: the
  kernels read the placed stacks in place.  The sparse-output bodies
  still copy their blocks (B2 does not read through tile maps yet) and a
  dense x dense multiply runs no kernel, so neither is held to it.
* ``optrace.shift-count`` — the executor's shifts in one multiply equal
  the cost model's message count, less the last step's messages: the
  JAX bodies also shift after the last step, whose tiles nothing
  consumes, and the port does not.  Held for the RDMA-style (ring)
  schedules, whose messages are ring ppermutes; the bulk-synchronous
  ones (a SUMMA's broadcasts, steal3d's rounds) are tile-map picks here.
  Skipped at g = 1, where the ring permutations alias.
* ``optrace.overlap-carry`` — in an ``overlap="on"`` body, step t+1's
  shift is issued before step t's local multiply.  On one stream there is
  no in-flight buffer to consume, so the JAX rule's taint half has no
  counterpart; the issue order is what remains.

:func:`copy_ops` is the same spy around any callable, as ``chip_smoke.py``
uses it on whole multiplies and profiles.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = ["RULES", "COPY_OPS", "HOT_LOOP_BANNED", "OpEvent", "OpRecord",
           "record_multiply", "copy_ops", "host_transfers",
           "check_hot_loop",
           "check_operand_copies", "check_shift_count",
           "check_overlap_carry", "lint_plan"]

#: ops that copy or move a tensor: none may read a placed operand of a
#: dense-output multiply with a block-sparse A
COPY_OPS = ("roll", "index", "index_select", "gather", "take_along_dim")

#: aten ops (by base name, leading and trailing underscores dropped)
#: banned between a kernel plan's local multiplies; any ``scatter*`` too
HOT_LOOP_BANNED = ("sort", "argsort", "msort", "index_put",
                   "index_put_impl", "nonzero", "nonzero_static", "unique",
                   "unique2", "unique_dim", "unique_consecutive")

#: the ops calls that are local multiplies (the rest, the wire's densify,
#: are the body's own data movement)
MULTIPLY_CALLS = ("bsr_spmm", "bsr_pair_accumulate", "bsr_pair_matmul")

#: aten products a body runs outside any kernel call (the dense x dense
#: path's local multiply)
DENSE_PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "dot")


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One recorded event: ``kind`` is ``"op"`` (an aten op), ``"call"``
    (an ops call's ``"begin"`` or ``"end"``, in ``phase``) or ``"shift"``
    (an executor shift along ``phase`` = its axis)."""
    kind: str
    name: str
    phase: str = ""
    inside: bool = False        # within an ops call (a kernel's own reads)
    reads_operand: bool = False
    shape: Tuple[int, ...] = ()
    to_host: bool = False       # copies floating-point data off the card


@dataclasses.dataclass
class OpRecord:
    """The events of one recorded run, in order."""
    events: List[OpEvent]

    def body_ops(self) -> List[OpEvent]:
        """The aten ops outside every kernel call: the body's own."""
        return [e for e in self.events if e.kind == "op" and not e.inside]

    def shifts(self) -> List[int]:
        """Positions of the executor's shifts."""
        return [n for n, e in enumerate(self.events) if e.kind == "shift"]

    def computes(self) -> List[int]:
        """Positions of the local multiplies: each multiply call's begin
        (outermost), and each aten product outside any call."""
        out = []
        for n, e in enumerate(self.events):
            if e.kind == "call" and e.phase == "begin" and not e.inside \
                    and e.name in MULTIPLY_CALLS:
                out.append(n)
            elif e.kind == "op" and not e.inside \
                    and e.name in DENSE_PRODUCTS:
                out.append(n)
        return out


class _Recorder:
    """Collects :class:`OpEvent` s: a dispatch mode for the aten ops, a hook
    for the ops calls, wrappers for an executor's shifts."""

    def __init__(self, operands: Sequence = ()):
        import torch
        self.events: List[OpEvent] = []
        self.depth = 0
        self.ptrs = {x.untyped_storage().data_ptr() for x in operands
                     if isinstance(x, torch.Tensor) and x.numel()}

    def on_op(self, name: str, tensors, out) -> None:
        reads = any(x.untyped_storage().data_ptr() in self.ptrs
                    for x in tensors if x.numel())
        self.events.append(OpEvent(
            "op", name, inside=self.depth > 0, reads_operand=reads,
            shape=tuple(tensors[0].shape) if tensors else (),
            to_host=_to_host(name, tensors, out)))

    def on_call(self, name: str, phase: str) -> None:
        # only a local multiply's ops are the kernel's own; the wire's
        # densify is the body's data movement and stays in its record
        nest = name in MULTIPLY_CALLS
        if phase == "end" and nest:
            self.depth -= 1
        self.events.append(OpEvent("call", name, phase,
                                   inside=self.depth > 0))
        if phase == "begin" and nest:
            self.depth += 1

    def on_shift(self, name: str, axis: str) -> None:
        self.events.append(OpEvent("shift", name, axis,
                                   inside=self.depth > 0))

    @contextlib.contextmanager
    def watching(self, executor=None):
        """Record inside the block: aten ops, ops calls and (given an
        executor) its shifts."""
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        from repro_torch.kernels import ops as kops
        rec = self

        class Spy(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                tensors = [x for x in tree_flatten((args, kwargs))[0]
                           if isinstance(x, torch.Tensor)]
                out = func(*args, **kwargs)
                rec.on_op(func.overloadpacket.__name__, tensors, out)
                return out

        kops.add_call_hook(self.on_call)
        if executor is not None:
            shift, shift_map = executor.shift, executor.shift_map

            def shift_w(tree, axis, sign=1):
                rec.on_shift("shift", axis)
                return shift(tree, axis, sign)

            def shift_map_w(tile_map, axis, sign=1):
                rec.on_shift("shift_map", axis)
                return shift_map(tile_map, axis, sign)

            executor.shift, executor.shift_map = shift_w, shift_map_w
        try:
            with Spy():
                yield self
        finally:
            kops.remove_call_hook(self.on_call)
            if executor is not None:
                del executor.shift, executor.shift_map

    def record(self) -> OpRecord:
        return OpRecord(list(self.events))


def _to_host(name: str, tensors, out) -> bool:
    """Whether an op copies a floating-point tensor from a card to the
    host (``.cpu()``, ``.to("cpu")``, ``.numpy()`` through ``_to_copy``, or
    a ``copy_`` into a host tensor)."""
    import torch
    if name not in ("_to_copy", "copy_", "to") or not tensors:
        return False
    if name == "copy_":
        dst, src = tensors[0], tensors[-1]
    else:
        src = tensors[0]
        dst = out if isinstance(out, torch.Tensor) else src
    return src.is_floating_point() and src.device.type != "cpu" \
        and dst.device.type == "cpu"


def _payload(tree) -> list:
    """The placed operand tensors of a body's operand tree: its blocks
    and dense stacks (the data, not the index lists)."""
    if not isinstance(tree, dict):
        return []
    return [v for k, v in tree.items() if k in ("blocks", "dense")]


def record_multiply(plan, a, b) -> OpRecord:
    """Run the body of ``plan(a, b)`` once and record its events.

    The operands are placed first (a placement is cached on its handle,
    not part of a multiply), then the body runs as ``plan(a, b)`` runs it,
    on the plan's executor; the epilogue (unskew and crop) is left out.
    """
    from repro_torch.core import api as _api
    a_h, b_h = _api._coerce_pair(a, b, g=plan.geom.g,
                                 allow_pad=plan._allow_pad,
                                 device=plan.executor.device)
    body, operands = plan._operands(a_h, b_h)
    rec = _Recorder(_payload(operands[0]) + _payload(operands[1]))
    with rec.watching(plan.executor):
        body(*operands, plan.geom, plan.executor)
    return rec.record()


def copy_ops(fn: Callable, operands: Sequence) -> tuple:
    """``fn()`` under the recorder: each op of :data:`COPY_OPS` that reads
    the storage of one of the ``operands`` (so a copy of a reshaped view
    counts, and an op on another tensor of the same shape, such as the
    output's unskew, does not), and every ``roll`` on any tensor:
    ``(operand copies, rolls)``, as ``"aten::<op>[shape]"`` strings.
    Every op counts, those run inside an ops call too (a wrapper's own
    code, the wire's densify, a plain version on the CPU)."""
    rec = _Recorder(operands)
    with rec.watching():
        fn()
    ops = [e for e in rec.record().events if e.kind == "op"]
    hits = [f"aten::{e.name}{list(e.shape)}" for e in ops
            if e.name in COPY_OPS and e.reads_operand]
    rolls = [f"aten::roll{list(e.shape)}" for e in ops if e.name == "roll"]
    return hits, rolls


def host_transfers(fn: Callable) -> Tuple[object, List[str]]:
    """``fn()`` under the recorder: its result and every copy of
    floating-point data from a card to the host, as
    ``"aten::<op>[shape]"`` strings (index and structure reads, which are
    integer, do not count)."""
    rec = _Recorder()
    with rec.watching():
        out = fn()
    return out, [f"aten::{e.name}{list(e.shape)}"
                 for e in rec.record().events if e.to_host]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
def _banned(name: str) -> bool:
    base = name.strip("_")
    return base.startswith("scatter") or base in HOT_LOOP_BANNED


def check_hot_loop(record: OpRecord, impl: Optional[str] = None,
                   plan=None) -> List[Finding]:
    """``optrace.step-hot-loop``.  ``impl`` is the plan's (resolved on its
    device when ``plan`` is given and ``impl`` is None)."""
    if impl is None and plan is not None:
        from repro_torch.core import api as _api
        impl = "cuda" if _api._runs_kernel(plan.geom.impl,
                                           plan.executor.device) else "ref"
    if impl != "cuda":
        # the plain versions accumulate with index_add_ by design; the
        # rule binds the kernel paths
        return []
    comp = [n for n in record.computes()
            if record.events[n].kind == "call"]
    if len(comp) < 1:
        return []
    last_end = max(n for n, e in enumerate(record.events)
                   if e.kind == "call" and e.phase == "end"
                   and not e.inside and e.name in MULTIPLY_CALLS)
    offenders = sorted({e.name for e in record.events[comp[0]:last_end]
                        if e.kind == "op" and not e.inside
                        and _banned(e.name)})
    if not offenders:
        return []
    subject = f"{plan.algorithm.name}/{plan.wire}" if plan is not None \
        else ""
    return [Finding(
        "optrace.step-hot-loop",
        f"the schedule's steps run {offenders} between the kernel "
        "launches: structure work (sorting, scattering, finding nonzeros) "
        "must be hoisted to plan time, not re-done every ring step",
        subject=subject)]


def check_operand_copies(plan, record: OpRecord) -> List[Finding]:
    """``optrace.no-operand-copy`` for dense-output bodies with a
    block-sparse A."""
    if plan.symbolic is not None or plan.kind == "dense":
        return []
    ops = record.body_ops()
    copies = sorted({f"aten::{e.name}{list(e.shape)}" for e in ops
                     if e.name in COPY_OPS and e.reads_operand})
    rolls = sorted({f"aten::roll{list(e.shape)}" for e in ops
                    if e.name == "roll"})
    findings = []
    subject = f"{plan.algorithm.name}/{plan.wire}"
    if copies:
        findings.append(Finding(
            "optrace.no-operand-copy",
            f"the body copies a placed operand: {copies} — the kernels read "
            "the placed stacks in place through tile maps; a gather or "
            "roll of an operand costs a pass over its memory every "
            "multiply", subject=subject))
    if rolls:
        findings.append(Finding(
            "optrace.no-operand-copy",
            f"the dense-output body rolls {rolls} — a ring shift is a "
            "composition of tile maps (StackedExecutor.shift_map), not a "
            "copy of the stack", subject=subject))
    return findings


def check_shift_count(plan, record: OpRecord) -> List[Finding]:
    """``optrace.shift-count`` for the ring schedules at g >= 2."""
    g = plan.geom.g
    if g < 2 or plan.algorithm.style != "rdma" or plan.steal is not None:
        return []
    from repro_torch.core import api as _api
    from repro_torch.core import roofline as _roofline
    cm = plan.cost_model()
    msgs = _api._time_breakdown(cm, plan.algorithm, _roofline.H100_SXM,
                                plan.overlap)["msgs"]
    per_step = msgs if plan.algorithm.wire_amortized else msgs / cm["steps"]
    expected = int(round(msgs - per_step))
    got = len(record.shifts())
    if got == expected:
        return []
    return [Finding(
        "optrace.shift-count",
        f"one multiply makes {got} executor shift(s) but the cost model "
        f"charges {int(round(msgs))} messages, {expected} of them before "
        "the last step (the port skips the last step's shifts, whose tiles "
        "nothing consumes); the model and the schedule body have drifted — "
        "fix whichever is wrong before a machine fit calibrates against "
        "the miscount",
        subject=f"{plan.algorithm.name}/{plan.wire}")]


def check_overlap_carry(plan, record: OpRecord) -> List[Finding]:
    """``optrace.overlap-carry``: an overlap body issues step t+1's shifts
    before step t's local multiply."""
    if not plan.geom.overlap:
        return []
    g = plan.geom.g
    shifts, comp = record.shifts(), record.computes()
    if not shifts or g < 2:
        return []
    subject = f"{plan.algorithm.name}/overlap"
    if len(shifts) % (g - 1) or len(comp) % g:
        return [Finding(
            "optrace.overlap-carry",
            f"{len(shifts)} shifts and {len(comp)} local multiplies do not "
            f"split into the {g} steps of the body — the steps cannot be "
            "matched to their transfers", subject=subject)]
    per_shift, per_comp = len(shifts) // (g - 1), len(comp) // g
    findings = []
    for t in range(g - 1):
        first = comp[t * per_comp]
        issued = sum(1 for n in shifts if n < first)
        if issued < (t + 1) * per_shift:
            findings.append(Finding(
                "optrace.overlap-carry",
                f"step {t}'s local multiply runs before step {t + 1}'s "
                f"transfer is issued ({issued} of {(t + 1) * per_shift} "
                "shifts so far) — the overlap body must issue the next "
                "step's shifts first, so the transfer can fly under this "
                "step's compute", subject=subject))
            break
    return findings


RULES = (
    ("optrace.step-hot-loop",
     "no sort/scatter/index_put/nonzero/unique between a kernel plan's "
     "local multiplies"),
    ("optrace.no-operand-copy",
     "dense-output bodies with a sparse A copy no placed operand and roll "
     "nothing"),
    ("optrace.shift-count",
     "executor shifts in one multiply == cost model messages less the last "
     "step's (ring schedules, g >= 2)"),
    ("optrace.overlap-carry",
     "overlap bodies issue step t+1's shifts before step t's multiply"),
)


def lint_plan(plan, a=None, b=None, *,
              record: Optional[OpRecord] = None) -> List[Finding]:
    """Run every op-trace rule over one recorded multiply of ``plan``.

    Pass the plan's operands (handles or raw values), or a ``record`` of
    :func:`record_multiply`.
    """
    if record is None:
        if a is None or b is None:
            raise ValueError(
                "lint_plan needs the plan's operands (or record=) to run "
                "one multiply")
        record = record_multiply(plan, a, b)
    return (check_hot_loop(record, plan=plan)
            + check_operand_copies(plan, record)
            + check_shift_count(plan, record)
            + check_overlap_carry(plan, record))


def lint_rank_plan(plan, a=None, b=None) -> List[Finding]:
    """The op-trace rules for a plan on a process grid: one multiply of its
    stacked twin (``MatmulPlan.stacked_twin``, the schedule every rank
    plans alike) on the host, on host copies of the whole operands
    (gathered first where a rank holds one tile of them: collective).
    The rank's own multiply moves its tiles over the transport, which the
    stacked executor's rules do not describe."""
    from repro_torch.core import api as _api
    if a is None or b is None:
        raise ValueError("lint_rank_plan needs the plan's operands")
    a_h, b_h = (_host_copy(h) for h in _api._coerce_pair(
        a, b, g=plan.geom.g, allow_pad=plan._allow_pad,
        device=plan.executor.device, on_ranks=True))
    return lint_plan(plan.stacked_twin(a_h, b_h), a_h, b_h)


def _host_copy(h):
    """A whole-matrix handle with its values in host memory."""
    import dataclasses

    from repro_torch.core import api as _api
    if getattr(h, "on_grid", False):
        h = h.to_global()
    if h.device.type == "cpu":
        return h
    if isinstance(h, _api.DistDense):
        m, n = h.logical_shape
        return _api.DistDense.from_global(h.data[:m, :n].cpu(), h.g,
                                          rows_pad=h.shape[0],
                                          device="cpu")
    t = h.tiled
    host = dataclasses.replace(t, blocks=t.blocks.cpu(), rows=t.rows.cpu(),
                               cols=t.cols.cpu(), counts=t.counts.cpu())
    host.host_layout = t.host()
    return _api.DistBSR(host)
