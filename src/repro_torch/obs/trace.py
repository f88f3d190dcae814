"""Span-based execution tracing with Chrome-trace (Perfetto) export.

Port of ``repro/obs/trace.py``.  Tracing is off by default.  When off,
``span()``, ``launch()`` and ``call()`` return one shared no-op context
manager — no allocation, no clock read, no CUDA event, no
synchronisation — so instrumented hot paths (plan calls, kernel
launches) pay a single boolean check.  When on, each span records a
Chrome-trace "complete" event (``ph: "X"``) with microsecond
``ts``/``dur``, the recording thread's id, and any keyword attributes
under ``args``.  Perfetto reconstructs the stack per thread from interval
containment; the thread-local depth is recorded too.

Clock: the Unix time in ns is read once, at import, as the trace's base;
``ts`` is microseconds from it, advanced by ``perf_counter_ns``.
``export_trace`` writes the base as ``baseTimeNanoseconds``, as
``torch.profiler``'s Chrome export does, so ``baseTimeNanoseconds + ts *
1e3`` is the Unix time in both files and they load as one timeline.

Calls: ``call()`` opens one multiply's scope.  It takes a per-process id,
thread-local for the scope, which every span and marker opened in it
carries as ``args.call``, so a reader groups a call's spans without
interval containment; ``launch()`` spans are numbered within it
(``args.launch``).

Device time: a span given ``device=`` (a tensor or a device; on the card)
also records a CUDA event pair on that device's current stream, at entry
and at exit.  The pair is kept pending and read into the span's
``args.device_ms`` only when the events are read (``events()``,
``export_trace()``), never on the hot path: kernel launches return
before the card has run them, and the pair times the work without a
wait.

Timing helpers: ``sync_elapsed`` (wait until the card has finished the
work on the tensors of a tree, then read the clock) and ``timed`` (time a
thunk with a trailing synchronisation); a clock read without the wait
measures the launch, not the work.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, List, Optional

# Trace-buffer cap: ~100k spans bounds memory for runaway traced loops;
# drops are counted and surfaced in export metadata.  Device pairs are
# kept only for buffered events, so the same cap bounds them.
_MAX_EVENTS = 100_000


class _State:
    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.events: List[Dict] = []
        self.dropped = 0
        # (event, DevicePair) not yet read into the event's device_ms
        self.pending: List = []
        # the trace's base: Unix ns, read once; ts advances by perf_counter
        self.base_ns = time.time_ns()
        self.pc0_ns = time.perf_counter_ns()
        self.calls = itertools.count(1)


_STATE = _State()
_TLS = threading.local()


def _ts(pc_ns: int) -> float:
    """Microseconds from the trace's base at ``perf_counter_ns`` reading
    ``pc_ns``."""
    return (pc_ns - _STATE.pc0_ns) / 1e3


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass

    pair = None


_NULL_SPAN = _NullSpan()


class DevicePair:
    """Two CUDA timing events on one stream: the first recorded when the
    pair is made, the second by :meth:`stop`.  :meth:`seconds` waits for
    the second and reads the time between them (once; then cached).  A
    drift record holds a pair as its pending ``measured_s``."""

    __slots__ = ("_stream", "_start", "_end", "_s")

    def __init__(self, stream):
        import torch   # deferred: the package imports only the standard library
        self._stream = stream
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._s: Optional[float] = None
        self._start.record(stream)

    def stop(self) -> None:
        self._end.record(self._stream)

    def seconds(self) -> float:
        if self._s is None:
            self._end.synchronize()
            self._s = self._start.elapsed_time(self._end) / 1e3
        return self._s


def _device_pair(device) -> Optional[DevicePair]:
    """A started pair on the current stream of ``device`` (a tensor or a
    device), or None off the card."""
    import torch
    dev = device.device if isinstance(device, torch.Tensor) \
        else torch.device(device)
    if dev.type != "cuda":
        return None
    return DevicePair(torch.cuda.current_stream(dev))


class _Span:
    __slots__ = ("name", "args", "pair", "_device", "_start", "_depth")

    def __init__(self, name: str, args: Dict, device=None):
        self.name = name
        self.args = args
        self.pair: Optional[DevicePair] = None
        self._device = device
        self._start = 0
        self._depth = 0

    def note(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. cache hit/miss)."""
        self.args.update(attrs)

    def __enter__(self):
        depth = getattr(_TLS, "depth", 0)
        _TLS.depth = depth + 1
        self._depth = depth
        call = getattr(_TLS, "call", None)
        if call is not None:
            self.args["call"] = call
        self._start = time.perf_counter_ns()
        if self._device is not None:    # last: nearest the work it times
            self.pair = _device_pair(self._device)
        return self

    def __exit__(self, *exc):
        if self.pair is not None:       # first: nearest the work it times
            self.pair.stop()
        end = time.perf_counter_ns()
        _TLS.depth = self._depth
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": "repro_torch",
            "ts": _ts(self._start),
            "dur": (end - self._start) / 1e3,
            "pid": 0,
            "tid": threading.get_ident() % 2**31,
            "args": dict(self.args, depth=self._depth),
        }
        with _STATE.lock:
            if len(_STATE.events) < _MAX_EVENTS:
                _STATE.events.append(ev)
                if self.pair is not None:
                    _STATE.pending.append((ev, self.pair))
            else:
                _STATE.dropped += 1
        return False


class _Call:
    __slots__ = ("id",)

    def __init__(self, call_id: int):
        self.id = call_id

    def __enter__(self):
        _TLS.call, _TLS.launches = self.id, 0
        return self

    def __exit__(self, *exc):
        _TLS.call = None
        return False


def enable(clear: bool = False) -> None:
    """Turn tracing on; ``clear=True`` also drops buffered events."""
    if clear:
        clear_trace()
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def span(name: str, device=None, **attrs):
    """Context manager recording a Chrome-trace span while tracing is on.

    ``device`` (a tensor or a device): on the card, the span also times
    the work launched inside it on that device's current stream with a
    CUDA event pair (``args.device_ms``, read when events are read).
    Returns a shared inert object when tracing is off — safe (and ~free)
    to leave on hot paths unconditionally.
    """
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs, device)


def launch(name: str, device=None):
    """A span around one kernel launch: :func:`span` with ``device``, and
    ``args.launch`` its number among the launches of the current call
    (from 0)."""
    if not _STATE.enabled:
        return _NULL_SPAN
    k = getattr(_TLS, "launches", 0)
    _TLS.launches = k + 1
    return _Span(name, {"launch": k}, device)


def call():
    """One call's scope (a multiply): a new per-process id that the spans
    opened inside carry as ``args.call``.  Inside a scope already open
    (``matmul`` calls a plan, which opens one too) it joins that one."""
    if not _STATE.enabled or getattr(_TLS, "call", None) is not None:
        return _NULL_SPAN
    return _Call(next(_STATE.calls))


def instant(name: str, **attrs) -> None:
    """Record a zero-duration marker event (rendered as a span of dur 0)."""
    if not _STATE.enabled:
        return
    call_id = getattr(_TLS, "call", None)
    if call_id is not None:
        attrs["call"] = call_id
    ev = {
        "ph": "X",
        "name": name,
        "cat": "repro_torch",
        "ts": _ts(time.perf_counter_ns()),
        "dur": 0.0,
        "pid": 0,
        "tid": threading.get_ident() % 2**31,
        "args": dict(attrs),
    }
    with _STATE.lock:
        if len(_STATE.events) < _MAX_EVENTS:
            _STATE.events.append(ev)
        else:
            _STATE.dropped += 1


def _resolve_pending() -> None:
    """Read every pending device pair into its event's ``device_ms`` (a
    wait for the card where its work is still running)."""
    with _STATE.lock:
        pending, _STATE.pending = _STATE.pending, []
    for ev, pair in pending:
        ev["args"]["device_ms"] = pair.seconds() * 1e3


def events() -> List[Dict]:
    """Copy of the buffered events (oldest first), device pairs read."""
    _resolve_pending()
    with _STATE.lock:
        return list(_STATE.events)


def clear_trace() -> None:
    with _STATE.lock:
        _STATE.events = []
        _STATE.pending = []
        _STATE.dropped = 0


def export_trace(path: Optional[str] = None) -> Dict:
    """Render buffered spans as a Chrome-trace JSON object.

    The result loads directly in Perfetto (ui.perfetto.dev) or
    chrome://tracing.  Every event carries the keys
    ``ph``/``ts``/``dur``/``name``/``pid``/``tid``.  When ``path`` is
    given the object is also written there as JSON.  ``ts`` counts from
    ``baseTimeNanoseconds`` (Unix ns), as in ``torch.profiler``'s export.
    """
    _resolve_pending()
    with _STATE.lock:
        evs = list(_STATE.events)
        dropped = _STATE.dropped
    obj = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": _STATE.base_ns,
        "otherData": {"dropped_events": dropped, "source": "repro_torch.obs"},
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(obj, f)
    return obj


REQUIRED_EVENT_KEYS = ("ph", "ts", "dur", "name", "pid", "tid")


def validate_trace(obj: Dict) -> List[str]:
    """Return a list of schema problems ([] means valid Chrome trace)."""
    problems: List[str] = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        for k in REQUIRED_EVENT_KEYS:
            if k not in ev:
                problems.append(f"event {i} missing key {k!r}")
        if "ts" in ev and not isinstance(ev["ts"], (int, float)):
            problems.append(f"event {i} ts not numeric")
        if "dur" in ev and not isinstance(ev["dur"], (int, float)):
            problems.append(f"event {i} dur not numeric")
    return problems


def _sync(tree) -> None:
    """Wait for the card(s) holding the CUDA tensors of ``tree`` (a tensor,
    or dicts, lists and tuples of them); nothing for CPU tensors."""
    import torch   # deferred: the package imports only the standard library

    devices, stack = set(), [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "tiled"):            # a DistBSR result
            stack.append(x.tiled.blocks)
    for dev in devices:
        torch.cuda.synchronize(dev)


def sync_elapsed(t0: float, tree) -> float:
    """Wait until the work on ``tree``'s tensors is done, return seconds
    since ``t0`` (a ``time.perf_counter()`` reading).

    The counterpart of the JAX package's ``block_until_ready``: without
    the wait the clock reads the launch, not the work.
    """
    _sync(tree)
    return time.perf_counter() - t0


def timed(fn, repeats: int = 1, warmup: int = 0) -> float:
    """Mean wall seconds per call of ``fn()``, each result waited for."""
    for _ in range(warmup):
        _sync(fn())
    t0 = time.perf_counter()
    for _ in range(max(1, repeats)):
        _sync(fn())
    return (time.perf_counter() - t0) / max(1, repeats)
