"""Span-based execution tracing with Chrome-trace (Perfetto) export.

Port of ``repro/obs/trace.py``.  Tracing is off by default.  When off,
``span()`` returns one shared no-op context manager — no allocation, no
clock read, no synchronisation — so instrumented hot paths (plan calls)
pay a single boolean check.  When on, each span records a Chrome-trace
"complete" event (``ph: "X"``) with microsecond ``ts``/``dur``, the
recording thread's id, and any keyword attributes under ``args``.
Perfetto reconstructs the stack per thread from interval containment; the
thread-local depth is recorded too.

Timing helpers: ``sync_elapsed`` (wait until the card has finished the
work on the tensors of a tree, then read the clock) and ``timed`` (time a
thunk with a trailing synchronisation).  Kernel launches return before the
card has run them, so a clock read without the wait measures the launch,
not the work.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

# Trace-buffer cap: ~100k spans bounds memory for runaway traced loops;
# drops are counted and surfaced in export metadata.
_MAX_EVENTS = 100_000


class _State:
    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.events: List[Dict] = []
        self.dropped = 0
        self.t0 = time.perf_counter()


_STATE = _State()
_TLS = threading.local()


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_start", "_depth")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args
        self._start = 0.0
        self._depth = 0

    def note(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. cache hit/miss)."""
        self.args.update(attrs)

    def __enter__(self):
        depth = getattr(_TLS, "depth", 0)
        _TLS.depth = depth + 1
        self._depth = depth
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _TLS.depth = self._depth
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": "repro_torch",
            "ts": (self._start - _STATE.t0) * 1e6,
            "dur": (end - self._start) * 1e6,
            "pid": 0,
            "tid": threading.get_ident() % 2**31,
            "args": dict(self.args, depth=self._depth),
        }
        with _STATE.lock:
            if len(_STATE.events) < _MAX_EVENTS:
                _STATE.events.append(ev)
            else:
                _STATE.dropped += 1
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


def span(name: str, **attrs):
    """Context manager recording a Chrome-trace span while tracing is on.

    Returns a shared inert object when tracing is off — safe (and ~free)
    to leave on hot paths unconditionally.
    """
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs)


def instant(name: str, **attrs) -> None:
    """Record a zero-duration marker event (rendered as a span of dur 0)."""
    if not _STATE.enabled:
        return
    now = (time.perf_counter() - _STATE.t0) * 1e6
    ev = {
        "ph": "X",
        "name": name,
        "cat": "repro_torch",
        "ts": now,
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


def events() -> List[Dict]:
    """Copy of the buffered events (oldest first)."""
    with _STATE.lock:
        return list(_STATE.events)


def clear_trace() -> None:
    with _STATE.lock:
        _STATE.events = []
        _STATE.dropped = 0


def export_trace(path: Optional[str] = None) -> Dict:
    """Render buffered spans as a Chrome-trace JSON object.

    The result loads directly in Perfetto (ui.perfetto.dev) or
    chrome://tracing.  Every event carries the keys
    ``ph``/``ts``/``dur``/``name``/``pid``/``tid``.  When ``path`` is
    given the object is also written there as JSON.
    """
    with _STATE.lock:
        evs = list(_STATE.events)
        dropped = _STATE.dropped
    obj = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
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
