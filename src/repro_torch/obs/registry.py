"""Metrics registry: counters, gauges, histograms with labeled series.

Port of ``repro/obs/registry.py``.  One process-wide default registry
(``registry()``) holds the plan-cache counters (a pull-time callback) and
steal3d's moved-tile bytes; independent registries can be created for
windowed measurements.

Design points:

- Instruments are identified by ``(name, labels)``; asking twice for the
  same series returns the same object, so call sites can be stateless.
- ``snapshot()`` renders everything to plain dicts (JSON-safe); callbacks
  registered with ``register_callback`` are pulled lazily at snapshot time,
  which is how the plan caches expose their counters without the registry
  importing ``core.api``.
- ``reset()`` zeroes counts and clears histogram samples but keeps every
  instrument and callback registered, so long-running processes can window
  rates without re-wiring instrumentation.

Everything is thread-safe under one registry-wide lock; instrument updates
are a few dict/list operations, far off any device hot path.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile; nan for an empty sample."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    f = (len(s) - 1) * q / 100.0
    lo = int(f)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (f - lo))


class Counter:
    """Monotonic (between resets) numeric total."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0.0

    def render(self):
        return self.value


class Gauge:
    """Last-set value (None until first set)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = None

    def render(self):
        return self.value


class Histogram:
    """Sample list with count/sum/min/max/percentile summaries.

    Samples are kept (bounded) so percentiles are exact over the window;
    ``max_samples`` caps memory for unbounded runs — beyond it the summary
    stats stay exact but percentiles cover the most recent window.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str], max_samples: int = 65536):
        self.name = name
        self.labels = dict(labels)
        self.max_samples = max_samples
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.samples.append(v)
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) // 2]

    def reset(self) -> None:
        self.samples = []
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def render(self):
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean(),
            "min": self.vmin if self.count else float("nan"),
            "max": self.vmax if self.count else float("nan"),
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
        }


class MetricsRegistry:
    """A named collection of instruments plus pull-time callbacks."""

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: Dict[Tuple[str, LabelKey], object] = {}
        self._callbacks: Dict[str, Callable[[], object]] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}"
                )
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def register_callback(self, name: str, fn: Callable[[], object]) -> None:
        """Register a zero-arg callable whose result appears under ``name``
        in snapshots.  Survives ``reset()``; re-registering replaces."""
        with self._lock:
            self._callbacks[name] = fn

    def series(self, name: str) -> List[object]:
        """All instruments registered under ``name`` (one per label set)."""
        with self._lock:
            return [v for (n, _), v in self._instruments.items() if n == name]

    def snapshot(self) -> Dict[str, object]:
        """Render every instrument and callback to a plain, JSON-safe dict.

        Unlabeled instruments render as ``{name: value}``; labeled series as
        ``{name: {"k=v,k2=v2": value, ...}}``.
        """
        out: Dict[str, object] = {}
        with self._lock:
            items = list(self._instruments.items())
            callbacks = list(self._callbacks.items())
        for (name, lkey), inst in items:
            if not lkey:
                out[name] = inst.render()
            else:
                label_str = ",".join(f"{k}={v}" for k, v in lkey)
                out.setdefault(name, {})
                out[name][label_str] = inst.render()  # type: ignore[index]
        for name, fn in callbacks:
            try:
                out[name] = fn()
            except Exception as e:  # pragma: no cover - defensive
                out[name] = f"<callback error: {e}>"
        return out

    def reset(self) -> None:
        """Zero every instrument; registrations and callbacks survive."""
        with self._lock:
            for inst in self._instruments.values():
                inst.reset()


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT
