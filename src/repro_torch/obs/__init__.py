"""repro_torch.obs — metrics registry, execution tracing and
predicted-vs-measured drift tracking (port of ``repro/obs``).

Quick tour::

    from repro_torch import obs

    obs.enable()                         # tracing on (off by default)
    with obs.span("plan_build", algorithm="ring_c"):
        ...                              # spans nest, thread-safe
    obs.export_trace("trace.json")       # Chrome-trace JSON for Perfetto

    obs.registry().counter("steal3d.plans_built").inc()
    obs.registry().snapshot()            # plain-dict view of every metric

    obs.drift_report()                   # cost-model calibration per series

Importing this package imports nothing but the standard library; the
timing helpers import ``torch`` when they are called.
"""
from .drift import (
    drift_records,
    drift_report,
    export_drift,
    record_drift,
    reset_drift,
)
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
    registry,
)
from .trace import (
    REQUIRED_EVENT_KEYS,
    clear_trace,
    disable,
    enable,
    enabled,
    events,
    export_trace,
    instant,
    span,
    sync_elapsed,
    timed,
    validate_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REQUIRED_EVENT_KEYS",
    "clear_trace",
    "disable",
    "drift_records",
    "drift_report",
    "enable",
    "enabled",
    "events",
    "export_drift",
    "export_trace",
    "instant",
    "percentile",
    "record_drift",
    "registry",
    "reset_all",
    "reset_drift",
    "span",
    "sync_elapsed",
    "timed",
    "validate_trace",
]


def reset_all() -> None:
    """Clear trace buffer, drift series, and zero the default registry."""
    clear_trace()
    reset_drift()
    registry().reset()
