"""Request-level serving over the plan-based sparse engine (port of
``repro.serving``).

Public surface: :class:`ServeEngine` (continuous batching + plan-cache
reuse), :class:`Request`/:class:`RequestBatcher` (shape-bucketed
admission) and :class:`ServingMetrics` (TTFT/TPOT percentiles,
plans-per-second, dropped-token stats).  Import the engine from here, not
from ``serving.engine``.  The reference's ``segment_trace_counts`` counts
JAX jit traces and has no counterpart in eager torch; plan reuse across
tenants shows in ``repro_torch.core.api.cache_stats`` and
``add_trace_hook``.
"""
from .batcher import (DEFAULT_BUCKETS, Request, RequestBatcher, bucket_for,
                      effective_bucket, padding_supported)
from .engine import ServeEngine
from .metrics import ServingMetrics, percentile, sync_elapsed

__all__ = [
    "ServeEngine", "Request", "RequestBatcher", "ServingMetrics",
    "DEFAULT_BUCKETS", "bucket_for", "effective_bucket",
    "padding_supported", "percentile", "sync_elapsed",
]
