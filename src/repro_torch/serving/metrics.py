"""Serving metrics: per-request TTFT/TPOT, aggregate percentiles, and
plan-cache reuse rates, on the :mod:`repro_torch.obs` metrics registry.

Port of ``repro/serving/metrics.py``.  The engine records wall-clock per
measurement window; every timed section waits for its outputs through
:func:`sync_elapsed` (``torch.cuda.synchronize`` on the card), so queued
prefill work never smears into the decode window.  Aggregate series
(prefill/decode seconds, decode-step counts, TTFT/TPOT/dropped-token
distributions) live as instruments in a per-run
:class:`~repro_torch.obs.MetricsRegistry`: ``summary()`` is a read of the
registry plus the request table.  Plan-cache counters come from
``repro_torch.core.api.cache_stats()``; ``plans_per_second`` is plan-cache
lookups (hits + misses) over the serving interval.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from .. import obs as _obs
from ..core import api as _api

# timing and percentile helpers live in repro_torch.obs; re-exported here
# as the reference does
sync_elapsed = _obs.sync_elapsed
percentile = _obs.percentile


@dataclasses.dataclass
class RequestStats:
    rid: int
    arrival: float
    prompt_len: int
    bucket_len: int = 0
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    n_tokens: int = 0
    step_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        """Arrival -> first generated token (queueing + prefill)."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean per-token latency over the decode steps after the first."""
        if not self.step_s:
            return None
        return sum(self.step_s) / len(self.step_s)


class ServingMetrics:
    """Aggregates request lifecycles + cache counters for one serve run.

    Holds its own :class:`~repro_torch.obs.MetricsRegistry` (pass ``registry=``
    to share one): per-run windows need isolated counters, while the
    process-wide ``obs.registry()`` keeps cross-run totals via the
    plan-cache callback.  ``registry.snapshot()`` exposes the raw series.
    """

    def __init__(self, registry: Optional[_obs.MetricsRegistry] = None):
        self.registry = registry or _obs.MetricsRegistry()
        self.requests: Dict[int, RequestStats] = {}
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None
        self._cache0: Optional[Dict] = None
        r = self.registry
        self._prefill_s = r.counter("serve.prefill_s")
        self._decode_s = r.counter("serve.decode_s")
        self._decode_steps = r.counter("serve.decode_steps")
        self._completed = r.counter("serve.completed")
        self._step_h = r.histogram("serve.decode_step_s")
        self._ttft_h = r.histogram("serve.ttft_s")
        self._tpot_h = r.histogram("serve.tpot_s")
        self._dropped_h = r.histogram("serve.dropped_tokens")

    # ------------------------------------------------------------- lifecycle
    def start(self) -> float:
        self._t0 = time.perf_counter()
        self._cache0 = _api.cache_stats()
        return self._t0

    def stop(self) -> None:
        self._t1 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter()

    def submitted(self, rid: int, arrival: float, prompt_len: int) -> None:
        self.requests[rid] = RequestStats(rid, arrival, prompt_len)

    def admitted(self, rid: int, bucket_len: int) -> None:
        r = self.requests[rid]
        r.admitted = time.perf_counter()
        r.bucket_len = bucket_len

    def prefill_done(self, rid: int, dt: float) -> None:
        self._prefill_s.inc(dt)
        self.requests[rid].first_token = time.perf_counter()
        self.requests[rid].n_tokens += 1

    def decode_step_done(self, dt: float, rids: List[int],
                         dropped: Optional[float] = None) -> None:
        self._decode_s.inc(dt)
        self._decode_steps.inc()
        self._step_h.observe(dt)
        if dropped is not None:
            self._dropped_h.observe(float(dropped))
        for rid in rids:
            r = self.requests[rid]
            r.step_s.append(dt)
            r.n_tokens += 1

    def finished(self, rid: int) -> None:
        r = self.requests[rid]
        r.finished = time.perf_counter()
        self._completed.inc()
        if r.ttft is not None:
            self._ttft_h.observe(r.ttft)
        if r.tpot is not None:
            self._tpot_h.observe(r.tpot)

    # --------------------------------------------------------------- summary
    def cache_delta(self) -> Dict[str, Dict[str, int]]:
        """Per-cache counter deltas since :meth:`start`."""
        now = _api.cache_stats()
        base = self._cache0 or {}
        out: Dict[str, Dict[str, int]] = {}
        for name, stats in now.items():
            b = base.get(name, {})
            out[name] = {k: stats[k] - b.get(k, 0)
                         for k in ("hits", "misses", "evictions")}
            out[name]["size"] = stats["size"]
        return out

    def summary(self) -> Dict:
        if self._t1 is None:
            self.stop()
        elapsed = (self._t1 or time.perf_counter()) - (self._t0 or 0.0)
        n_tokens = sum(r.n_tokens for r in self.requests.values())
        decode_s = self._decode_s.value
        caches = self.cache_delta()
        plans = caches.get("plans", {})
        lookups = plans.get("hits", 0) + plans.get("misses", 0)
        hit_rate = (plans.get("hits", 0) / lookups) if lookups else None
        dropped = self._dropped_h
        return {
            "requests": len(self.requests),
            "completed": int(self._completed.value),
            "elapsed_s": elapsed,
            "prefill_s": self._prefill_s.value,
            "decode_s": decode_s,
            "decode_steps": int(self._decode_steps.value),
            "tokens": n_tokens,
            "tokens_per_s": n_tokens / elapsed if elapsed > 0 else None,
            "decode_tok_per_s": (
                sum(len(r.step_s) for r in self.requests.values())
                / decode_s if decode_s > 0 else None),
            "ttft_p50_s": self._ttft_h.percentile(50),
            "ttft_p99_s": self._ttft_h.percentile(99),
            "tpot_p50_s": self._tpot_h.percentile(50),
            "tpot_p99_s": self._tpot_h.percentile(99),
            "plan_lookups": lookups,
            "plans_per_second": lookups / elapsed if elapsed > 0 else None,
            "plan_cache": plans,
            "plan_cache_hit_rate": hit_rate,
            "caches": caches,
            "dropped_mean": (dropped.mean() if dropped.count else 0.0),
            "dropped_max": (dropped.vmax if dropped.count else 0.0),
        }
