"""Predicted-vs-measured drift series for the plan cost model.

Port of ``repro/obs/drift.py``.  Every traced ``MatmulPlan.__call__``
records the measured per-multiply seconds next to the plan's predicted
seconds, keyed by ``(algorithm, wire, overlap)``.  The measured side is
the synchronised wall clock on the CPU and on a process grid; a stacked
plan on the card gives a pending timing instead (its span's CUDA event
pair, :class:`~repro_torch.obs.trace.DevicePair`: any object with a
``seconds()`` method), which ``drift_records()`` and ``drift_report()``
read when they are called, so the traced multiply never waits.
``drift_report()`` condenses each series to a ratio (geometric mean of
measured/predicted — the cost model's systematic bias) and an RMSE
(absolute spread).  Records keep the plan's cost-model dict, so a fit of
the ``Machine`` parameters can read the live records.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

# Bounded per-series history: drift is a running estimate, not an archive.
_MAX_RECORDS_PER_KEY = 4096

_LOCK = threading.Lock()
_SERIES: Dict[Tuple[str, str, str], List[Dict]] = {}


def record_drift(
    algorithm: str,
    wire: str,
    overlap: str,
    predicted_s: float,
    measured_s: float,
    cm: Optional[Dict] = None,
    **extra,
) -> None:
    """Append one predicted/measured pair to its (algorithm, wire, overlap)
    series.  ``cm`` is the plan's cost-model dict, kept for re-fitting.
    ``measured_s`` is seconds, or a pending timing (an object with a
    ``seconds()`` method), kept unread until the records are read."""
    key = (str(algorithm), str(wire), str(overlap))
    rec = {
        "algorithm": key[0],
        "wire": key[1],
        "overlap": key[2],
        "predicted_s": float(predicted_s),
        "measured_s": measured_s if hasattr(measured_s, "seconds")
        else float(measured_s),
    }
    if cm is not None:
        rec["cm"] = cm
    rec.update(extra)
    with _LOCK:
        series = _SERIES.setdefault(key, [])
        series.append(rec)
        if len(series) > _MAX_RECORDS_PER_KEY:
            del series[: len(series) // 2]


def _resolved(series: List[Dict]) -> List[Dict]:
    """``series`` with every pending ``measured_s`` read into seconds, in
    the stored records too (each is read once)."""
    for r in series:
        if not isinstance(r["measured_s"], float):
            r["measured_s"] = float(r["measured_s"].seconds())
    return series


def drift_records() -> List[Dict]:
    """Flat copy of every record across all series (a machine fit's input)."""
    with _LOCK:
        flat = [r for series in _SERIES.values() for r in series]
    return [dict(r) for r in _resolved(flat)]


def reset_drift() -> None:
    with _LOCK:
        _SERIES.clear()


def _summarize(series: List[Dict]) -> Dict:
    n = len(series)
    pred = [r["predicted_s"] for r in series]
    meas = [r["measured_s"] for r in series]
    # Geomean of measured/predicted: multiplicative bias, robust to the
    # orders-of-magnitude spread between one-card and modelled-grid seconds.
    logs = [
        math.log(m / p)
        for m, p in zip(meas, pred)
        if p > 0.0 and m > 0.0 and math.isfinite(m / p)
    ]
    ratio = math.exp(sum(logs) / len(logs)) if logs else float("nan")
    rmse = math.sqrt(sum((m - p) ** 2 for m, p in zip(meas, pred)) / n)
    return {
        "n": n,
        "predicted_mean_s": sum(pred) / n,
        "measured_mean_s": sum(meas) / n,
        "ratio": ratio,
        "rmse_s": rmse,
    }


def drift_report() -> Dict[str, Dict]:
    """Per-series drift summary, keyed ``"algorithm/wire/overlap"``.

    ``ratio`` is geomean(measured/predicted): 1.0 means the cost model is
    calibrated; a drifting ratio is the signal to re-fit the machine.
    """
    with _LOCK:
        items = [(k, list(v)) for k, v in _SERIES.items()]
    return {"/".join(key): _summarize(_resolved(series))
            for key, series in items}


def export_drift(path: str) -> Dict:
    """Write all drift records (with cost-model dicts) and the report as
    JSON, for an offline re-fit."""
    obj = {"records": drift_records(), "report": drift_report()}
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj
