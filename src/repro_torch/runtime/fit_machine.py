"""Fit ``Machine.net_bw`` / ``hop_latency`` from predicted-vs-measured records.

The port's copy of what ``repro_torch.runtime.replan`` needs from the JAX
package's ``tools/fit_machine.py``: the design-matrix row, the
least-squares fit, and the fit from the live ``repro_torch.obs`` drift
series.  The readers of benchmark JSON payloads wait for the port's
benchmarks.

The auto-scheduler's alpha-beta model (``api._predicted_time``) is linear
in the two network unknowns::

    t_comm = total_bytes / (net_bw * duplex) + n_msgs * hop_latency

so, after subtracting the roofline compute term, a least-squares fit over
the records recovers ``1 / net_bw`` and ``hop_latency``.

A fit describes whatever produced the records.  On the stacked executor
(one card, no tile moved) real records carry no network time, and the
straggler records of ``faultinject.record_straggler_drift`` describe a
modelled network that is ``factor`` times slow: neither is the H100's
NVLink, and neither belongs in :data:`~repro_torch.core.roofline.H100_SXM`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["fit", "fit_from_registry"]


def _comm_row(cm: Dict[str, float], alg) -> Tuple[float, float]:
    """Design-matrix row (effective bytes, message count) for one record."""
    n_msgs = alg.msgs_per_step if alg.msgs_per_step is not None \
        else len(alg.wire)
    msgs = n_msgs * (1.0 if alg.wire_amortized else cm["steps"])
    return cm["total_net_bytes"] / alg.duplex, msgs


def fit(records: List[Dict], base) -> Tuple[object, Dict]:
    """Least-squares fit of (net_bw, hop_latency) from records.

    Each record: ``{"cm": cost-model dict, "alg": Algorithm,
    "measured": seconds}``.  BSP schedules pay compute + comm, so their
    comm time is ``measured - t_comp`` exactly; RDMA rings pay
    max(comp, comm), so they inform the fit only when comm-dominated —
    rows whose residual target comes out non-positive are dropped.
    Raises ValueError with fewer than two usable records.
    """
    from repro_torch.core import roofline as _roofline

    rows, targets = [], []
    for rec in records:
        cm, alg = rec["cm"], rec["alg"]
        t_comp = cm["total_flops"] / _roofline.local_peak(
            cm["ai_local"], base)
        if alg.style == "bsp":
            y = rec["measured"] - t_comp
        else:
            # rings pay max(comp, comm): the measured time equals comm only
            # when comm dominates.  A compute-bound ring record would be
            # attributed entirely to the network and wreck the fit, so keep
            # rings only when measured clearly exceeds the compute floor.
            if rec["measured"] <= 2.0 * t_comp:
                continue
            y = rec["measured"]
        if y <= 0:
            continue
        rows.append(_comm_row(cm, alg))
        targets.append(y)
    if len(rows) < 2:
        raise ValueError(
            f"need >= 2 usable records to fit 2 parameters, got {len(rows)}")
    a = np.asarray(rows, dtype=np.float64)
    y = np.asarray(targets, dtype=np.float64)
    # normalize columns so bytes (~1e6) and msgs (~1e1) are comparable
    scale = a.max(axis=0)
    scale[scale == 0] = 1.0
    x, *_ = np.linalg.lstsq(a / scale, y, rcond=None)
    x = x / scale
    inv_bw = max(float(x[0]), 1e-18)     # clip to physical (positive) values
    alpha = max(float(x[1]), 0.0)
    fitted = dataclasses.replace(base, name=base.name + "-fit",
                                 net_bw=1.0 / inv_bw, hop_latency=alpha)
    resid = a @ np.array([inv_bw, alpha]) - y
    diag = {
        "n_records": len(records),
        "n_used": len(rows),
        # 2 when the used rows determine both unknowns; 1 when they are
        # proportional (one series, or series whose bytes and messages
        # scale together) and the solution is lstsq's minimum-norm pick
        "rank": int(np.linalg.matrix_rank(a / scale)),
        "rms_residual_s": float(np.sqrt((resid ** 2).mean())),
        "net_bw": fitted.net_bw,
        "hop_latency": fitted.hop_latency,
    }
    return fitted, diag


def _records_from_drift(raw: List[Dict]) -> List[Dict]:
    """Convert obs drift records ({"algorithm", "cm", "measured_s"}) to
    fit records.  Drift records carry the executed plan's cost-model dict
    verbatim, so no geometry reconstruction is needed; records for
    unregistered algorithms or with structure-dependent cost functions
    (steal3d) are skipped."""
    from repro_torch.core import api

    out = []
    for rec in raw:
        name = rec.get("algorithm")
        cm = rec.get("cm")
        if cm is None or name not in api.REGISTRY:
            continue
        alg = api.REGISTRY.get(name)
        if alg.cost_fn is not None:
            continue
        out.append({"cm": cm, "alg": alg,
                    "source": f"drift/{name}/{rec.get('wire', '?')}",
                    "measured": rec["measured_s"],
                    "predicted": rec.get("predicted_s")})
    return out


def fit_from_registry(base=None) -> Tuple[object, Dict]:
    """Re-fit (net_bw, hop_latency) from the live obs drift series.

    Any process that executed plans under ``obs.enable()`` (or injected
    records with ``faultinject.record_straggler_drift``) has
    per-multiply measurements, with their cost-model dicts, in
    ``obs.drift_records()``; this fits a Machine from them directly, on
    ``base``'s compute constants (default
    :data:`~repro_torch.core.roofline.H100_SXM`).  Raises ValueError with
    fewer than two usable records, like :func:`fit`.
    """
    from repro_torch import obs
    from repro_torch.core import roofline

    base = base or roofline.H100_SXM
    return fit(_records_from_drift(obs.drift_records()), base)
