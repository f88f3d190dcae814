"""Elastic replanning: drift-triggered re-selection + shrunken-grid recovery.

Port of ``repro/runtime/replan.py``.  The engine's plans are built
against three assumptions — a machine model (``Machine``), an operand
structure, and a healthy g x g grid.  This module is the control loop
that repairs each of them from *live* signals instead of restarting the
job:

* **Drift** — every traced multiply leaves a predicted-vs-measured pair
  in ``obs.drift_records()`` per (algorithm, wire, overlap) series.
  :meth:`ElasticReplanner.should_replan` watches the per-series geomean
  ratio (``obs.drift_report()``) and :class:`~repro_torch.runtime.fault.
  StragglerDetector` events; past the configured thresholds,
  :meth:`~ElasticReplanner.refit` re-fits ``(net_bw, hop_latency)`` from
  the recorded series (``runtime/fit_machine.fit_from_registry``), points
  the drift baseline at the fitted machine, and evicts exactly the
  tripped algorithms' cached plans (``api.invalidate_plans``).
  :meth:`~ElasticReplanner.replan` then re-runs ``auto_select`` under the
  fitted machine, so a schedule that only won on nominal constants loses
  the re-selection.

* **Device loss** — :meth:`~ElasticReplanner.recover_from_loss` takes the
  surviving device set, picks the new grid
  (``elastic.choose_grid_shape``), re-tiles the live handles onto it where
  they lie (``api.reshard``: one gather of the block values on the card,
  no host round trip of block data; B is cropped as a view and re-padded
  on the card), rebuilds the steal3d
  :class:`~repro_torch.core.schedule.Assignment3D` for the survivors with
  ``assign_3d_lpt`` over the resharded operand's real item costs, proves
  it covers exactly the surviving grid's work
  (``analysis.check_survivor_coverage``) and injects it through
  ``plan_matmul(assignment=..., validate="fast")`` — recovery gates on the
  static verifier, not numerics.  The stacked executor keeps every tile
  on one card, so there the survivors decide only the grid size and the
  coverage check.  On a process grid (``mesh=`` the old grid's
  ``GroupExecutor``) they decide which ranks run the tiles: a new grid
  over the first ``g * g`` survivors, the operands re-placed onto it by
  exchange (``api.reshard_on_grid``), the plan built and verified there.

Every action surfaces through ``repro_torch.obs`` as ``replan.*``
counters and spans, with the JAX package's names.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["ReplanConfig", "ReplanResult", "RecoveryResult",
           "ElasticReplanner"]


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Trip thresholds and budgets for :class:`ElasticReplanner`.

    ``drift_ratio`` — a series trips when its geomean measured/predicted
    ratio is at or above this (or at or below its reciprocal: a model
    that is badly *pessimistic* also mis-ranks schedules).
    ``min_records`` — ignore series with fewer records (warmup noise).
    ``straggler_events`` — detector events that trip independently of
    drift.  ``cooldown_s`` — minimum seconds between replans (suppressed
    trips are counted, not dropped silently).  ``budget_s`` — soft wall
    budget for one replan/recovery; overruns increment
    ``replan.budget_exceeded`` rather than aborting (an over-budget
    recovery still beats no recovery).  ``validate`` — the static-verifier
    mode every rebuilt plan gates on.
    """

    drift_ratio: float = 2.0
    min_records: int = 3
    straggler_events: int = 1
    cooldown_s: float = 0.0
    budget_s: float = math.inf
    validate: str = "fast"


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """What one drift-triggered replan did."""

    trips: Dict[str, str]           # series/source -> reason
    machine: object                 # the fitted Machine now in force
    fit_diag: Dict                  # fit_from_registry diagnostics
    evicted: int                    # plan-cache entries invalidated
    algorithm: Optional[str]        # auto_select's post-refit choice
    plan: Optional[object]          # rebuilt MatmulPlan (when operands given)
    duration_s: float


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    """What one device-loss recovery did."""

    g: int                          # surviving grid size
    survivors: Tuple[int, ...]
    a: object                       # resharded handles
    b: object
    assignment: object              # rebuilt, validated Assignment3D
    plan: object                    # injected steal3d plan (validated)
    evicted: int                    # dead grid's evicted plan entries
    duration_s: float


class ElasticReplanner:
    """Drift/straggler-triggered re-fit + re-selection, and grid-shrink
    recovery, over the live plan layer.

    ``machine`` is the fit base (arith peak / mem bw stay; net_bw and
    hop_latency are re-fitted); it defaults to
    :data:`~repro_torch.core.roofline.H100_SXM`, the port's drift
    baseline.  ``detector`` optionally wires a
    :class:`~repro_torch.runtime.fault.StragglerDetector` in: its events
    trip replanning even before the drift series accumulates.  The
    serving engine calls :meth:`should_replan` / :meth:`refit` between
    batches (``repro_torch.serving.ServeEngine(replanner=...)``).
    """

    def __init__(self, *, machine=None, config: Optional[ReplanConfig] = None,
                 detector=None):
        from repro_torch.core import roofline

        self.config = config or ReplanConfig()
        self.machine = machine or roofline.H100_SXM
        self.detector = detector
        self.replans = 0
        self.recoveries = 0
        self._last_replan: Optional[float] = None

    # ------------------------------------------------------------- triggers
    def should_replan(self) -> Dict[str, str]:
        """Tripped signals, ``{series_or_source: reason}`` (empty = healthy).

        Reads ``obs.drift_report()`` (per-series geomean ratios) and the
        attached detector's event log.  Respects the cooldown: trips
        inside it return empty and count ``replan.suppressed_cooldown``.
        """
        from repro_torch import obs

        cfg = self.config
        trips: Dict[str, str] = {}
        for series, stats in obs.drift_report().items():
            if stats["n"] < cfg.min_records:
                continue
            ratio = stats["ratio"]
            if ratio >= cfg.drift_ratio or ratio <= 1.0 / cfg.drift_ratio:
                trips[series] = (f"drift ratio {ratio:.3g} past "
                                 f"{cfg.drift_ratio:g} over {stats['n']} "
                                 "records")
        if self.detector is not None and \
                len(self.detector.events) >= cfg.straggler_events:
            ev = self.detector.events[-1]
            trips["straggler"] = (
                f"{len(self.detector.events)} straggler event(s), last at "
                f"step {ev['step']} ({ev['dt']:.3g}s vs mean "
                f"{ev['mean']:.3g}s)")
        if trips and self._last_replan is not None and \
                time.monotonic() - self._last_replan < cfg.cooldown_s:
            obs.registry().counter("replan.suppressed_cooldown").inc()
            return {}
        if trips:
            obs.registry().counter("replan.triggered").inc()
        return trips

    # ---------------------------------------------------------------- refit
    def refit(self, trips: Optional[Dict[str, str]] = None):
        """Re-fit the machine from the live drift series and invalidate the
        tripped algorithms' cached plans.

        Returns ``(fitted_machine, diagnostics, evicted)``.  The fitted
        machine becomes the new drift baseline (``api.set_drift_machine``)
        and the new fit base for subsequent refits; the consumed drift
        series is reset so stale pre-fit records can't re-trip.  A fit
        with fewer than two usable records raises ``ValueError``.
        """
        from repro_torch import obs
        from repro_torch.core import api

        from .fit_machine import fit_from_registry

        with obs.span("replan.refit", trips=len(trips or ())):
            fitted, diag = fit_from_registry(base=self.machine)
            tripped_algs = {s.split("/")[0] for s in (trips or ())
                            if s != "straggler"}
            evicted = 0
            for alg in sorted(tripped_algs):
                if alg in api.REGISTRY:
                    evicted += api.invalidate_plans(algorithm=alg)
            api.set_drift_machine(fitted)
            obs.reset_drift()
        self.machine = fitted
        reg = obs.registry()
        reg.counter("replan.refits").inc()
        if evicted:
            reg.counter("replan.plans_evicted").inc(evicted)
        return fitted, diag, evicted

    # --------------------------------------------------------------- replan
    def replan(self, a=None, b=None, *, trips: Optional[Dict] = None,
               device=None, **plan_kw) -> ReplanResult:
        """One full drift-triggered replan: refit, evict, re-select.

        ``trips`` defaults to :meth:`should_replan` (pass explicitly to
        force).  With operand handles, the post-refit ``auto_select``
        choice is built into a plan (``algorithm="auto"`` under the
        fitted machine, gated on ``config.validate``, on the operands'
        device or ``device``); without them only the refit/eviction
        happens — plans rebuild lazily on the next cache miss, which is
        how the serving engine uses it between batches.
        """
        from repro_torch import obs
        from repro_torch.core import api

        cfg = self.config
        t0 = time.monotonic()
        if trips is None:
            trips = self.should_replan()
        with obs.span("replan.replan", trips=len(trips)):
            fitted, diag, evicted = self.refit(trips)
            algorithm = plan = None
            if a is not None and b is not None:
                plan = api.plan_matmul(
                    a, b, algorithm="auto", machine=fitted, device=device,
                    validate=cfg.validate, **plan_kw)
                algorithm = plan.algorithm.name
        dt = time.monotonic() - t0
        self.replans += 1
        self._last_replan = time.monotonic()
        reg = obs.registry()
        reg.histogram("replan.duration_s").observe(dt)
        if dt > cfg.budget_s:
            reg.counter("replan.budget_exceeded").inc()
        return ReplanResult(trips=dict(trips), machine=fitted,
                            fit_diag=diag, evicted=evicted,
                            algorithm=algorithm, plan=plan, duration_s=dt)

    # ------------------------------------------------------------- recovery
    def recover_from_loss(self, a, b, survivors, *, mesh=None,
                          algorithm: str = "steal3d", wire: str = "padded",
                          locality: str = "locality",
                          comm_penalty: float = 1.0,
                          max_g: Optional[int] = None,
                          capacity="bucket", **plan_kw) -> RecoveryResult:
        """Rebuild the multiply on the surviving grid, gated statically.

        Steps (each an ``obs`` span under ``replan.recover``): pick the
        new grid, drop the dead grid's cached plans (``replan.evict``),
        reshard both handles on their device (``replan.reshard``), rebuild
        the steal3d assignment for the survivors from the resharded
        operand's real item costs (``replan.lpt``), prove survivor
        coverage (``replan.coverage``), and build the injected plan under
        ``config.validate`` (default ``"fast"``, inside
        ``plan_build``).  Raises ``PlanValidationError`` / ``ValueError``
        before anything runs if the rebuilt schedule is not provably
        correct.

        ``mesh`` (a :class:`~repro_torch.core.executor.GroupExecutor` of
        the old process grid) recovers on ranks; every rank of the old
        grid calls it, the lost ones too.  The new ``g x g`` grid is the
        first ``g * g`` survivors (``replan.mesh``: a ``DeviceMesh`` and a
        process group over them, which every rank creates, as
        ``dist.new_group`` requires); the operands are re-placed by
        exchange (:func:`~repro_torch.core.api.reshard_on_grid`: the old
        owners, lost or not, send their blocks, the simulation of a loss
        in which the JAX package's ``reshard`` reads every tile); a dense
        right operand, whole on every rank, is re-tiled in place.  The
        plan is built on the new grid and returned on its ranks; a rank
        outside it gets ``a``, ``b`` and ``plan`` None and idles.
        """
        if mesh is not None:
            return self._recover_on_ranks(
                a, b, survivors, mesh, algorithm=algorithm, wire=wire,
                locality=locality, comm_penalty=comm_penalty, max_g=max_g,
                capacity=capacity, **plan_kw)
        from repro_torch import analysis, obs
        from repro_torch.core import api
        from repro_torch.core import schedule as _schedule

        from .elastic import choose_grid_shape

        cfg = self.config
        survivors = (tuple(range(survivors)) if isinstance(survivors, int)
                     else tuple(survivors))
        t0 = time.monotonic()
        g_old = a.g
        g = choose_grid_shape(survivors, max_g=max_g)
        with obs.span("replan.recover", g_old=g_old, g_new=g,
                      survivors=len(survivors)):
            with obs.span("replan.evict"):
                evicted = api.invalidate_plans(g=g_old) if g != g_old \
                    else 0
            with obs.span("replan.reshard"):
                a2 = api.reshard(a, g, capacity=capacity)
                if isinstance(b, api.DistDense):
                    # the RHS re-pads its inner dim against the resharded
                    # A's padding, exactly like first-time construction
                    # (b.data[:m, :n] is a view on the card)
                    m, n = b.logical_shape
                    b2 = api.DistDense.for_rhs(b.data[:m, :n], a2,
                                               allow_pad=True)
                else:
                    b2 = api.reshard(b, g, capacity=capacity)
            # Rebuild the stealing equilibrium from the resharded
            # operand's actual per-item costs (real block products per
            # (i, k) panel tile for sparse A, uniform for dense), the
            # same grid build_steal_plan validates the injection against.
            with obs.span("replan.lpt"):
                if isinstance(a2, api.DistBSR):
                    cost_ik = np.asarray(
                        a2.grid_structure().real.sum(axis=2),
                        dtype=np.float64)
                else:
                    cost_ik = np.ones((g, g), dtype=np.float64)
                asg = _schedule.assign_3d_lpt(
                    np.broadcast_to(cost_ik[:, :, None], (g, g, g)).copy(),
                    g, locality=locality, comm_penalty=comm_penalty)
            with obs.span("replan.coverage"):
                findings = analysis.check_survivor_coverage(asg, g,
                                                            survivors)
            if findings:
                raise analysis.PlanValidationError(findings)
            plan = api.plan_matmul(a2, b2, algorithm=algorithm, wire=wire,
                                   assignment=asg, validate=cfg.validate,
                                   **plan_kw)
        dt = time.monotonic() - t0
        self.recoveries += 1
        reg = obs.registry()
        reg.counter("replan.recoveries").inc()
        reg.histogram("replan.recovery_s").observe(dt)
        if dt > cfg.budget_s:
            reg.counter("replan.budget_exceeded").inc()
        return RecoveryResult(g=g, survivors=survivors, a=a2, b=b2,
                              assignment=asg, plan=plan, evicted=evicted,
                              duration_s=dt)


    def _recover_on_ranks(self, a, b, survivors, old, *, algorithm, wire,
                          locality, comm_penalty, max_g, capacity,
                          **plan_kw) -> RecoveryResult:
        """:meth:`recover_from_loss` on the ranks of ``old``'s grid."""
        from repro_torch import analysis, obs
        from repro_torch.core import api
        from repro_torch.core import schedule as _schedule
        from repro_torch.core.executor import sub_grid

        from .elastic import choose_grid_shape

        cfg = self.config
        survivors = tuple(sorted(range(survivors) if isinstance(survivors,
                                                               int)
                                 else survivors))
        t0 = time.monotonic()
        g_old = old.g
        g = choose_grid_shape(survivors, max_g=max_g)
        new_ranks = [old._ranks[p] for p in survivors[:g * g]]
        asg = plan = a2 = b2 = None
        with obs.span("replan.recover", g_old=g_old, g_new=g,
                      survivors=len(survivors)):
            with obs.span("replan.evict"):
                evicted = api.invalidate_plans(g=g_old) if g != g_old \
                    else 0
            with obs.span("replan.mesh"):
                new = sub_grid(old, survivors[:g * g])  # every rank calls
            with obs.span("replan.reshard"):
                a2 = api.reshard_on_grid(a, g, old, new, new_ranks,
                                         capacity=capacity)
                if isinstance(b, api.DistDense):
                    m, n = b.logical_shape
                    b2 = None if new is None else api.DistDense.for_rhs(
                        b.data[:m, :n], a2, allow_pad=True,
                        device=b.device)
                else:
                    b2 = api.reshard_on_grid(b, g, old, new, new_ranks,
                                             capacity=capacity)
            if new is not None:
                with obs.span("replan.lpt"):
                    if isinstance(a2, api.DistBSR):
                        cost_ik = np.asarray(
                            a2.grid_structure().real.sum(axis=2),
                            dtype=np.float64)
                    else:
                        cost_ik = np.ones((g, g), dtype=np.float64)
                    asg = _schedule.assign_3d_lpt(
                        np.broadcast_to(cost_ik[:, :, None],
                                        (g, g, g)).copy(),
                        g, locality=locality, comm_penalty=comm_penalty)
                with obs.span("replan.coverage"):
                    findings = analysis.check_survivor_coverage(
                        asg, g, survivors)
                if findings:
                    raise analysis.PlanValidationError(findings)
                plan = api.plan_matmul(a2, b2, algorithm=algorithm,
                                       wire=wire, assignment=asg,
                                       validate=cfg.validate, mesh=new,
                                       **plan_kw)
        dt = time.monotonic() - t0
        self.recoveries += 1
        reg = obs.registry()
        reg.counter("replan.recoveries").inc()
        reg.histogram("replan.recovery_s").observe(dt)
        if dt > cfg.budget_s:
            reg.counter("replan.budget_exceeded").inc()
        return RecoveryResult(g=g, survivors=survivors, a=a2, b=b2,
                              assignment=asg, plan=plan, evicted=evicted,
                              duration_s=dt)
