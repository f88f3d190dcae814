"""Deterministic fault injection for the elastic replanning runtime.

Port of ``repro/runtime/faultinject.py``.  Three failure modes, all
seeded so tests and benchmarks replay exactly:

* :class:`StragglerInjector` — per-device step-time inflation.  A real
  straggler shows up as measured step times far above the cost model's
  prediction for that device's series; :func:`record_straggler_drift`
  writes exactly that signal into the live ``repro_torch.obs`` drift
  series (measured = factor x predicted, from the plan's own cost model),
  which is what :class:`repro_torch.runtime.replan.ElasticReplanner`
  watches.
* :class:`TransientFailure` — wraps a callable and raises on the Nth
  call, then recovers: the signal
  :class:`repro_torch.runtime.fault.RestartableLoop` is built to absorb.
* :class:`DeviceLoss` — a seeded choice of lost devices out of a mesh,
  yielding the surviving-device set that drives grid shrink
  (``elastic.choose_grid_shape`` -> ``replan.recover_from_loss``).

Nothing here touches wall clocks: injection is synthetic and replayable,
so recovery tests gate on plan validation and numerics, not timing.
"""
from __future__ import annotations

from typing import Callable, Tuple, Type

import numpy as np

__all__ = [
    "StragglerInjector",
    "TransientFailure",
    "DeviceLoss",
    "record_straggler_drift",
]


class StragglerInjector:
    """Per-device step-time inflation, deterministic in (seed, step, device).

    ``step_time(step, device, base_s)`` returns ``base_s`` untouched for
    healthy devices and ``base_s * factor * (1 + jitter * u)`` for the
    straggling device once ``step >= start_step``, with ``u`` drawn
    reproducibly from ``(seed, step, device)``.
    """

    def __init__(self, device: int, factor: float = 8.0, *, seed: int = 0,
                 jitter: float = 0.0, start_step: int = 0):
        if factor < 1.0:
            raise ValueError(f"straggler factor must be >= 1, got {factor}")
        self.device = device
        self.factor = factor
        self.seed = seed
        self.jitter = jitter
        self.start_step = start_step

    def _u(self, step: int, device: int) -> float:
        rng = np.random.default_rng((self.seed, step, device))
        return float(rng.uniform())

    def active(self, step: int, device: int) -> bool:
        return device == self.device and step >= self.start_step

    def step_time(self, step: int, device: int, base_s: float) -> float:
        if not self.active(step, device):
            return base_s
        return base_s * self.factor * (1.0 + self.jitter * self._u(step,
                                                                   device))


class TransientFailure:
    """Raise on the Nth call of the wrapped function, succeed otherwise.

    ``fail_on`` is 1-based; a list/tuple fails on each listed call.  Use
    as a wrapper factory::

        flaky = TransientFailure(fail_on=3)(plan)
        loop.run(lambda step: flaky(a, b))   # 3rd multiply raises once
    """

    def __init__(self, fail_on=1, exc_type: Type[Exception] = RuntimeError,
                 message: str = "injected transient failure"):
        self.fail_on = (set(fail_on) if isinstance(fail_on, (list, tuple, set))
                        else {int(fail_on)})
        self.exc_type = exc_type
        self.message = message
        self.calls = 0
        self.failures = 0

    def __call__(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            self.calls += 1
            if self.calls in self.fail_on:
                self.failures += 1
                raise self.exc_type(f"{self.message} (call {self.calls})")
            return fn(*args, **kwargs)

        return wrapped


class DeviceLoss:
    """Seeded simulated loss of ``n_lost`` devices out of ``n_devices``.

    ``survivors()`` is a sorted tuple of surviving device ids — the input
    to ``elastic.choose_grid_shape`` / ``replan.recover_from_loss``.
    """

    def __init__(self, n_devices: int, n_lost: int, *, seed: int = 0):
        if not 0 <= n_lost < n_devices:
            raise ValueError(
                f"need 0 <= n_lost < n_devices, got {n_lost}/{n_devices}")
        self.n_devices = n_devices
        self.n_lost = n_lost
        rng = np.random.default_rng((seed, n_devices, n_lost))
        lost = rng.choice(n_devices, size=n_lost, replace=False)
        self._lost = tuple(sorted(int(d) for d in lost))

    def lost(self) -> Tuple[int, ...]:
        return self._lost

    def survivors(self) -> Tuple[int, ...]:
        dead = set(self._lost)
        return tuple(d for d in range(self.n_devices) if d not in dead)


def record_straggler_drift(plan, *, factor: float, n: int = 4,
                           machine=None, jitter: float = 0.0,
                           seed: int = 0) -> float:
    """Write ``n`` straggler-inflated drift records for ``plan`` into the
    live obs series, without running anything.

    The measured side is ``factor x`` the plan's own cost-model
    prediction under ``machine`` (default :data:`~repro_torch.core.
    roofline.H100_SXM`, the port's drift baseline) — exactly the series a
    device running ``factor`` slow leaves behind, so
    ``obs.drift_report()`` ratios trip at ``factor`` and
    ``fit_machine.fit_from_registry`` attributes the surplus to the
    network.  Returns the mean injected measured seconds.
    """
    from repro_torch import obs
    from repro_torch.core import roofline

    machine = machine or roofline.H100_SXM
    inj = StragglerInjector(device=0, factor=factor, seed=seed,
                            jitter=jitter)
    predicted = plan.predicted_cost(machine)
    cm = plan.cost_model()
    total = 0.0
    for step in range(n):
        measured = inj.step_time(step, 0, predicted)
        obs.record_drift(
            plan.algorithm.name, plan.wire, plan.overlap,
            predicted_s=predicted, measured_s=measured, cm=cm,
            kind=plan.kind, machine=machine.name, injected=True)
        total += measured
    return total / max(n, 1)
