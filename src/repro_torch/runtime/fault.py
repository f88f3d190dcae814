"""Fault-tolerance runtime: restartable training loop, straggler detection,
preemption handling.

A copy of ``repro/runtime/fault.py`` (plain Python; the port imports
nothing of the JAX package):

* every step is resumable: data batches are a pure function of (seed,
  step) and checkpoints commit atomically, so :class:`RestartableLoop` can
  recover from any exception by restoring the latest checkpoint and
  re-entering the loop;
* :class:`StragglerDetector` keeps an EWMA of step times and flags
  outliers (a cluster would report the flagged host to its scheduler; here
  the events are recorded);
* :class:`PreemptionSignal` turns SIGTERM (maintenance events) into a
  clean checkpoint-and-exit between steps.
"""
from __future__ import annotations

import signal
from typing import Callable, Dict, List, Optional

__all__ = ["StragglerDetector", "PreemptionSignal", "RestartableLoop"]


class StragglerDetector:
    """EWMA step-time outlier detection (z-score on the smoothed residual)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 4.0,
                 warmup: int = 5):
        self.alpha, self.threshold, self.warmup = alpha, threshold, warmup
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.count = 0
        self.events: List[Dict] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return False
        resid = dt - self.mean
        slow = (self.count > self.warmup and self.var > 0 and
                resid > self.threshold * (self.var ** 0.5))
        # update stats only with non-outliers so one hang doesn't poison them
        if not slow:
            self.mean += self.alpha * resid
            self.var = (1 - self.alpha) * (self.var + self.alpha * resid ** 2)
        if slow:
            self.events.append({"step": step, "dt": dt, "mean": self.mean})
        return slow


class PreemptionSignal:
    """SIGTERM -> graceful stop flag checked between steps.

    Chains the previously installed SIGTERM handler rather than clobbering
    it, and restores it on `uninstall()` (also the context-manager exit), so
    two coexisting instances — e.g. the training loop's and the serving
    engine's — both see the signal and tear down cleanly.
    """

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = None
        self._installed = False
        if install:
            self.install()

    def install(self) -> bool:
        """Install the handler; returns False outside the main thread."""
        if self._installed:
            return True
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            return False  # non-main thread (tests)
        self._installed = True
        return True

    def uninstall(self) -> None:
        """Restore whatever SIGTERM handler was active before `install()`."""
        if not self._installed:
            return
        prev = signal.SIG_DFL if self._prev is None else self._prev
        try:
            signal.signal(signal.SIGTERM, prev)
        except ValueError:
            pass
        self._installed = False
        self._prev = None

    def __enter__(self) -> "PreemptionSignal":
        self.install()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()

    def _handler(self, signum, frame):
        self.requested = True
        if callable(self._prev):
            self._prev(signum, frame)


class RestartableLoop:
    """Run `body(step) -> None` for steps [start, total); on exception,
    call `recover() -> restart_step` and continue.  Bounded retries.

    `max_restarts` bounds *consecutive* failures: a successful step resets
    the counter, so transient faults spread across a long job don't
    accumulate into a spurious kill.  `total_restarts` keeps the lifetime
    count for reporting.
    """

    def __init__(self, total_steps: int, recover: Callable[[], int],
                 max_restarts: int = 3,
                 on_restart: Optional[Callable[[int, Exception], None]] = None):
        self.total = total_steps
        self.recover = recover
        self.max_restarts = max_restarts
        self.on_restart = on_restart
        self.restarts = 0        # consecutive failures since last progress
        self.total_restarts = 0  # lifetime failure count

    def run(self, body: Callable[[int], None], start_step: int = 0):
        step = start_step
        while step < self.total:
            try:
                body(step)
                step += 1
                self.restarts = 0
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — any node failure
                self.restarts += 1
                self.total_restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if self.on_restart:
                    self.on_restart(step, e)
                step = self.recover()
        return step
