"""Device selection and the fault-tolerance runtime (counterpart of
``repro.runtime``): ``device`` picks the card, ``fault`` holds the
restartable loop, the straggler detector and the preemption signal."""
from .fault import PreemptionSignal, RestartableLoop, StragglerDetector  # noqa: F401
