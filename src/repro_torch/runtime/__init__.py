"""Device selection and the fault-tolerance runtime (counterpart of
``repro.runtime``): ``device`` picks the card, ``fault`` holds the
restartable loop, the straggler detector and the preemption signal,
``elastic`` sizes a grid for the surviving devices, ``faultinject`` holds
the seeded fault injectors, and ``replan`` the elastic replanner (with its
machine fit, ``fit_machine``)."""
from .elastic import choose_grid_shape, choose_mesh_shape  # noqa: F401
from .fault import (PreemptionSignal, RestartableLoop,  # noqa: F401
                    StragglerDetector)
from .faultinject import (DeviceLoss, StragglerInjector,  # noqa: F401
                          TransientFailure, record_straggler_drift)
