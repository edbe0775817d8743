"""Runtime services of the port: failure schedules and fault plans
(``fault.py``) and the straggler monitor (``straggler.py``), both copies of
the JAX package's files, and elastic rescaling (``elastic.py``)."""
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector,
    FaultEvent,
    FaultPlan,
    SimulatedFailure,
    poisson_steps,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import reshard_tree, resize_um_capacity  # noqa: F401
