"""Fault schedules for the port's serving engine (``runtime/fault.py``, a
copy of ``repro.runtime.fault``). The straggler monitor and elastic
resharding come with the training slice of the port."""
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector,
    FaultEvent,
    FaultPlan,
    SimulatedFailure,
    poisson_steps,
)
