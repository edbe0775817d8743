# The paper's primary contribution: the Grace Hopper unified-memory system
# (system page table, first-touch, access-counter delayed migration,
# fault-driven managed migration, oversubscription) as a composable runtime
# with pluggable memory-policy backends (see core/policy.py + core/registry.py).
from repro_torch.core.buffer import BufferView, UMBuffer  # noqa: F401
from repro_torch.core.hardware import GRACE_HOPPER, MI300A, TPU_V5E, HardwareModel  # noqa: F401
from repro_torch.core.pagetable import Actor, BlockTable, Tier, coalesce_runs  # noqa: F401
from repro_torch.core.runs import RunMap, union_runs  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    ExplicitPolicy,
    ManagedPolicy,
    MemPolicy,
    Mi300aUnifiedPolicy,
    PolicyConfig,
    SystemPolicy,
    explicit_policy,
    managed_policy,
    mi300a_unified_policy,
    system_policy,
)
from repro_torch.core.registry import (  # noqa: F401
    available_hardware,
    available_policies,
    get_hardware,
    make_policy,
    register_hardware,
    register_policy,
)
from repro_torch.core.profiler import MemoryProfiler, TrafficCounters  # noqa: F401
from repro_torch.core.umem import (  # noqa: F401
    Allocation,
    HostSpillError,
    KernelBatch,
    KernelLaunch,
    OutOfDeviceMemory,
    UnifiedMemory,
)
# NVIDIA H100 SXM constants (the port's roofline), registered as 'h100-sxm'
from repro_torch.core import h100  # noqa: F401,E402
