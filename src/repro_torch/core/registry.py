"""Policy + hardware registry: name -> backend lookup for the simulator.

This is the extension seam the benchmarks and apps resolve through: a new
memory system is a :class:`~repro_torch.core.policy.MemPolicy` subclass plus
(optionally) a :class:`~repro_torch.core.hardware.HardwareModel`, registered once
and then selectable everywhere a policy name is accepted — ``run_app``,
``benchmarks/run.py --policy/--hw``, ``scripts/check_parity.py --policies``,
the serve stack's ``mem_policy`` knobs, and the policy-conformance contract
suite (tests/policy_contract.py), which runs against *every* registered
policy automatically.

    from repro_torch.core.registry import register_policy, register_hardware

    register_policy("gpuvm", gpuvm_policy)      # factory: (**knobs) -> MemPolicy
    register_hardware("gpuvm-sim", GPUVM_HW)    # a HardwareModel instance

``make_policy(name, **knobs)`` filters the harness's uniform knob set
(page_size, threshold, auto_migrate, speculative_prefetch, ...) down to the
parameters the factory actually declares, so one call site can drive every
backend without each factory accepting every knob.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Tuple, Union

from repro_torch.core.hardware import GRACE_HOPPER, MI300A, TPU_V5E, HardwareModel
from repro_torch.core.policy import (
    MemPolicy,
    explicit_policy,
    managed_policy,
    mi300a_unified_policy,
    system_policy,
)

_POLICIES: Dict[str, Callable[..., MemPolicy]] = {}
_HARDWARE: Dict[str, HardwareModel] = {}


def register_policy(name: str, factory: Callable[..., MemPolicy]) -> None:
    """Register a policy factory under ``name``. The factory takes keyword
    knobs (any subset of the harness set — see :func:`make_policy`) and
    returns a MemPolicy instance. Re-registering a name overwrites it."""
    _POLICIES[name] = factory


def make_policy(name: str, **knobs) -> MemPolicy:
    """Build the named policy, passing through only the knobs its factory
    declares (a factory with ``**kwargs`` receives them all)."""
    try:
        factory = _POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown memory policy {name!r}; registered: "
            f"{', '.join(available_policies())}") from None
    params = inspect.signature(factory).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return factory(**knobs)
    return factory(**{k: v for k, v in knobs.items() if k in params})


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


def register_hardware(name: str, hw: HardwareModel) -> None:
    _HARDWARE[name] = hw


def get_hardware(hw: Union[str, HardwareModel, None]) -> HardwareModel:
    """Resolve a hardware model: an instance passes through, a name looks
    up the registry, None means the default (grace-hopper)."""
    if hw is None:
        return GRACE_HOPPER
    if isinstance(hw, HardwareModel):
        return hw
    try:
        return _HARDWARE[hw]
    except KeyError:
        raise KeyError(
            f"unknown hardware model {hw!r}; registered: "
            f"{', '.join(available_hardware())}") from None


def available_hardware() -> Tuple[str, ...]:
    return tuple(sorted(_HARDWARE))


# built-in backends
register_policy("system", system_policy)
register_policy("managed", managed_policy)
register_policy("explicit", explicit_policy)
register_policy("mi300a_unified", mi300a_unified_policy)

register_hardware(GRACE_HOPPER.name, GRACE_HOPPER)
register_hardware(MI300A.name, MI300A)
register_hardware(TPU_V5E.name, TPU_V5E)

# the cluster subsystem self-registers its hardware models and node-aware
# policies on import; imported last so register_policy/register_hardware
# above are already bound (cluster modules import repro.core submodules
# directly, never attributes of the repro.core package, avoiding a cycle)
import repro_torch.cluster  # noqa: E402,F401
