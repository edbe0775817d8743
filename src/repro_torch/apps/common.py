"""Shared app harness: the AppSpec registry, policy factories, phases,
ballast oversubscription, charge fingerprints.

Every app follows the paper's Fig. 2 structure:
    alloc -> init (CPU- or GPU-side first touch) -> compute -> dealloc
in one of three memory-management versions: 'explicit' (original
cudaMalloc+memcpy), 'managed' (cudaMallocManaged), 'system' (malloc).

Apps are *buffer-centric*: they allocate typed UMBuffers via
``um.array``/``um.from_host`` (with numpy dtypes: ``UMBuffer`` calls
``np.dtype``), launch tracked kernels over buffer slices via ``um.launch``,
and wrap their compute region in ``um.staged(...)``, which charges the
explicit version's h2d/d2h copies at the phase boundaries.

The math is real PyTorch on the device the caller names (the CUDA card by
default); the *memory system* (placement, faults, counters, migrations,
traffic, modeled time) is the UnifiedMemory runtime in ``repro_torch.core``,
whose charges depend on neither the values nor the device. Oversubscription
uses the paper's own methodology (§3.2): a ballast explicit allocation
shrinks free device memory to hit a target ratio.

Each app module exports an :class:`AppSpec` (uniform runner + per-figure
size presets); ``repro_torch.apps.APPS`` is the registry.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import (
    HardwareModel,
    UnifiedMemory,
    explicit_policy,
    get_hardware,
    make_policy,
)

KB = 1024
MB = 1024 * 1024

# observers called with every UnifiedMemory make_um builds (the apps import
# make_um by name, so monkeypatching the module attribute would miss them)
_UM_HOOKS = []


def add_um_hook(fn) -> None:
    """Register ``fn(um)`` to be called on every make_um-built runtime."""
    _UM_HOOKS.append(fn)


def remove_um_hook(fn) -> None:
    _UM_HOOKS.remove(fn)


@dataclass
class AppResult:
    name: str
    policy: str
    page_size: int
    phase_times: Dict[str, float]
    checksum: float
    report: Dict[str, object]
    extra: Dict[str, object] = field(default_factory=dict)

    @property
    def total(self) -> float:
        return sum(self.phase_times.values())

    def time_excluding_cpu_init(self) -> float:
        """The paper excludes single-threaded CPU init when reporting (§3.1)."""
        return sum(v for k, v in self.phase_times.items() if k != "cpu_init")


@dataclass(frozen=True)
class AppSpec:
    """One paper app: a uniform runner plus its per-figure size presets.

    ``run(policy_kind, **kw)`` is the single entry point for every
    memory-management version; ``sizes`` holds the canonical keyword presets
    ("fig3", "fig11", "small") of the JAX package's apps."""
    name: str
    run: Callable[..., AppResult]
    init_actor: str  # "cpu" | "gpu": who first-touches the data (Fig. 3 class)
    sizes: Mapping[str, Mapping[str, object]]


def make_um(policy_kind: str, *, page_size: int = 64 * KB,
            hw: "HardwareModel | str | None" = None, auto_migrate: bool = True,
            oversub_ratio: float = 0.0, app_peak_bytes: int = 0,
            speculative_prefetch: int = 4, threshold: int = 256):
    """Build a UnifiedMemory + the policy for app buffers (+ballast if oversub).

    ``policy_kind`` is resolved through the backend registry
    (``repro_torch.core.registry``). ``hw`` may be a HardwareModel, a
    registered hardware name, or None (grace-hopper).

    oversub_ratio R > 1 shrinks free device memory so that
    app_peak_bytes / free == R (the paper's simulated oversubscription).
    The runtime's staging page size follows the app's system page size.
    """
    hw = get_hardware(hw)
    um = UnifiedMemory(hw=hw, staging_page_size=page_size)
    if oversub_ratio and oversub_ratio > 1.0:
        assert app_peak_bytes > 0
        target_free = int(app_peak_bytes / oversub_ratio)
        ballast = hw.device_capacity - target_free
        if ballast > 0:
            um.alloc("__ballast__", ballast, explicit_policy())
    pol = make_policy(policy_kind, page_size=page_size,
                      auto_migrate=auto_migrate, threshold=threshold,
                      speculative_prefetch=speculative_prefetch)
    for hook in _UM_HOOKS:
        hook(um)
    return um, pol


def finish(um: UnifiedMemory, name: str, policy_kind: str, page_size: int,
           checksum: float, **extra) -> AppResult:
    rep = um.report()
    extra = dict(extra, hw=um.hw.name)
    return AppResult(
        name=name,
        policy=policy_kind,
        page_size=page_size,
        phase_times=dict(um.prof.phase_times),
        checksum=float(checksum),
        report=rep,
        extra=extra,
    )


def charge_snapshot(r: AppResult) -> Dict[str, object]:
    """Full-precision charge fingerprint of one app run.

    Phase times are serialized as float hex (bit-exact round trip), traffic
    counters as ints — the format of tests/fixtures/parity.json.
    """
    rep = r.report
    return {
        "phase_times": {k: float(v).hex() for k, v in sorted(r.phase_times.items())},
        "traffic_total": {k: int(v) for k, v in sorted(rep["traffic_total"].items())},
        "traffic_phases": {ph: {k: int(v) for k, v in sorted(tr.items())}
                           for ph, tr in sorted(rep["traffic"].items())},
    }


class DeviceTimer:
    """Device time between :meth:`start` and :meth:`stop`, from CUDA events.

    On the CPU it measures nothing and :meth:`ms` returns None: a CPU run
    gives no device time."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t1 = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self._t0.record()

    def stop(self) -> None:
        if self.cuda:
            self._t1.record()

    def ms(self) -> Optional[float]:
        if not self.cuda:
            return None
        self._t1.synchronize()
        return self._t0.elapsed_time(self._t1)


def uniform(shape, seed: int, device: torch.device) -> torch.Tensor:
    """U[0, 1) float32 drawn on ``device`` from a generator seeded ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def host_input(arr, device: torch.device) -> torch.Tensor:
    """A copy of an input array given by the caller, as float32 on ``device``."""
    return torch.tensor(np.asarray(arr), dtype=torch.float32, device=device)
