"""Memory utilization profiler (paper §3.2).

Samples per-tier resident bytes over *modeled* time whenever the runtime
state changes — the RSS / nvidia-smi analogue — and aggregates per-phase
durations and traffic counters (the Fig. 4/5 timelines and Fig. 10/12
traffic plots are drawn from this)."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TrafficCounters:
    link_h2d: int = 0  # bytes over the interconnect, host->device
    link_d2h: int = 0
    remote_h2d: int = 0  # GPU kernel reads served remotely from host memory
    remote_d2h: int = 0  # GPU kernel writes landing remotely in host memory
    device_local: int = 0  # bytes served from device memory
    host_local: int = 0  # bytes served from host memory (CPU-side access)
    faults: int = 0
    notifications: int = 0
    migrated_in: int = 0  # bytes migrated host->device
    migrated_out: int = 0
    pte_inits_cpu: int = 0
    pte_inits_gpu: int = 0

    def merge(self, other: "TrafficCounters") -> None:
        for k, v in vars(other).items():
            setattr(self, k, getattr(self, k) + v)


@dataclass
class MemoryProfiler:
    driver_baseline: int = 600 * 1024 * 1024  # nvidia-smi baseline (§3.2)
    timeline: List[Tuple[float, int, int]] = field(default_factory=list)
    phase_times: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    phase_traffic: Dict[str, TrafficCounters] = field(
        default_factory=lambda: defaultdict(TrafficCounters))
    # per-kernel-label aggregation (modeled seconds + launch counts): labels
    # default to operand-derived names (see UnifiedMemory.launch), so two
    # different unnamed kernels never collapse into one ambiguous bucket
    kernel_times: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    kernel_counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    # open-ended integer side counters (e.g. the cluster layer's inter-node
    # byte lanes). Kept OUT of TrafficCounters on purpose: the golden parity
    # fixture snapshots vars(TrafficCounters), so new backends extend the
    # traffic vocabulary here without perturbing single-node snapshots.
    extra: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _phase: str = "default"
    # running peaks: sample() is O(1) per op (the runtime hands it cached
    # residency totals, never re-scanning per-allocation tier arrays) and
    # report() no longer walks the whole timeline
    _peak_host: int = 0
    _peak_device: int = 0

    def set_phase(self, name: str) -> None:
        self._phase = name

    @property
    def phase(self) -> str:
        return self._phase

    def sample(self, t: float, host_bytes: int, device_bytes: int) -> None:
        dev = device_bytes + self.driver_baseline
        self.timeline.append((t, host_bytes, dev))
        if host_bytes > self._peak_host:
            self._peak_host = host_bytes
        if dev > self._peak_device:
            self._peak_device = dev

    def charge(self, seconds: float) -> None:
        self.phase_times[self._phase] += seconds

    def record_kernel(self, name: str, seconds: float) -> None:
        """Attribute one kernel's modeled step time to its label."""
        self.kernel_times[name] += seconds
        self.kernel_counts[name] += 1

    def traffic(self) -> TrafficCounters:
        return self.phase_traffic[self._phase]

    def total_time(self) -> float:
        return sum(self.phase_times.values())

    def report(self) -> Dict[str, object]:
        total = TrafficCounters()
        for t in self.phase_traffic.values():
            total.merge(t)
        return {
            "phase_times_s": dict(self.phase_times),
            "kernel_times_s": dict(self.kernel_times),
            "kernel_counts": dict(self.kernel_counts),
            "total_time_s": self.total_time(),
            "traffic": {k: vars(v) for k, v in self.phase_traffic.items()},
            "traffic_total": vars(total),
            "traffic_extra": dict(self.extra),
            # share of GPU kernel read bytes served remotely from host memory
            # — the oversubscription benchmarks' headline degradation metric
            # (counted at the kernel remote-access sites, so migrations and
            # explicit cudaMemcpy traffic never pollute it)
            "remote_access_share": total.remote_h2d / max(
                1, total.remote_h2d + total.device_local),
            "peak_device_bytes": self._peak_device,
            "peak_host_bytes": self._peak_host,
        }
