"""Hardware models for the unified-memory cost model.

GRACE_HOPPER is calibrated from the paper's own measurements (§2.1): STREAM
HBM3 3.4 TB/s, LPDDR5X 486 GB/s, Comm|Scope NVLink-C2C 375 GB/s H2D /
297 GB/s D2H. Page-fault and PTE-init constants are fitted to the paper's
observations (§5.1.2, §5.2: 64 KB pages cut GPU-first-touch init ~5x and
alloc/dealloc 4.6-38x; managed fault handling ~20 us per fault group).

TPU_V5E is the deployment target of the LM framework (roofline constants per
the assignment: 197 bf16 TFLOP/s, 819 GB/s HBM, ~50 GB/s/link ICI; host link
is PCIe-class).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareModel:
    name: str
    # compute
    flops_rate: float  # peak FLOP/s for the app's compute dtype
    # memory system
    device_bw: float  # device-local memory bandwidth (bytes/s)
    host_bw: float  # host memory bandwidth (bytes/s)
    link_h2d: float  # host->device interconnect (bytes/s)
    link_d2h: float  # device->host interconnect (bytes/s)
    device_capacity: int  # bytes of device memory
    # granularity
    remote_access_grain: int  # bytes per remote transaction (cacheline / DMA block)
    remote_efficiency: float  # achieved fraction of link bw for fine-grain access
    # software costs (seconds)
    page_fault_cost: float  # fault handling on the migration path (managed)
    pte_init_cpu: float  # per-page PTE creation, CPU first-touch
    pte_init_gpu: float  # per-page PTE creation, GPU first-touch of system memory
    #   (SMMU -> OS round-trip; the paper's §5.1.2 bottleneck)
    alloc_per_page: float  # per-page allocation bookkeeping
    dealloc_per_page: float  # per-page deallocation (dominates at 4 KB, Fig. 6)
    migrate_per_page: float  # per-page migration overhead (driver + TLB shootdown)
    kernel_launch: float = 5e-6
    # managed memory under heavy oversubscription stops migrating and serves
    # faults remotely at low bandwidth (paper §7, 34-qubit case)
    managed_thrash_efficiency: float = 0.35

    def with_device_capacity(self, nbytes: int) -> "HardwareModel":
        """This model with a different device capacity — the one derived
        rebuild the oversubscription harnesses need. Multi-node models
        override it to keep their per-node split consistent, which is why
        callers must go through this instead of dataclasses.replace."""
        return dataclasses.replace(self, device_capacity=int(nbytes))


GRACE_HOPPER = HardwareModel(
    name="grace-hopper",
    flops_rate=67e12,  # H100 fp32 (apps are fp32/fp64 HPC kernels)
    device_bw=3.4e12,
    host_bw=486e9,
    link_h2d=375e9,
    link_d2h=297e9,
    device_capacity=96 * 1024**3,
    remote_access_grain=128,
    remote_efficiency=0.85,
    page_fault_cost=20e-6,
    pte_init_cpu=0.35e-6,
    pte_init_gpu=1.8e-6,
    alloc_per_page=0.05e-6,
    dealloc_per_page=0.30e-6,
    migrate_per_page=0.6e-6,
)

MI300A = HardwareModel(
    # AMD MI300A APU: CPU (24 Zen 4 cores) and GPU (CDNA3) share one 128 GB
    # HBM3 pool behind one page table ("Dissecting CPU-GPU Unified Physical
    # Memory on AMD MI300A APUs"). Device/host/link bandwidths are the SAME
    # physical memory — the Mi300aUnifiedPolicy never migrates, and the
    # equal rates below make access cost uniform no matter which "side" a
    # page's bookkeeping tier says it is on.
    name="mi300a",
    flops_rate=122.6e12,  # CDNA3 fp32 vector peak
    device_bw=3.7e12,  # achieved HBM3 STREAM-class bandwidth (5.3 TB/s peak)
    host_bw=3.7e12,  # CPU cores hit the same HBM3 pool
    link_h2d=3.7e12,  # "link" = on-package Infinity Fabric to the same pool
    link_d2h=3.7e12,
    device_capacity=128 * 1024**3,  # the whole unified pool
    remote_access_grain=128,
    remote_efficiency=1.0,  # no fine-grain penalty: one physical memory
    page_fault_cost=0.0,  # no fault-driven migration path exists
    pte_init_cpu=0.3e-6,
    pte_init_gpu=0.3e-6,  # shared page table: GPU first touch == CPU's
    alloc_per_page=0.05e-6,
    dealloc_per_page=0.3e-6,
    migrate_per_page=0.0,  # nothing ever migrates
)

TPU_V5E = HardwareModel(
    name="tpu-v5e",
    flops_rate=197e12,  # bf16
    device_bw=819e9,
    host_bw=200e9,
    link_h2d=32e9,  # PCIe-class host link
    link_d2h=32e9,
    device_capacity=16 * 1024**3,
    remote_access_grain=4096,  # DMA-efficient streaming block
    remote_efficiency=0.9,
    page_fault_cost=30e-6,  # runtime round-trip (no hardware faults on TPU)
    pte_init_cpu=0.2e-6,
    pte_init_gpu=1.0e-6,
    alloc_per_page=0.05e-6,
    dealloc_per_page=0.2e-6,
    migrate_per_page=0.5e-6,
)

# ICI / roofline constants (assignment-mandated)
V5E_PEAK_FLOPS = 197e12
V5E_HBM_BW = 819e9
V5E_ICI_BW = 50e9
