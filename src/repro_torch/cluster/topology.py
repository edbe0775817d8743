"""Cluster hardware: N GH200 superchips presented as one logical pool.

A :class:`ClusterHardwareModel` is a plain :class:`HardwareModel` (so every
single-node code path — device_bw, link_h2d/d2h, PTE costs — keeps working
untouched) plus the multi-superchip dimension: the node count, the per-node
device capacity, and a :class:`ClusterTopology` describing the two
inter-node lanes. Intra-node CPU<->GPU stays the NVLink-C2C link the base
model already prices; between nodes, device<->device traffic rides NVLink
(NVSwitch-class) and host-side traffic rides the slower node fabric.

Bandwidth/latency defaults follow the quad-GH200 measurements in Khalilov
et al. (arXiv:2408.11556): ~100 GB/s effective per-pair NVLink between
Hopper GPUs, ~25 GB/s host-routed fabric, with microsecond-scale one-way
latencies. They are deliberately round numbers — the cluster model is a
first-order cost model, like the rest of the simulator.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.hardware import GRACE_HOPPER, HardwareModel
from repro_torch.core.registry import register_hardware


@dataclass(frozen=True)
class ClusterTopology:
    """Inter-node link constants (intra-node C2C lives on HardwareModel)."""

    nvlink_bw: float = 100e9  # device<->device between nodes (bytes/s)
    fabric_bw: float = 25e9  # host<->host / host-routed between nodes
    nvlink_latency: float = 2.0e-6  # per contiguous transfer (run)
    fabric_latency: float = 5.0e-6


@dataclass(frozen=True)
class ClusterHardwareModel(HardwareModel):
    """N superchips as one pool. ``device_capacity`` is the cluster-wide
    total (``nodes * node_device_capacity``), so capacity-aware single-node
    code sees the logical pool; node-aware policies budget per node via
    ``node_device_capacity``."""

    nodes: int = 1
    node_device_capacity: int = 0
    topology: ClusterTopology = ClusterTopology()

    def with_device_capacity(self, nbytes: int) -> "ClusterHardwareModel":
        # keep the per-node split consistent: shrinking the pool (the
        # oversubscription harness does this) shrinks every node equally
        per = -(-int(nbytes) // self.nodes)
        return dataclasses.replace(self, device_capacity=per * self.nodes,
                                   node_device_capacity=per)


def gh200_cluster(nodes: int, *,
                  node_device_capacity: Optional[int] = None,
                  topology: Optional[ClusterTopology] = None,
                  base: HardwareModel = GRACE_HOPPER,
                  name: Optional[str] = None) -> ClusterHardwareModel:
    """An N-superchip cluster derived from a single-superchip base model."""
    assert nodes >= 1, nodes
    cap = (base.device_capacity if node_device_capacity is None
           else int(node_device_capacity))
    cfg = {f.name: getattr(base, f.name)
           for f in dataclasses.fields(HardwareModel)}
    cfg["name"] = name or f"gh200_x{nodes}"
    cfg["device_capacity"] = nodes * cap
    return ClusterHardwareModel(nodes=nodes, node_device_capacity=cap,
                                topology=topology or ClusterTopology(),
                                **cfg)


GH200_X2 = gh200_cluster(2)
GH200_X4 = gh200_cluster(4)

register_hardware(GH200_X2.name, GH200_X2)
register_hardware(GH200_X4.name, GH200_X4)
