"""NVIDIA H100 SXM5 constants, from NVIDIA's H100 Tensor Core GPU data sheet
(SXM5 column), for the port's roofline and charge model.

  bf16 dense tensor-core peak   989 TFLOP/s  (1979 with 2:4 sparsity)
  fp32 (non-tensor) peak         67 TFLOP/s
  HBM3 bandwidth               3.35 TB/s
  HBM3 capacity                  80 GB
  NVLink (4th gen)              900 GB/s a GPU, both directions together:
                                450 GB/s a direction, inside one 8-GPU node
  PCIe Gen5 x16                 128 GB/s both directions: 64 GB/s a direction

Collective link of the (16, 16) mesh: its 16-rank 'model' group (ranks
packed on nodes, ``launch.sharding.tp_shard_nodes``) spans two 8-GPU NVLink
nodes, so each ring crosses the inter-node fabric; a ring runs at its
slowest hop. The binding link is NDR InfiniBand, 400 Gb/s = 50 GB/s a GPU
a direction (one ConnectX-7 port per GPU, as in a DGX H100), not NVLink's
450 GB/s. Importing this module (``repro_torch.core`` does) registers
``h100-sxm`` with the charge model (``register_hardware``): the H100's own
numbers where the data sheet gives them, the Hopper fault and migration
costs of ``GRACE_HOPPER`` otherwise, and a PCIe Gen5 host link in place of
NVLink-C2C.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import GRACE_HOPPER
from repro_torch.core.registry import register_hardware

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BW = 3.35e12
HBM_BYTES = 80 * 10**9
IB_NDR_BW = 50e9
PCIE5_BW_DIR = 64e9

H100_SXM = dataclasses.replace(
    GRACE_HOPPER, name="h100-sxm", flops_rate=PEAK_FP32_FLOPS,
    device_bw=HBM_BW, link_h2d=PCIE5_BW_DIR, link_d2h=PCIE5_BW_DIR,
    device_capacity=HBM_BYTES)

register_hardware(H100_SXM.name, H100_SXM)
