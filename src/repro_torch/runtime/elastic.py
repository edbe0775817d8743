"""Elastic rescaling: move a logical state tree onto another device, and
resize a UnifiedMemory's device (the port of ``repro.runtime.elastic``).

Checkpoints are logically addressed (checkpoint/manager.py), so elastic
scale-up/down = restore onto the new device. For a live move (no
checkpoint round trip) :func:`reshard_tree` gathers to the host and places
each leaf again. The mesh-sharded form comes with the launch slice of the
port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.tree import tree_map


def reshard_tree(tree, device=None):
    """tree of tensors / numpy arrays -> tensors on ``device`` (the CUDA
    card unless the caller passes ``device="cpu"``), through the host."""
    dev = resolve_device(device)
    host = tree_map(lambda a: torch.as_tensor(a).detach().cpu(), tree)
    return tree_map(lambda a: a.to(dev), host)


def resize_um_capacity(um, nbytes: int):
    """Elastic resize as a UnifiedMemory pressure event: swap in a hardware
    model with the new device capacity (``with_device_capacity`` keeps a
    multi-node model's per-node split consistent — never
    dataclasses.replace here). Shrinking moves no pages eagerly: the next
    first-touch / migration simply sees the reduced headroom and the
    allocation's policy evicts or spills exactly as it would under any
    other pressure, so the application's math (and a training run's
    losses) are untouched. Returns the new hardware model."""
    um.hw = um.hw.with_device_capacity(int(nbytes))
    um._sample()
    return um.hw
