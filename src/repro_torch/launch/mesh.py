"""Device meshes on ``torch.distributed`` (the port of ``repro.launch.mesh``).

A mesh needs a process group, so these functions take one that is already
started (:func:`start_world`, :func:`start_fake_world`, or ``torchrun``'s)
and lay the world out over named axes with ``init_device_mesh``. Ranks are
row-major: the ``model`` axis holds consecutive ranks. Single-pod: 256 ranks
(16, 16) ('data', 'model'); multi-pod: 2 pods x 256 = 512 ranks ('pod',
'data', 'model') -- the pod axis is an extra data-parallel dimension.
"""
from __future__ import annotations

import os
import socket
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models.parallel import Axis


class Mesh:
    """A ``DeviceMesh`` with the views the port reads: ``shape`` (axis ->
    size) and ``axis_names`` as a JAX mesh has them, ``size``, this rank's
    ``coordinate``, and the :class:`Axis` of ``model`` (``tp``) and of the
    data-parallel axes taken together (``dp``: 'data', or 'pod' x 'data'
    with the pod major)."""

    def __init__(self, device_mesh, dp_group):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.shape))
        self.size = device_mesh.size()
        self.coordinate = dict(zip(self.axis_names,
                                   device_mesh.get_coordinate()))
        self.tp = self.axis("model")
        dp_rank, dp_size = 0, 1
        for a in dp_axes(self):
            dp_rank = dp_rank * self.shape[a] + self.coordinate[a]
            dp_size *= self.shape[a]
        self.dp = Axis(dp_group, dp_size, dp_rank)

    def axis(self, name: str) -> Axis:
        return Axis(self.device_mesh.get_group(name), self.shape[name],
                    self.coordinate[name])


def _mesh(shape, axes, device_type: str) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a started process group "
                           "(start_world / start_fake_world / torchrun)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    dm = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    if len(shape) == 2:
        dp_group = dm.get_group("data")
    else:  # 'pod' x 'data' as one axis
        dp_group = init_device_mesh(device_type, (shape[0] * shape[1], shape[2]),
                                    mesh_dim_names=("dp", "model")).get_group("dp")
    return Mesh(dm, dp_group)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ('data', 'model'), or (2, 16, 16) with 'pod', over the
    started world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, _device_type())


def make_host_mesh(data: int = 2, model: int = 4, pod: int = 0) -> Mesh:
    """A small mesh over the started world, for tests and the launcher."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), _device_type())
    return _mesh((data, model), ("data", "model"), _device_type())


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axis names of a mesh (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def tp_size(mesh) -> int:
    return mesh.shape["model"]


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(rank: int, world_size: int, *, backend: str,
                port: int) -> None:
    """Join a ``world_size``-rank process group on ``tcp://localhost:port``
    (every rank passes the same port)."""
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world_size)


def start_fake_world(world_size: int, rank: int = 0) -> None:
    """A process group of the ``fake`` backend: this one process plays
    ``rank`` of ``world_size``; collectives return at once and move no data
    (the dry-run traces one rank's work on fake tensors)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def world_from_env() -> bool:
    """True when ``torchrun``-style variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) describe a world to join."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def end_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def set_rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The card of a rank: ``cuda:<local_rank mod cards>`` (ranks share a
    card when there are fewer cards than ranks)."""
    if device.type != "cuda":
        return device
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
