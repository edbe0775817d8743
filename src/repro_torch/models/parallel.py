"""Collectives of the port's tensor and data parallelism, on
``torch.distributed``.

The launch layer (``repro_torch.launch``) gives each rank explicit local
shards: every parameter is ``chunk(n, dim)[rank]`` of the full tensor along
the dims its spec names (``launch/sharding.py``), and the blocks call
collectives at the Megatron points. An :class:`Axis` is one mesh axis as a
rank sees it: the process group, its size and this rank's index in it. The
spec helpers at the end (:func:`local_chunk`, :func:`gather_full`,
:func:`spec_leaves`, :func:`zero_dim`) cut a tensor to its chunk and back;
the sharding rules that make the specs live in ``launch/sharding.py``.

Autograd through a collective follows the conjugate pairs of Megatron-LM:

* :func:`copy_to` -- identity forward, all-reduce of the gradient backward.
  A tensor replicated over the model axis passes it before it enters
  rank-local (sharded) work, so each rank's partial gradient is summed.
* :func:`reduce_from` -- all-reduce forward, identity backward: the end of a
  row-parallel product, whose output is replicated and whose gradient each
  rank already holds whole.
* :func:`gather_from` -- all-gather forward, this rank's slice of the
  gradient backward: a sharded activation that replicated work reads whole.

Under sequence parallelism (``RunPolicy.sequence_parallel``; :func:`seq_axis`
says where it applies) the residual between blocks, and between a block's
mixer and its FFN, is split on the sequence over the model axis: each rank
holds ``S / tp`` consecutive positions, in rank order. Megatron-LM's
sequence-parallel pairs then take the place of the two above:

* :func:`gather_to` -- all-gather on S forward, reduce-scatter of the
  gradient backward: the input of a column-parallel region, whose ranks
  each hold a partial gradient of the whole sequence.
* :func:`reduce_scatter_from` -- reduce-scatter on S forward, all-gather
  of the gradient backward: the end of a row-parallel region.
* :func:`scatter_to` -- this rank's positions forward, all-gather of the
  gradient backward: a replicated tensor made seq-split.

:func:`copy_in` and :func:`reduce_out` pick the pair of a region's entry
and exit. A replicated parameter applied to seq-split activations passes
:func:`copy_to`, so that its gradient is summed over the model axis.

(``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
too, which makes it ``n`` times too large where the upstream gradient is
replicated.) A replicated tensor thus always carries its whole gradient,
and a replicated parameter's gradient is the same on every rank.

Every collective is skipped on an axis of one rank. gloo carries CUDA
tensors for only part of its collectives, so on a gloo group every CUDA
tensor is staged through the host (:data:`HOST_STAGED` counts them); NCCL
and the ``fake`` backend of the dry-run take the tensors as they are.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

HOST_STAGED: Counter = Counter()  # collective name -> calls staged via host


@dataclass(frozen=True)
class Axis:
    """One mesh axis from this rank: its process group (None for a single
    rank), size and this rank's index along it."""

    group: Any
    size: int
    rank: int


def _staged(t: torch.Tensor, group, name: str) -> bool:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        HOST_STAGED[name] += 1
        return True
    return False


def all_reduce_(t: torch.Tensor, axis: Optional[Axis],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor over ``axis``."""
    if axis is None or axis.size == 1:
        return t
    if _staged(t, axis.group, "all_reduce"):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=axis.group)
        return t.copy_(h)
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def all_gather(t: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """The ``axis.size`` ranks' ``t`` concatenated along ``dim``, in rank
    order (no autograd)."""
    if axis is None or axis.size == 1:
        return t
    dim = dim % t.dim()
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((axis.size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    if _staged(t, axis.group, "all_gather_into_tensor"):
        h = torch.empty(out.shape, dtype=t.dtype)
        dist.all_gather_into_tensor(h, src.cpu(), group=axis.group)
        out.copy_(h)
    else:
        dist.all_gather_into_tensor(out, src, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, axis: Optional[Axis]
                   ) -> torch.Tensor:
    """The sum of the ``axis.size`` ranks' ``t``, cut into ``axis.size``
    equal pieces along ``dim`` (which it must divide): this rank's piece
    (no autograd)."""
    if axis is None or axis.size == 1:
        return t
    dim = dim % t.dim()
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // axis.size,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    if _staged(t, axis.group, "reduce_scatter_tensor"):
        h = torch.empty(out.shape, dtype=t.dtype)
        dist.reduce_scatter_tensor(h, src.cpu(), group=axis.group)
        out.copy_(h)
    else:
        dist.reduce_scatter_tensor(out, src, group=axis.group)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Piece j of dim 0 (``axis.size`` equal pieces) goes to rank j; the
    result's piece i came from rank i (no autograd)."""
    src = t.contiguous()
    out = torch.empty_like(src)
    if axis.size == 1:
        return out.copy_(src)
    if _staged(t, axis.group, "all_to_all_single"):
        h = torch.empty(src.shape, dtype=t.dtype)
        dist.all_to_all_single(h, src.cpu(), group=axis.group)
        return out.copy_(h)
    dist.all_to_all_single(out, src, group=axis.group)
    return out


def local_slice(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's ``chunk(axis.size, dim)`` of ``t``."""
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.axis).contiguous(), None, None


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.axis), None, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axis), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return local_slice(x, dim, axis).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axis), None, None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _GatherFrom.apply(x, dim % x.dim(), axis)


def gather_to(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _GatherTo.apply(x, dim % x.dim(), axis)


def reduce_scatter_from(x: torch.Tensor, dim: int,
                        axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _ReduceScatterFrom.apply(x, dim % x.dim(), axis)


def scatter_to(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _ScatterTo.apply(x, dim % x.dim(), axis)


def copy_in(x: torch.Tensor, axis: Optional[Axis],
            seq: Optional[Axis] = None) -> torch.Tensor:
    """The entry of a region split over ``axis`` (None: replicated work) of
    an activation (B,S,...) that is seq-split over ``seq``, or whole
    (``seq`` None): :func:`copy_to`, else the whole sequence by
    :func:`gather_to` (split work) or :func:`gather_from` (replicated)."""
    if seq is None:
        return copy_to(x, axis)
    return gather_to(x, 1, seq) if axis is not None else gather_from(x, 1, seq)


def reduce_out(x: torch.Tensor, axis: Optional[Axis],
               seq: Optional[Axis] = None) -> torch.Tensor:
    """The exit of such a region, (B,S,...) over the whole sequence:
    :func:`reduce_from`, or this rank's positions of the sum by
    :func:`reduce_scatter_from` (split work) or :func:`scatter_to`
    (replicated)."""
    if seq is None:
        return reduce_from(x, axis)
    if axis is None:
        return scatter_to(x, 1, seq)
    return reduce_scatter_from(x, 1, seq)


def tp_axis(policy, sharded: bool = True) -> Optional[Axis]:
    """The model axis of ``policy.mesh`` where a module's work is split over
    it (``sharded``), else None: the module then runs replicated."""
    mesh = getattr(policy, "mesh", None)
    if mesh is None or not sharded or mesh.tp.size == 1:
        return None
    return mesh.tp


def seq_axis(policy, S: int) -> Optional[Axis]:
    """The model axis where sequence parallelism splits a residual of ``S``
    positions over it (``policy.sequence_parallel``, a model axis of more
    than one rank that divides S), else None: the residual is whole."""
    ax = tp_axis(policy)
    if ax is None or not getattr(policy, "sequence_parallel", False) \
            or S % ax.size:
        return None
    return ax


def dp_axis(policy) -> Optional[Axis]:
    """The data-parallel axes of ``policy.mesh`` as one axis, or None."""
    mesh = getattr(policy, "mesh", None)
    if mesh is None or mesh.dp.size == 1:
        return None
    return mesh.dp


def split_local(n: int, axis: Optional[Axis]) -> bool:
    """True when a dimension of ``n`` is split over ``axis`` (the sharding
    rules split a dim only where the axis divides it)."""
    return axis is not None and n % axis.size == 0


def param_local(p: torch.Tensor, dim: int, full: int,
                axis: Optional[Axis]) -> torch.Tensor:
    """This rank's part of a parameter along ``dim``: the parameter itself
    when it is held sharded, else the local slice of the replicated one,
    through :func:`copy_to` so the ranks' partial gradients are summed."""
    if axis is None or p.shape[dim] != full:
        return p
    return local_slice(copy_to(p, axis), dim, axis)


# ---------------------------------------------------------------------------
# Specs: a tuple with one entry per dim, as a JAX ``PartitionSpec`` reads --
# None (replicated), an axis name, or a tuple of axis names (the dim split
# over their product, the first axis major). A mesh (``launch/mesh.py``)
# gives each axis name's ``shape`` and this rank's ``coordinate``, and its
# ``tp``/``dp`` Axis.
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]


def spec_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def flat_specs(specs, prefix=""):
    """(path, spec) pairs of a spec tree in leaf order (spec tuples are
    leaves)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from flat_specs(specs[k], f"{prefix}{k}/")
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from flat_specs(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], specs


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (``repro_torch.tree``'s)."""
    return [s for _, s in flat_specs(specs)]


def _coord(entry, mesh) -> Tuple[int, int]:
    """(size, this rank's index) of a spec entry's axes, the first major."""
    size, idx = 1, 0
    for a in spec_axes(entry):
        size *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coordinate[a]
    return size, idx


def local_chunk(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's chunk of the full tensor ``t`` under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size, idx = _coord(entry, mesh)
        n = t.shape[dim] // size
        t = t.narrow(dim, idx * n, n)
    return t


def gather_full(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's chunk under ``spec`` (collective;
    no autograd)."""
    t = t.detach()
    for dim, entry in enumerate(spec):
        if entry is not None:
            axis = mesh.tp if spec_axes(entry) == ("model",) else mesh.dp
            t = all_gather(t, dim, axis)
    return t


def zero_dim(p_spec: Spec, z_spec: Spec) -> Optional[int]:
    """The dim where ZeRO-1 adds the DP axes to a param's spec, or None."""
    for i, z in enumerate(z_spec):
        if z is not None and (i >= len(p_spec) or p_spec[i] is None):
            return i
    return None
