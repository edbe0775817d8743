"""Typed buffers over UnifiedMemory allocations: the application front-end.

The runtime's native currency is the raw byte range ``(Allocation, lo, hi)``.
Applications should never hand-write those: a :class:`UMBuffer` knows its
shape/dtype/itemsize and maps numpy-style expressions to byte extents —

    buf[i:j]          leading-axis slice (elements for 1-D, rows for N-D)
    buf.rows(lo, hi)  explicit 2-D row band
    buf[:]            the whole buffer
    buf.byterange(lo, hi)  escape hatch for byte-granular extents

— each returning a :class:`BufferView` that ``UnifiedMemory.launch`` (and
``prefetch``/``prefetch_async``/``demote``) resolves to the exact byte math
the raw API used, so modeled charges are bit-identical.

A buffer created with ``um.from_host`` additionally carries a host *staging*
allocation under the explicit policy (the cudaMalloc + malloc pair): a
CPU-actor launch lands in the staging buffer, a GPU-actor launch in the
device buffer, and ``um.staged(...)`` charges the h2d/d2h copies at phase
boundaries. Under managed/system policies the staging allocation does not
exist and the same application code path exercises first-touch, fault, and
access-counter behavior — the paper's "one code path, three policies" story.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.pagetable import Actor

__all__ = ["UMBuffer", "BufferView", "as_view"]


class BufferView:
    """A byte extent [lo, hi) of a :class:`UMBuffer`.

    Views are what launch/prefetch/demote consume; ``resolve(actor)`` lowers
    the view to the runtime's raw ``(Allocation, lo, hi)`` range, picking the
    host staging allocation for CPU actors of staged (explicit) buffers."""

    __slots__ = ("buf", "lo", "hi")

    def __init__(self, buf: "UMBuffer", lo: int, hi: int):
        assert 0 <= lo <= hi <= buf.nbytes, (buf.name, lo, hi, buf.nbytes)
        self.buf = buf
        self.lo = lo
        self.hi = hi

    @property
    def nbytes(self) -> int:
        return self.hi - self.lo

    def resolve(self, actor: Actor = Actor.GPU):
        """Lower to the runtime Range: (Allocation, lo_byte, hi_byte).
        Routing is the policy's ``resolve_actor_side`` hook — the explicit
        backend sends CPU actors to the malloc'd staging side of the pair."""
        return self.buf.policy.resolve_actor_side(self, actor)

    def page_extent(self) -> Tuple[int, int]:
        """The [lo_page, hi_page) extent this view resolves to (paged
        allocations only) — what kernel() operates on."""
        table = self.buf.alloc.table
        assert table is not None, "explicit allocations have no page table"
        return table.page_range(self.lo, self.hi)

    def page_runs(self, tier=None):
        """The view's extent resolved against the run-compressed page table:
        (starts, ends, tiers) of the tier runs it overlaps, or just
        (starts, ends) of the sub-runs in `tier` when one is given. O(runs
        overlapping the view), never O(pages) — the introspection twin of
        what kernel() does internally."""
        table = self.buf.alloc.table
        assert table is not None, "explicit allocations have no page table"
        p0, p1 = table.page_range(self.lo, self.hi)
        if tier is None:
            return table.tier_runs(p0, p1)
        return table.runs_of(tier, p0, p1)

    def __repr__(self) -> str:
        return f"BufferView({self.buf.name!r}, [{self.lo}, {self.hi}))"


class UMBuffer:
    """A shaped, typed view over one UnifiedMemory allocation (plus an
    optional explicit-policy host staging allocation). Built via
    ``UnifiedMemory.array`` / ``UnifiedMemory.from_host``."""

    def __init__(self, um, alloc, shape, dtype, host=None):
        self.um = um
        self.alloc = alloc
        self.host = host  # explicit policy: the malloc'd staging buffer
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.itemsize = self.dtype.itemsize
        self.nbytes = int(math.prod(self.shape)) * self.itemsize
        assert self.nbytes == alloc.nbytes, \
            f"{alloc.name}: shape {self.shape} x {self.dtype} != {alloc.nbytes}B"
        # bytes per leading-axis element (the slice unit): itemsize for 1-D,
        # a full row for N-D
        self.row_bytes = (int(math.prod(self.shape[1:])) * self.itemsize
                          if len(self.shape) > 1 else self.itemsize)

    # ----------------------------------------------------------- properties
    @property
    def name(self) -> str:
        return self.alloc.name

    @property
    def policy(self):
        return self.alloc.policy

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    def __len__(self) -> int:
        return self.shape[0]

    # -------------------------------------------------------------- slicing
    def __getitem__(self, key) -> BufferView:
        if key is Ellipsis:
            return BufferView(self, 0, self.nbytes)
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self.shape[0]
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"{self.name}[{key}]: axis-0 size {self.shape[0]}")
            return BufferView(self, i * self.row_bytes, (i + 1) * self.row_bytes)
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise ValueError(
                    f"{self.name}[{key}]: UMBuffer slices must be contiguous "
                    "(step 1) — strided extents are not a page-range")
            lo, hi, _ = key.indices(self.shape[0])
            hi = max(lo, hi)
            return BufferView(self, lo * self.row_bytes, hi * self.row_bytes)
        raise TypeError(f"{self.name}[{key!r}]: index with an int, a step-1 "
                        "slice, or ... (leading axis only)")

    def rows(self, lo: int, hi: int) -> BufferView:
        """Row band [lo, hi) of a 2-D (or N-D) buffer as one extent."""
        assert len(self.shape) >= 2, f"{self.name}: rows() needs an N-D buffer"
        assert 0 <= lo <= hi <= self.shape[0], (lo, hi, self.shape)
        return BufferView(self, lo * self.row_bytes, hi * self.row_bytes)

    def byterange(self, lo: int, hi: int) -> BufferView:
        """Raw byte extent [lo, hi) — for access patterns computed in byte
        space (e.g. page-aligned streaming windows). Prefer element slices."""
        return BufferView(self, lo, hi)

    # ------------------------------------------------------------ lifecycle
    def free(self) -> None:
        """Free the allocation (and its staging pair, in allocation order)."""
        self.um.free(self.alloc)
        if self.host is not None and not self.host.freed:
            self.um.free(self.host)

    @property
    def freed(self) -> bool:
        return self.alloc.freed

    def __repr__(self) -> str:
        kind = self.policy.kind + ("+staged" if self.host is not None else "")
        return f"UMBuffer({self.name!r}, {self.shape}, {self.dtype}, {kind})"


def as_view(obj, *, whole_ok: bool = True) -> BufferView:
    """Coerce launch/staged arguments: a BufferView passes through, a
    UMBuffer means its whole extent."""
    if isinstance(obj, BufferView):
        return obj
    if isinstance(obj, UMBuffer) and whole_ok:
        return BufferView(obj, 0, obj.nbytes)
    raise TypeError(f"expected UMBuffer or BufferView, got {type(obj).__name__}")
