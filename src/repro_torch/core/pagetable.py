"""BlockTable: the software analogue of the Grace Hopper system page table.

One table per allocation. Pages start *unmapped* (PTEs exist only logically,
like malloc's lazy mapping); the first toucher maps each page to its tier
(first-touch policy) and pays the PTE-init cost. Access counters drive the
delayed migration strategy (threshold notifications, §2.2.1 of the paper).

The table is *run-compressed*: tier state, LRU epochs, dirty bits and GPU
access counters are each a :class:`repro_torch.core.runs.RunMap` — sorted
``(start, value)`` run boundaries — so every operation costs O(runs
overlapping the extent), never O(pages in extent), and metadata memory is
O(fragmentation), not O(allocation size). A 16 GiB allocation at 4 KB pages
(4M+ PTEs) whose residency is a handful of uniform extents carries a few
hundred bytes of metadata and mutates in microseconds. Per-tier residency
is tracked with O(1) cached byte/page counters (updated incrementally by
every mutation), and ``tier_runs`` exposes the interval view directly —
it *is* the primary structure, not a derived one. The dense per-page
arrays of the previous implementation survive only as materialized
read-only properties (``tier``, ``dirty``, ``last_access_epoch``,
``gpu_counter``) for tests and debugging.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Tuple

import numpy as np

from repro_torch.core.runs import RunMap, union_runs

# tier-indexed counter slots: index = int(tier) + 1
_NTIERS = 3


def node_tier_loc(node: int, tier: "Tier") -> int:
    """Encode a (node, tier) placement as one small int: ``2*node + tier``.

    Host locations are even (0, 2, 4, ...), device locations odd (1, 3, ...),
    UNMAPPED stays -1 — so for ``node == 0`` the encoding *is* the plain
    Tier value, which is what makes the node dimension bit-identical at
    N=1. The int8 RunMap payload bounds the encoding at 63 nodes."""
    t = int(tier)
    assert t >= 0, "cannot place a page at (node, UNMAPPED)"
    return 2 * node + t


def loc_node(loc: int) -> int:
    """Node index of an encoded location (UNMAPPED -> node 0)."""
    return max(0, int(loc)) // 2


def loc_tier(loc: int) -> "Tier":
    """Tier of an encoded location (parity: even = HOST, odd = DEVICE)."""
    loc = int(loc)
    return Tier.UNMAPPED if loc < 0 else Tier(loc & 1)


def coalesce_runs(ids: np.ndarray):
    """Sorted unique integer ids -> maximal consecutive [lo, hi) runs.

    The shared run-coalescing primitive: BFS sparse-access extents and the
    serving pool's per-sequence page runs both reduce scattered page/node id
    sets to a handful of contiguous extents through this."""
    ids = np.asarray(ids, np.int64)
    if len(ids) == 0:
        return []
    splits = np.flatnonzero(np.diff(ids) != 1) + 1
    starts = ids[np.concatenate(([0], splits))]
    ends = ids[np.concatenate((splits - 1, [len(ids) - 1]))] + 1
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


class Tier(IntEnum):
    UNMAPPED = -1
    HOST = 0
    DEVICE = 1


class Actor(IntEnum):
    CPU = 0
    GPU = 1  # "device": the GPU on GH, the TPU core in the adapted model

    @property
    def home_tier(self) -> Tier:
        return Tier.DEVICE if self is Actor.GPU else Tier.HOST


# byte deltas applied to the owner's cached residency totals
ResidencyDelta = Tuple[int, int]  # (host_bytes_delta, device_bytes_delta)


@dataclass
class BlockTable:
    name: str
    nbytes: int
    page_size: int
    # number of (node, tier) locations a page can occupy: a single-node
    # table (the default) has exactly the three classic tier slots, an
    # N-node table has 2N+1 (UNMAPPED + per-node HOST/DEVICE via
    # node_tier_loc). Every counter below is indexed loc+1.
    num_nodes: int = 1

    def __post_init__(self):
        self.num_pages = max(1, -(-self.nbytes // self.page_size))
        # bytes actually covered by the final (possibly partial) page
        self.tail_bytes = self.nbytes - (self.num_pages - 1) * self.page_size
        n = self.num_pages
        self._nlocs = 2 * self.num_nodes + 1
        # run-compressed per-page metadata: O(runs), never O(pages)
        self._tier = RunMap(n, int(Tier.UNMAPPED), np.int8)
        self._epoch = RunMap(n, 0, np.int64)
        self._dirty = RunMap(n, 0, np.int8)
        self._gpu_counter = RunMap(n, 0, np.int64)
        # cached per-location residency: index int(loc)+1 -> pages / bytes
        self._tier_pages = np.zeros(self._nlocs, np.int64)
        self._tier_bytes = np.zeros(self._nlocs, np.int64)
        self._tier_pages[int(Tier.UNMAPPED) + 1] = n
        self._tier_bytes[int(Tier.UNMAPPED) + 1] = self.nbytes

    # -- ranges -------------------------------------------------------------
    def page_range(self, lo: int, hi: int) -> Tuple[int, int]:
        """[lo, hi) byte range -> [first_page, last_page) page range."""
        assert 0 <= lo <= hi <= self.nbytes, (lo, hi, self.nbytes)
        if lo == hi:
            return (0, 0)
        return lo // self.page_size, -(-hi // self.page_size)

    def page_bytes(self, idx: np.ndarray) -> np.ndarray:
        """Actual bytes covered by each page index (last page may be partial)."""
        full = np.full(len(idx), self.page_size, np.int64)
        full[idx == self.num_pages - 1] = self.tail_bytes
        return full

    def page_bytes_slice(self, p0: int, p1: int) -> np.ndarray:
        """page_bytes for the contiguous extent [p0, p1) without an index array."""
        full = np.full(max(0, p1 - p0), self.page_size, np.int64)
        if p1 == self.num_pages and p1 > p0:
            full[-1] = self.tail_bytes
        return full

    def range_bytes(self, p0: int, p1: int) -> int:
        """O(1) bytes covered by the page extent [p0, p1)."""
        if p1 <= p0:
            return 0
        n = (p1 - p0) * self.page_size
        if p1 == self.num_pages:
            n += self.tail_bytes - self.page_size
        return n

    def span_bytes(self, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """Vectorized range_bytes over disjoint ascending [s, e) runs."""
        b = (ends - starts) * self.page_size
        if len(b) and ends[-1] == self.num_pages:
            b[-1] += self.tail_bytes - self.page_size
        return b

    def clipped_extent_bytes(self, p0: int, p1: int, lo: int, hi: int) -> int:
        """Bytes of the page span [p0, p1) clipped to the kernel byte range
        [lo, hi) — the single boundary-page clip primitive of the charge
        model (hoisted out of kernel()'s duplicated head/tail math).

        Matches the historical dense per-page accounting bit-for-bit,
        including its quirk: when the span ends at the table's final
        *partial* page, the tail clip subtracts the full-page overhang
        ``p1*page_size - hi`` from a page that only holds ``tail_bytes``,
        under-counting by ``page_size - tail_bytes`` (and possibly going
        negative). The golden parity fixture pins this behavior; fixing it
        is a deliberate charge-model change, not a refactor."""
        b = self.range_bytes(p0, p1)
        b -= max(0, lo - p0 * self.page_size)
        b -= max(0, p1 * self.page_size - hi)
        return b

    # -- views --------------------------------------------------------------
    def resident_bytes(self, tier: Tier) -> int:
        return int(self._tier_bytes[int(tier) + 1])

    def resident_pages(self, tier: Tier) -> int:
        return int(self._tier_pages[int(tier) + 1])

    def residency_by_side(self) -> Tuple[int, int]:
        """(host_bytes, device_bytes) summed across nodes — the location
        encoding puts every host slot at an odd counter index and every
        device slot at an even one (index = loc + 1), so the sums reduce
        to the classic two-tier totals for a single-node table."""
        return (int(self._tier_bytes[1::2].sum()),
                int(self._tier_bytes[2::2].sum()))

    def mapped_fraction(self) -> float:
        unmapped = self._tier_pages[int(Tier.UNMAPPED) + 1]
        return float(1.0 - unmapped / self.num_pages)

    def pages_in(self, tier: Tier) -> np.ndarray:
        """Materialized page indices in `tier` (O(matching pages) — tests)."""
        s, e = self.runs_of(tier)
        if len(s) == 0:
            return np.empty(0, np.int64)
        return np.concatenate([np.arange(a, b) for a, b in zip(s, e)])

    def tier_runs(self, p0: int = 0, p1: int = -1):
        """Run-length view of the tier map over [p0, p1).

        Returns (starts, ends, tiers): maximal extents of constant tier —
        the primary interval representation of the page table. The tiers
        array is a read-only view: mutating tier state through it would
        bypass the cached residency counters."""
        if p1 < 0:
            p1 = self.num_pages
        s, e, v = self._tier.runs(p0, p1)
        v = v.view()
        v.setflags(write=False)
        return s, e, v

    def runs_of(self, tier: Tier, p0: int = 0, p1: int = -1):
        """(starts, ends) of the sub-runs holding `tier` within [p0, p1)."""
        if p1 < 0:
            p1 = self.num_pages
        s, e, v = self._tier.runs(p0, p1)
        m = v == int(tier)
        return s[m], e[m]

    def unmapped_stats(self, p0: int, p1: int) -> Tuple[int, int]:
        """(pages, bytes) still unmapped within [p0, p1)."""
        s, e = self.runs_of(Tier.UNMAPPED, p0, p1)
        if len(s) == 0:
            return 0, 0
        return int((e - s).sum()), int(self.span_bytes(s, e).sum())

    def epoch_runs(self, p0: int, p1: int):
        """(starts, ends, epochs) of the LRU-epoch runs within [p0, p1)."""
        return self._epoch.runs(p0, p1)

    def bump_counter(self, p0: int, p1: int, txn: int):
        """Add `txn` to the GPU access counter over every page of [p0, p1).
        Returns the (starts, ends, before) pieces so the caller can apply
        threshold-crossing logic against the pre-bump values."""
        cs, ce, cv = self._gpu_counter.runs(p0, p1)
        self._gpu_counter.splice(p0, p1, cs, cv + txn)
        return cs, ce, cv

    def dirty_bytes(self, starts, ends) -> int:
        """Bytes of the dirty pages inside the given [s, e) spans."""
        nbytes = 0
        for s0, e0 in zip(starts, ends):
            ds, de = self._dirty.nonzero_runs(int(s0), int(e0))
            if len(ds):
                nbytes += int(self.span_bytes(ds, de).sum())
        return nbytes

    def clear_dirty(self, starts, ends) -> None:
        """Drop the dirty bit over the given [s, e) spans (writeback done)."""
        for s0, e0 in zip(starts, ends):
            self._dirty.set_range(int(s0), int(e0), 0)

    def recount(self) -> Tuple[np.ndarray, np.ndarray]:
        """Recompute per-tier (pages, bytes) from the run structure — the
        slow-path reference the cached counters are tested against."""
        s, e, v = self._tier.runs()
        idx = v.astype(np.int64) + 1
        pages = np.bincount(idx, weights=(e - s),
                            minlength=self._nlocs).astype(np.int64)
        nbytes = np.bincount(idx, weights=self.span_bytes(s, e),
                             minlength=self._nlocs).astype(np.int64)
        return pages, nbytes

    def metadata_nbytes(self) -> int:
        """Bytes of run-compressed metadata — O(fragmentation), not O(pages)."""
        return sum(m.bytes_used() for m in
                   (self._tier, self._epoch, self._dirty, self._gpu_counter))

    # -- dense materializations (tests/debug only: O(num_pages)) -------------
    @property
    def tier(self) -> np.ndarray:
        return self._tier.to_dense()

    @property
    def last_access_epoch(self) -> np.ndarray:
        return self._epoch.to_dense()

    @property
    def dirty(self) -> np.ndarray:
        return self._dirty.to_dense().astype(bool)

    @property
    def gpu_counter(self) -> np.ndarray:
        return self._gpu_counter.to_dense()

    # -- mutations (called by UnifiedMemory) ---------------------------------
    def _shift_counters(self, pages_out: np.ndarray, bytes_out: np.ndarray,
                        new_tier: Tier) -> ResidencyDelta:
        """Move cached counters for pages leaving per-tier `..._out` slots."""
        k = int(new_tier) + 1
        tot_p, tot_b = int(pages_out.sum()), int(bytes_out.sum())
        self._tier_pages -= pages_out
        self._tier_bytes -= bytes_out
        self._tier_pages[k] += tot_p
        self._tier_bytes[k] += tot_b
        # side deltas by counter-index parity: host slots odd, device even
        dh = (tot_b if k % 2 == 1 else 0) - int(bytes_out[1::2].sum())
        dd = (tot_b if k % 2 == 0 and k != 0 else 0) - int(bytes_out[2::2].sum())
        return dh, dd

    def touch_range(self, p0: int, p1: int, epoch: int, write: bool) -> None:
        """Record an access over [p0, p1): LRU epoch + dirty on writes."""
        if p1 <= p0:
            return
        self._epoch.set_range(p0, p1, epoch)
        if write:
            self._dirty.set_range(p0, p1, 1)

    def touch_batch(self, starts, ends, epochs, writes) -> None:
        """touch_range for a whole batch of extents in one pass.

        Per page the recorded epoch is the max over covering extents; since
        the caller hands epochs that are positive and nondecreasing in
        submission order, max == the last writer, matching N sequential
        touch_range calls. Dirty is set over the union of write extents.
        Cost is O(batch·log batch + runs touched), never O(pages)."""
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        epochs = np.asarray(epochs, np.int64)
        writes = np.asarray(writes, bool)
        m = ends > starts
        if not m.all():
            starts, ends, epochs, writes = (starts[m], ends[m],
                                            epochs[m], writes[m])
        if len(starts) == 0:
            return
        # segment sweep: breakpoints split [min, max) into atomic segments;
        # scatter each extent's epoch into its segment span with maximum.at
        bp = np.unique(np.concatenate((starts, ends)))
        segmax = np.zeros(len(bp) - 1, np.int64)
        i0 = np.searchsorted(bp, starts)
        cnt = np.searchsorted(bp, ends) - i0
        seg = (np.repeat(i0, cnt)
               + np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        np.maximum.at(segmax, seg, np.repeat(epochs, cnt))
        for a, b in coalesce_runs(np.flatnonzero(segmax > 0)):
            self._epoch.splice(int(bp[a]), int(bp[b]), bp[a:b], segmax[a:b])
        if writes.any():
            ws, we = starts[writes], ends[writes]
            order = np.argsort(ws, kind="stable")
            for s0, e0 in zip(*union_runs(ws[order], we[order])):
                self._dirty.set_range(int(s0), int(e0), 1)

    def map_unmapped(self, p0: int, p1: int, tier: Tier) -> ResidencyDelta:
        """First-touch: map every unmapped page of [p0, p1) into `tier`."""
        s, e = self.runs_of(Tier.UNMAPPED, p0, p1)
        if len(s) == 0:
            return 0, 0
        npages = int((e - s).sum())
        nbytes = int(self.span_bytes(s, e).sum())
        for a, b in zip(s, e):
            self._tier.set_range(int(a), int(b), int(tier))
        self._tier_pages[int(Tier.UNMAPPED) + 1] -= npages
        self._tier_bytes[int(Tier.UNMAPPED) + 1] -= nbytes
        self._tier_pages[int(tier) + 1] += npages
        self._tier_bytes[int(tier) + 1] += nbytes
        if int(tier) % 2 == 0:  # even locations are host-side
            return nbytes, 0
        return 0, nbytes

    def move_runs(self, starts, ends, tier: Tier) -> ResidencyDelta:
        """Retier the mapped pages of disjoint ascending [s, e) spans;
        resets their access counters (migration semantics)."""
        pages_out = np.zeros(self._nlocs, np.int64)
        bytes_out = np.zeros(self._nlocs, np.float64)
        for a, b in zip(starts, ends):
            a, b = int(a), int(b)
            s, e, v = self._tier.runs(a, b)
            assert (v != int(Tier.UNMAPPED)).all(), "move of unmapped page"
            idx = v.astype(np.int64) + 1
            pages_out += np.bincount(idx, weights=(e - s),
                                     minlength=self._nlocs).astype(np.int64)
            bytes_out += np.bincount(idx, weights=self.span_bytes(s, e),
                                     minlength=self._nlocs)
            self._tier.set_range(a, b, int(tier))
            self._gpu_counter.set_range(a, b, 0)
        return self._shift_counters(pages_out, bytes_out.astype(np.int64), tier)

    def move_extent(self, p0: int, p1: int, tier: Tier) -> ResidencyDelta:
        """move_runs for one contiguous extent [p0, p1)."""
        return self.move_runs((p0,), (p1,), tier)

    # -- compat wrappers over scattered page-index arrays (tests) ------------
    def map_mask(self, p0: int, p1: int, mask: np.ndarray,
                 tier: Tier) -> ResidencyDelta:
        """Map the masked (unmapped) pages of extent [p0, p1) into `tier`."""
        return self.map_pages(p0 + np.flatnonzero(np.asarray(mask, bool)), tier)

    def map_pages(self, pages: np.ndarray, tier: Tier) -> ResidencyDelta:
        dh = dd = 0
        for a, b in coalesce_runs(np.unique(np.asarray(pages, np.int64))):
            _, _, v = self._tier.runs(a, b)
            assert (v == int(Tier.UNMAPPED)).all(), "double map"
            h, d = self.map_unmapped(a, b, tier)
            dh += h
            dd += d
        return dh, dd

    def move_pages(self, pages: np.ndarray, tier: Tier) -> ResidencyDelta:
        """Retier mapped pages. `pages` MUST be unique indices (duplicates
        would double-count the cached residency deltas)."""
        runs = coalesce_runs(np.unique(np.asarray(pages, np.int64)))
        return self.move_runs([r[0] for r in runs], [r[1] for r in runs], tier)
