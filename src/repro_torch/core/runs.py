"""Run-compressed interval maps: the metadata backbone of the page table.

A :class:`RunMap` stores one value per page index in ``[0, n)`` as maximal
constant *runs*: a sorted ``starts`` array (``starts[0] == 0``) plus one
value per run, with the invariant that adjacent runs always hold different
values. Every range operation — query, assignment, increment — costs
O(runs touched + log runs), never O(pages), so a 16M-page allocation whose
tier map is a single uniform run is exactly as cheap as a 16-page one.

The page table keeps tier state, LRU epochs, dirty bits, access counters
and notification-pending state in RunMaps; dense per-page arrays are only
ever *materialized* on demand (``to_dense``) for tests and debugging.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["RunMap", "union_runs"]

_EMPTY = np.empty(0, np.int64)


class RunMap:
    """A value per page in [0, n), run-length compressed.

    Invariants (checked by :meth:`check`): ``starts`` is strictly
    increasing int64 with ``starts[0] == 0``; ``vals`` has one entry per
    run; adjacent runs differ (the map is always maximally coalesced).
    """

    __slots__ = ("n", "starts", "vals")

    def __init__(self, n: int, fill=0, dtype=np.int64):
        self.n = int(n)
        self.starts = np.zeros(1, np.int64)
        self.vals = np.full(1, fill, dtype)

    @classmethod
    def from_dense(cls, arr: np.ndarray) -> "RunMap":
        arr = np.asarray(arr)
        m = cls(len(arr), 0, arr.dtype)
        breaks = np.flatnonzero(np.diff(arr)) + 1
        m.starts = np.concatenate(([0], breaks)).astype(np.int64)
        m.vals = arr[m.starts]
        return m

    # ----------------------------------------------------------------- views
    @property
    def num_runs(self) -> int:
        return len(self.starts)

    def runs(self, p0: int = 0, p1: Optional[int] = None):
        """Clipped run view of [p0, p1): (starts, ends, vals).

        ``starts``/``ends`` are fresh int64 arrays; ``vals`` is a read-only
        slice of the underlying value array (copy before mutating)."""
        if p1 is None:
            p1 = self.n
        if p1 <= p0:
            return _EMPTY, _EMPTY, self.vals[:0]
        st = self.starts
        i = int(np.searchsorted(st, p0, "right")) - 1
        j = int(np.searchsorted(st, p1, "left"))
        s = st[i:j].copy()
        s[0] = p0
        e = np.empty(j - i, np.int64)
        e[:-1] = st[i + 1:j]
        e[-1] = p1
        return s, e, self.vals[i:j]

    def value_at(self, p: int):
        i = int(np.searchsorted(self.starts, p, "right")) - 1
        return self.vals[i]

    def any(self) -> bool:
        """True if any page holds a nonzero value (bool-map convenience)."""
        return bool(self.vals.any())

    def nonzero_runs(self, p0: int = 0, p1: Optional[int] = None):
        """(starts, ends) of the sub-runs with a nonzero value in [p0, p1)."""
        s, e, v = self.runs(p0, p1)
        m = v != 0
        return s[m], e[m]

    def count_nonzero(self, p0: int = 0, p1: Optional[int] = None) -> int:
        """Number of pages with a nonzero value in [p0, p1)."""
        s, e = self.nonzero_runs(p0, p1)
        return int((e - s).sum())

    def to_dense(self) -> np.ndarray:
        """Materialize the dense per-page array (O(n) — tests/debug only)."""
        lengths = np.diff(np.append(self.starts, self.n))
        return np.repeat(self.vals, lengths)

    def bytes_used(self) -> int:
        """Metadata footprint: O(runs), independent of n."""
        return self.starts.nbytes + self.vals.nbytes

    def check(self) -> None:
        assert self.starts[0] == 0 and len(self.starts) == len(self.vals)
        assert (np.diff(self.starts) > 0).all(), "starts not increasing"
        assert self.starts[-1] < self.n, "run beyond the map"
        if len(self.vals) > 1:
            assert (self.vals[1:] != self.vals[:-1]).all(), "uncoalesced runs"

    # ------------------------------------------------------------- mutations
    def splice(self, p0: int, p1: int, new_starts, new_vals) -> None:
        """Replace [p0, p1) with the given runs (new_starts[0] must be p0);
        re-coalesces at the seams."""
        if p1 <= p0:
            return
        st, vl = self.starts, self.vals
        i = int(np.searchsorted(st, p0, "right")) - 1
        j = int(np.searchsorted(st, p1, "left"))
        # runs fully before p0, plus the clipped head of run i if it
        # begins before p0
        hk = i + 1 if st[i] < p0 else i
        if p1 >= self.n:
            tail_s, tail_v = st[:0], vl[:0]
        elif j < len(st) and st[j] == p1:
            tail_s, tail_v = st[j:], vl[j:]
        else:  # run j-1 spans across p1: it resumes at p1
            tail_s = np.concatenate(([p1], st[j:]))
            tail_v = np.concatenate((vl[j - 1:j], vl[j:]))
        starts = np.concatenate((st[:hk], new_starts, tail_s))
        vals = np.concatenate((vl[:hk], np.asarray(new_vals, vl.dtype), tail_v))
        if len(vals) > 1:
            keep = np.empty(len(vals), bool)
            keep[0] = True
            np.not_equal(vals[1:], vals[:-1], out=keep[1:])
            if not keep.all():
                starts, vals = starts[keep], vals[keep]
        self.starts, self.vals = starts, vals

    def set_range(self, p0: int, p1: int, val) -> None:
        if p1 <= p0:
            return
        self.splice(p0, p1, np.array([p0], np.int64),
                    np.array([val], self.vals.dtype))

    def add_range(self, p0: int, p1: int, delta) -> None:
        s, _, v = self.runs(p0, p1)
        if len(s):
            self.splice(p0, p1, s, v + delta)

    def clear(self) -> None:
        """Reset every page to 0."""
        self.starts = np.zeros(1, np.int64)
        self.vals = np.zeros(1, self.vals.dtype)


def union_runs(s, e):
    """Merge overlapping/adjacent intervals (sorted by start) into a
    disjoint sorted interval list."""
    if len(s) <= 1:
        return s, e
    cme = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > cme[:-1]
    starts = s[new]
    ends = cme[np.append(np.flatnonzero(new)[1:] - 1, len(s) - 1)]
    return starts, ends
