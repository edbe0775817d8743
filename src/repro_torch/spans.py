"""Host-clock spans of the program's layers: one process-wide flight
recorder, always on.

``SPANS.span(name, tag)`` is a context manager that records, in a ring of
``CAPACITY`` preallocated records, the span's interned name, its start and
end on ``time.perf_counter_ns()``, the sequence number of the span open
around it (its parent, or -1) and one integer ``tag``: the count or
identifier at that boundary, which the body may set on the span object
before it exits. ``SPANS.read(t0, t1)`` returns the spans that started in
[t0, t1) (``time.perf_counter()`` seconds) and whether the ring had
already overwritten a span that started at or after ``t0``.

With no profiler running a span costs two clock reads, one check of the
profiler's state and a few list stores: about two microseconds of host
time in CPython (1.7-2.4 us on the host of an NVIDIA H100 80GB HBM3
machine). While ``torch.profiler`` runs, a span also enters
``record_function(name)`` and leaves it on exit, exceptions included, so
it shows in the trace on the trace's own clock; ``trace_offset_ns`` puts
a ring record on that clock (Unix time, ``time.time_ns()``).

Spans nest by the order they open and close: the recorder is meant for
one thread of the program at a time.
"""
from __future__ import annotations

import time

import torch

CAPACITY = 1 << 17

_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class Span:
    """One recorded span: ``seq`` (its sequence number), ``name``,
    ``t0_ns``, ``t1_ns`` (-1 while open), ``parent`` (sequence number of
    the enclosing span, or -1) and ``tag``."""

    __slots__ = ("seq", "name", "t0_ns", "t1_ns", "parent", "tag")

    def __init__(self, seq, name, t0_ns, t1_ns, parent, tag):
        self.seq, self.name = seq, name
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.parent, self.tag = parent, tag

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns


class _Open:
    """The context manager of one span (``Recorder.span``)."""

    __slots__ = ("rec", "name", "tag", "seq", "rf")

    def __init__(self, rec, name: str, tag: int):
        self.rec, self.name, self.tag = rec, name, tag
        self.rf = None

    def __enter__(self):
        rec = self.rec
        i = rec.count
        rec.count = i + 1
        j = i & rec.mask
        self.seq = i
        rec.seq[j] = i
        rec.name_id[j] = rec.intern(self.name)
        rec.parent[j] = rec.stack[-1] if rec.stack else -1
        rec.t1[j] = -1
        rec.stack.append(i)
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        rec.t0[j] = _clock()
        return self

    def __exit__(self, *exc):
        t = _clock()
        rec, i = self.rec, self.seq
        if self.rf is not None:
            self.rf.__exit__(*exc)
        j = i & rec.mask
        if rec.seq[j] == i:  # not overwritten while open
            rec.t1[j] = t
            rec.tag[j] = self.tag
        stack = rec.stack
        while stack and stack.pop() != i:
            pass
        return False


class Recorder:
    """A ring of ``capacity`` (a power of two) span records."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two: {capacity}")
        self.capacity, self.mask = capacity, capacity - 1
        self.seq = [-1] * capacity
        self.name_id = [0] * capacity
        self.t0 = [0] * capacity
        self.t1 = [-1] * capacity
        self.parent = [-1] * capacity
        self.tag = [-1] * capacity
        self.count = 0           # spans opened so far
        self.stack = []          # sequence numbers of the open spans
        self.names = []          # id -> name
        self._ids = {}           # name -> id
        self.trace_offset_ns = time.time_ns() - _clock()

    def intern(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    def span(self, name: str, tag: int = -1) -> _Open:
        return _Open(self, name, tag)

    def read(self, t0: float, t1: float):
        """(spans that started in [t0, t1) in the order they opened, whether
        the ring had overwritten a span that started at or after t0);
        ``t0``, ``t1`` in ``time.perf_counter()`` seconds."""
        lo_ns, hi_ns = int(t0 * 1e9), int(t1 * 1e9)
        first = max(0, self.count - self.capacity)
        mask, start = self.mask, self.t0
        # every overwritten span started no later than the oldest kept one
        lost = first > 0 and start[first & mask] >= lo_ns

        def bound(t):  # first kept span that started at or after t
            a, b = first, self.count
            while a < b:  # starts grow with the sequence number
                m = (a + b) // 2
                if start[m & mask] < t:
                    a = m + 1
                else:
                    b = m
            return a

        out = []
        for i in range(bound(lo_ns), bound(hi_ns)):
            j = i & mask
            out.append(Span(i, self.names[self.name_id[j]], start[j],
                            self.t1[j], self.parent[j], self.tag[j]))
        return out, lost


SPANS = Recorder()
