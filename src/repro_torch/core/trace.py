"""Trace capture/replay for the unified-memory runtime.

Recording hooks the raw runtime surface — the post-resolution stream of
alloc/free/kernel/kernel_batch/sync/copy/prefetch/demote/phase events that
every app and benchmark ultimately lowers onto — and writes one compact
JSONL event per op (gzip when the path ends in ``.gz``). Replay re-drives
the stream through a fresh :class:`~repro_torch.core.umem.UnifiedMemory`, so a
recorded application can be re-charged under any registered policy or
hardware backend *without re-running the application math* (the Khalilov
et al. trace-replay methodology): the modeled clock, phase times and
traffic counters come out of ``um.prof`` exactly as a live run's would.

Identity guarantees:

* ``replay(path)`` with no overrides reproduces the recorded run's charges
  bit-for-bit: the stream is recorded after buffer-view resolution, and
  every charge in the runtime is a pure function of (hardware, policy,
  op stream).
* ``replay(path, policy=...)`` rebuilds every application allocation under
  the named backend (harness-reserved ``__``-prefixed allocations keep
  their recorded policy) and matches a native run of the same app under
  that backend whenever the app's op stream is policy-independent — true
  for all directly-CPU-accessible backends (system/managed/mi300a_unified),
  which share one resolution path and skip ``um.staged()`` copies alike.

Recording starts at attach time: allocations already live when the
recorder attaches are re-emitted as alloc events (their tables must still
be untouched — ``record_app`` attaches inside ``make_um``, before the app
touches anything, so only the pristine oversubscription ballast predates
the stream).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.core.pagetable import Actor
from repro_torch.core.policy import Allocation
from repro_torch.core.registry import get_hardware, make_policy
from repro_torch.core.umem import UnifiedMemory

# v2 adds the optional per-kernel node pin ("nd" on kernel events, a sixth
# element on batch items) for node-aware cluster backends; single-node
# streams serialize identically to v1 apart from the header version, and
# replay accepts both versions (missing node info defaults to node 0).
TRACE_VERSION = 2


def _open_w(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "wt", encoding="utf-8")
    return open(path, "w", encoding="utf-8")


def _open_r(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


class TraceRecorder:
    """Serializes runtime events; installed as ``um._trace`` by attach()."""

    def __init__(self, path, header: Dict[str, object]):
        self._f = _open_w(path)
        self._um: Optional[UnifiedMemory] = None
        self._write(dict({"t": "hdr", "v": TRACE_VERSION}, **header))

    def _write(self, ev: Dict[str, object]) -> None:
        self._f.write(json.dumps(ev, separators=(",", ":")) + "\n")

    @staticmethod
    def _ranges(ranges: Sequence) -> List[List]:
        return [[a.name, int(lo), int(hi)] for a, lo, hi in ranges]

    # ------------------------------------------------------- event callbacks
    def on_alloc(self, a: Allocation) -> None:
        self._write({"t": "a", "n": a.name, "b": int(a.nbytes),
                     "p": a.policy.kind, "c": dataclasses.asdict(a.policy)})

    def on_free(self, name: str) -> None:
        self._write({"t": "f", "n": name})

    def on_kernel(self, name, reads, writes, flops, actor, node=0) -> None:
        ev = {"t": "k", "n": name, "r": self._ranges(reads),
              "w": self._ranges(writes), "fl": float(flops),
              "ac": int(actor)}
        if node:
            ev["nd"] = int(node)
        self._write(ev)

    def on_batch(self, items: Sequence) -> None:
        self._write({"t": "kb", "it": [
            [nm, self._ranges(r), self._ranges(w), float(fl), int(ac)]
            if not nd else
            [nm, self._ranges(r), self._ranges(w), float(fl), int(ac),
             int(nd)]
            for nm, r, w, fl, ac, nd in items]})

    def on_sync(self) -> None:
        self._write({"t": "s"})

    def on_copy(self, name, lo, hi, direction) -> None:
        self._write({"t": "c", "n": name, "lo": int(lo), "hi": int(hi),
                     "d": direction})

    def on_prefetch(self, name, lo, hi, overlap) -> None:
        self._write({"t": "pf", "n": name, "lo": int(lo), "hi": int(hi),
                     "ov": bool(overlap)})

    def on_demote(self, name, lo, hi) -> None:
        self._write({"t": "dm", "n": name, "lo": int(lo), "hi": int(hi)})

    def on_phase(self, name: str) -> None:
        self._write({"t": "ph", "n": name})

    def close(self) -> None:
        if self._um is not None and self._um._trace is self:
            self._um._trace = None
        self._um = None
        self._f.close()


def attach(um: UnifiedMemory, path, **meta) -> TraceRecorder:
    """Start recording ``um``'s stream to ``path``. Pre-existing live
    allocations are re-emitted as alloc events so replay rebuilds them
    (they must not have been touched yet). Call ``close()`` (or use the
    :func:`record` context manager) to detach and flush."""
    assert um._trace is None, "a recorder is already attached"
    rec = TraceRecorder(path, {"hw": um.hw.name,
                               "sps": um.staging_page_size, **meta})
    for a in um.allocs.values():
        if not a.freed:
            rec.on_alloc(a)
    rec._um = um
    um._trace = rec
    return rec


@contextlib.contextmanager
def record(um: UnifiedMemory, path, **meta):
    """Record every runtime op issued inside the block to ``path``."""
    rec = attach(um, path, **meta)
    try:
        yield rec
    finally:
        rec.close()


def record_app(app: str, policy_kind: str, path, **kw):
    """Run the registered app under ``policy_kind`` with the runtime stream
    recorded to ``path``. Returns the app's AppResult; the trace replays to
    the same charges via :func:`replay`."""
    from repro_torch.apps import APPS
    from repro_torch.apps.common import add_um_hook, remove_um_hook

    recs: List[TraceRecorder] = []

    def hook(um):
        if not recs:  # first (and, for every current app, only) runtime
            recs.append(attach(um, path, app=app, policy=policy_kind))

    add_um_hook(hook)
    try:
        result = APPS[app].run(policy_kind, **kw)
    finally:
        remove_um_hook(hook)
        for rec in recs:
            rec.close()
    assert recs, f"app {app!r} never built a UnifiedMemory"
    return result


def _rebuild_policy(ev: Dict[str, object], override: Optional[str]):
    """The recorded policy (kind + full config), or the override backend
    built at the recorded paging/migration knobs. Harness-reserved ``__``
    allocations (e.g. the oversubscription ballast) always keep their
    recorded policy — the override targets application memory only."""
    cfg = dict(ev["c"])
    if override is None or str(ev["n"]).startswith("__"):
        return dataclasses.replace(make_policy(str(ev["p"])), **cfg)
    return make_policy(
        override,
        page_size=cfg["page_size"],
        threshold=cfg["counter_threshold"],
        auto_migrate=cfg["auto_migrate"],
        speculative_prefetch=cfg["speculative_prefetch"],
        max_migration_bytes_per_sync=cfg["max_migration_bytes_per_sync"])


def replay(path, *, policy: Optional[str] = None,
           hw=None) -> UnifiedMemory:
    """Re-drive a recorded stream through a fresh runtime.

    ``policy`` swaps every application allocation onto the named registered
    backend (built at the recorded page-size/threshold/migration knobs);
    ``hw`` swaps the hardware model (name or HardwareModel; default: the
    recorded one). Returns the replayed UnifiedMemory — ``um.prof`` holds
    the modeled phase times, traffic and timeline, and ``um.report()``
    the full report."""
    with _open_r(path) as f:
        events = (json.loads(line) for line in f if line.strip())
        hdr = next(events)
        assert hdr.get("t") == "hdr", "not a trace file (missing header)"
        assert hdr.get("v") in (1, TRACE_VERSION), \
            f"trace version {hdr.get('v')} not in (1, {TRACE_VERSION})"
        um = UnifiedMemory(
            hw=get_hardware(hw if hw is not None else hdr.get("hw")),
            staging_page_size=int(hdr.get("sps", 64 * 1024)))
        allocs: Dict[str, Allocation] = {}

        def rz(ranges):
            return [(allocs[n], lo, hi) for n, lo, hi in ranges]

        for ev in events:
            et = ev["t"]
            if et == "k":
                um.kernel(reads=rz(ev["r"]), writes=rz(ev["w"]),
                          flops=ev["fl"], actor=Actor(ev["ac"]),
                          name=ev["n"], node=int(ev.get("nd", 0)))
            elif et == "kb":
                um.kernel_batch([
                    (it[0], rz(it[1]), rz(it[2]), it[3], Actor(it[4]),
                     int(it[5]) if len(it) > 5 else 0)
                    for it in ev["it"]])
            elif et == "s":
                um.sync()
            elif et == "a":
                allocs[ev["n"]] = um.alloc(ev["n"], int(ev["b"]),
                                           _rebuild_policy(ev, policy))
            elif et == "f":
                um.free(allocs[ev["n"]])
            elif et == "c":
                um.copy(allocs[ev["n"]], ev["lo"], ev["hi"], ev["d"])
            elif et == "pf":
                um.prefetch(allocs[ev["n"]], ev["lo"], ev["hi"],
                            overlap=ev["ov"])
            elif et == "dm":
                um.demote(allocs[ev["n"]], ev["lo"], ev["hi"])
            elif et == "ph":
                um.prof.set_phase(ev["n"])
            else:
                raise ValueError(f"unknown trace event type {et!r}")
    return um
