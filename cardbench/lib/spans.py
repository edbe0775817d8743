"""The program's own host-clock spans (``repro_torch.spans``), read over
the run's quiet window (``RunView.quiet``: the untraced part of the
window, where the host's clock is undistorted by the profiler).

A span's self time is its duration less what its direct child spans
cover. Each reader gets None where there is nothing sound to read: a
program that records no spans, or a ring that had already overwritten
spans that started inside the window.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

STEP = "serve.step"


def window(run) -> Optional[list]:
    """The spans that started in the quiet window and have ended, in the
    order they opened, or None."""
    try:
        from repro_torch.spans import SPANS
    except ImportError:
        return None
    spans, lost = SPANS.read(*run.quiet)
    if lost:
        return None
    spans = [s for s in spans if s.t1_ns >= 0]
    return spans or None


def total_ns(spans, name: str) -> int:
    return sum(s.dur_ns for s in spans if s.name == name)


def children(spans) -> Dict[int, list]:
    """Sequence number -> the spans opened directly inside it."""
    out: Dict[int, list] = defaultdict(list)
    for s in spans:
        out[s.parent].append(s)
    return out


def self_ns(spans, names) -> int:
    """Summed self time of the spans named in ``names``."""
    kids = children(spans)
    return sum(s.dur_ns - sum(c.dur_ns for c in kids.get(s.seq, ()))
               for s in spans if s.name in names)


def step_share_pct(run, part) -> Optional[float]:
    """``part(spans)`` (ns) over the summed duration of the engine's steps,
    in percent."""
    spans = window(run)
    if spans is None:
        return None
    steps = total_ns(spans, STEP)
    return 100.0 * part(spans) / steps if steps > 0 else None


def decode_issue_ms(spans) -> List[float]:
    """For each decode batch, the host's time from the start of
    ``serve.decode`` to the start of its ``serve.sync`` (the copy of the
    sampled tokens, which waits on the device): the time to issue it."""
    kids = children(spans)
    out = []
    for s in spans:
        if s.name == "serve.decode":
            sync = [c for c in kids.get(s.seq, ()) if c.name == "serve.sync"]
            if sync:
                out.append((sync[0].t0_ns - s.t0_ns) / 1e6)
    return out
