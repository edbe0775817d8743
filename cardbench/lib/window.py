"""Window arithmetic the metric readers share."""
from __future__ import annotations

from typing import List

from cardbench.lib.h100 import HBM_BYTES_PER_S


def window_steps(run) -> list:
    """The steps that ran inside the window: it opens between steps, and
    its last step is the last one that started before its close."""
    return [s for s in run.sess.steps
            if run.sess.t_open <= s.t0 < run.sess.t_close]


def quiet_steps(run) -> list:
    """The window's steps that ran with no tracing (``RunView.quiet``)."""
    t0, t1 = run.quiet
    return [s for s in window_steps(run) if s.t1 <= t1]


def tokens_in_window(run) -> tuple:
    """(prompt tokens prefilled, tokens generated) inside the window."""
    prefill = sum(b - a for s in window_steps(run) for _, a, b in s.chunks)
    t0, t1 = run.sess.t_open, run.sess.t_end
    gen = sum(1 for q in run.sess.reqs.values() for t in q.tokens
              if t0 < t <= t1)
    return prefill, gen


def ttfts_ms(run) -> List[float]:
    """Due to first token of every request due inside the window; one with
    no token by the window's end counts as (end - due)."""
    end = run.sess.t_end
    out = []
    for q in run.sess.due_in_window():
        first = q.tokens[0] if q.tokens and q.tokens[0] <= end else end
        out.append((first - q.due) * 1e3)
    return out


def queue_waits_ms(run) -> List[float]:
    """Due time to the start of the step that admitted it, of every request
    due inside the untraced part of the window; one not admitted by the
    window's end counts as (end - due)."""
    t1, end = run.quiet[1], run.sess.t_end
    return [((q.admit_t0 if q.admit_t0 is not None else end) - q.due) * 1e3
            for q in run.sess.due_in_window() if q.due < t1]


def itls_ms(run) -> List[float]:
    """Every gap between consecutive tokens of one request, both inside
    the window."""
    t0, t1 = run.sess.t_open, run.sess.t_end
    out = []
    for q in run.sess.reqs.values():
        ts = [t for t in q.tokens if t0 <= t <= t1]
        out.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
    return out


def step_flops(run, s) -> float:
    """Model FLOPs of one step (the counts of the configuration's model
    module)."""
    cfg, m = run.cfg, run.model
    f = 0.0
    for rid, a, b in s.chunks:
        f += m.span_flops(cfg, a, b)
        if b == len(run.sess.reqs[rid].prompt):
            f += m.head_flops(cfg)
    for n in s.decode_len:
        f += m.token_flops(cfg, n - 1) + m.head_flops(cfg)
    return f


def paged_bound_s(run, steps) -> float:
    """Byte-bound seconds of every paged-attention call of ``steps``: one a
    layer a decode batch (the model module's ``paged_bytes`` a pass)."""
    return sum(run.model.paged_bytes(run.cfg, s.decode_len)
               for s in steps if s.decode) / HBM_BYTES_PER_S


def traced(run, stretch: str):
    """Stretch ``a`` or ``b`` of a traced run, or None."""
    t = run.trace
    return None if t is None else getattr(t, stretch)


def idle_share_pct(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def step_host_share_pct(run):
    t = traced(run, "a")
    if t is None or t.busy_s <= 0:
        return None
    wall = sum(s.t1 - s.t0 for s in run.steps_of(t))
    return 100.0 * (1.0 - t.busy_s / wall) if wall > 0 else None


def range_share_pct(run, name: str):
    """Device time launched inside a benchmark range over device busy
    time, stretch B."""
    t = traced(run, "b")
    if t is None or t.busy_s <= 0 or t.ranges.get(name, 0.0) <= 0:
        return None
    return 100.0 * t.ranges[name] / t.busy_s


def prefill_rate(run):
    t = traced(run, "b")
    if t is None or t.ranges.get("cardbench.prefill", 0.0) <= 0:
        return None
    toks = sum(b - a for s in run.steps_of(t) for _, a, b in s.chunks)
    return toks / t.ranges["cardbench.prefill"] if toks else None
