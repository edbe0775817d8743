"""The traced run: ``torch.profiler`` over two stretches of whole steps,
and their reduction.

Stretch A opens with the window and traces the device alone (CUDA
activity, no host events), whose overhead on the host is small: the
device's busy time, its idle share, kernel time by name. Stretch B follows
the window, while the load goes on, and traces host and device with the
benchmark's ranges: forward hooks (public ``nn.Module`` hooks, installed
only for it) open a ``record_function`` range around every ffn call
(``cardbench.ffn``) and around every pass of the model
(``cardbench.prefill`` or ``cardbench.decode``, by the pass's shape), and
the harness wraps each ``step()`` in ``cardbench.step``. A device
operation belongs to a range when the host call that launched it (its
correlation id) ran inside the range. Host tracing slows the host several
times over, so B gives shares of device time (which it does not distort)
and the names of the host activities the device waited on, never a time
on the host's clock. Each stretch starts and stops between two engine
steps, after a ``synchronize``.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

RANGES = ("cardbench.ffn", "cardbench.prefill", "cardbench.decode")


@dataclass
class Stretch:
    window_s: float                      # host clock, start to stop
    busy_s: float                        # union of device activity
    kernels: Dict[str, Tuple[float, int]]  # name -> (seconds, count)
    ranges: Dict[str, float]             # range -> device seconds inside
    idle_by_host: Dict[str, float]       # host activity -> idle seconds
    steps: Tuple[int, int] = (0, 0)      # [first, last) traced step index
    events: int = 0
    notes: List[str] = field(default_factory=list)


@dataclass
class TraceSummary:
    a: Stretch          # the device alone, inside the window
    b: Optional[Stretch]  # host and device with ranges, after the window
    read_s: float = 0.0

    # stretch A's numbers are the run's device numbers
    @property
    def window_s(self) -> float:
        return self.a.window_s

    @property
    def busy_s(self) -> float:
        return self.a.busy_s

    @property
    def kernels(self):
        return self.a.kernels

    @property
    def steps(self):
        return self.a.steps


class _Hooks:
    def __init__(self, model):
        self.handles, self.stack = [], []
        rf = torch.autograd.profiler.record_function

        def open_range(name):
            r = rf(name)
            r.__enter__()
            self.stack.append(r)

        def close_range():
            if self.stack:
                self.stack.pop().__exit__(None, None, None)

        def pass_pre(mod, args):
            x = args[0]
            open_range("cardbench.decode" if x.shape[1] == 1
                       else "cardbench.prefill")

        layers = model.layers
        self.handles.append(layers[0].norm1.register_forward_pre_hook(pass_pre))
        for blk in layers:
            self.handles.append(blk.ffn.register_forward_pre_hook(
                lambda m, a: open_range("cardbench.ffn")))
            self.handles.append(blk.ffn.register_forward_hook(
                lambda m, a, o: close_range()))
        self.handles.append(layers[-1].ffn.register_forward_hook(
            lambda m, a, o: close_range()))

    def remove(self):
        while self.stack:
            self.stack.pop().__exit__(None, None, None)
        for h in self.handles:
            h.remove()


def _profiler(host: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False, acc_events=True)


def prime() -> None:
    """A tiny trace of each kind in set-up, so that the profiler's own first
    start (CUPTI's set-up) does not land in the window."""
    for host in (False, True):
        with _profiler(host):
            torch.ones(8, device="cuda").sum().item()


class Tracer:
    """Stretch A: the window's last ``a_seconds``; stretch B: ``b_seconds``
    from its close. Driven by ``Session.on_step``; ``Session.hold`` keeps
    the load going until B is done."""

    def __init__(self, model, a_seconds: float, b_seconds: float):
        self.model, self.secs = model, {"a": a_seconds, "b": b_seconds}
        self.phase = None       # None, "a", "gap", "b", "done"
        self.prof = {}
        self.hooks = None
        self.t, self.i = {}, {}
        self.summary: Optional[TraceSummary] = None

    def _start(self, name, sess) -> None:
        torch.cuda.synchronize()
        p = _profiler(host=name == "b")
        p.__enter__()
        self.prof[name] = p
        if name == "b":
            self.hooks = _Hooks(self.model)
        self.t[name], self.i[name] = [time.perf_counter()], [len(sess.steps)]
        self.phase = name

    def _stop(self, name, sess) -> None:
        torch.cuda.synchronize()
        self.t[name].append(time.perf_counter())
        self.i[name].append(len(sess.steps))
        if name == "b":
            self.hooks.remove()
        self.prof[name].__exit__(None, None, None)
        self.phase = "gap" if name == "a" else "done"

    def on_step(self, sess, st) -> None:
        if sess.t_open is None or self.phase == "done":
            return
        now = time.perf_counter()
        if self.phase is None and now >= sess.t_close - self.secs["a"]:
            self._start("a", sess)
        elif self.phase == "a" and st.t1 >= sess.t_close:
            self._stop("a", sess)
        elif self.phase == "gap":
            self._start("b", sess)
        elif self.phase == "b" and now >= self.t["b"][0] + self.secs["b"]:
            self._stop("b", sess)

    def busy(self) -> bool:
        return self.phase != "done"

    def stop(self, sess) -> None:
        if self.phase in ("a", "b"):
            self._stop(self.phase, sess)

    def step_ctx(self):
        if self.phase == "b":
            return torch.autograd.profiler.record_function("cardbench.step")
        return contextlib.nullcontext()

    def read(self) -> TraceSummary:
        t = time.perf_counter()
        out = {}
        for name, p in self.prof.items():
            st = reduce(_events(p), self.t[name][1] - self.t[name][0],
                        host=name == "b")
            st.steps = tuple(self.i[name])
            out[name] = st
        self.prof = {}
        self.summary = TraceSummary(out["a"], out.get("b"),
                                    time.perf_counter() - t)
        return self.summary


def _events(prof):
    """(name, on_device, start_ns, end_ns, correlation, thread,
    user_annotation) of every event of the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), dev, e.start_ns(), e.end_ns(),
                    e.correlation_id(), e.start_thread_id(),
                    bool(e.is_user_annotation())))
    return out


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events, window_s: float, host: bool = True) -> Stretch:
    """A stretch's numbers from its events; ``host``: read the
    benchmark's ranges and name the idle gaps by host activity."""
    dev = [e for e in events if e[1] and not e[6]
           and not e[0].startswith("cardbench.")]
    hev = [e for e in events if not e[1]] if host else []
    notes = []
    if not dev:
        notes.append("no device activity in the trace")
        return Stretch(window_s, 0.0, {}, {}, {}, notes=notes,
                       events=len(events))
    busy = _union([(e[2], e[3]) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    kernels: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        k = kernels[e[0]]
        k[0] += (e[3] - e[2]) / 1e9
        k[1] += 1
    # the host thread that ran the steps: the one holding cardbench.step
    main = [e[5] for e in hev if e[0] == "cardbench.step"]
    tid = max(set(main), key=main.count) if main else None
    mine = [e for e in hev if tid is None or e[5] == tid]
    # the benchmark's ranges on the host, and the device work they launched
    spans = {n: sorted((e[2], e[3]) for e in mine if e[0] == n) for n in RANGES}
    launch_t = {e[4]: e[2] for e in hev if e[4] and not e[0].startswith(
        ("cardbench.", "aten::"))}
    ranges = {}
    for n, iv in spans.items():
        starts = [a for a, _ in iv]
        tot = 0.0
        for e in dev:
            t = launch_t.get(e[4])
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and iv[j][0] <= t <= iv[j][1]:
                tot += (e[3] - e[2]) / 1e9
        ranges[n] = tot
    if host and not any(launch_t.get(e[4]) is not None for e in dev):
        notes.append("no correlation between host launches and device work")
    idle = _idle_by_host(busy, mine) if host else {}
    return Stretch(window_s, busy_s,
                   {k: (v[0], v[1]) for k, v in kernels.items()},
                   ranges, idle, events=len(events), notes=notes)


def _idle_by_host(busy, host) -> Dict[str, float]:
    """Each device idle gap between two busy stretches, named by the
    innermost host event that covers its middle (``python`` where the host
    ran no recorded event), summed by name."""
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    evs = sorted((e[2], e[3], e[0]) for e in host)
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while j < len(evs) and evs[j][0] <= mid:
            while stack and stack[-1][1] < evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "python"
        out[name] += (b - a) / 1e9
    return dict(out)


def breakdown(s: TraceSummary, n: int = 10) -> dict:
    """Device time by operation (stretch A), and device idle time by what
    the host was doing (stretch B), the ten largest of each."""
    ops = sorted(((k, v[0]) for k, v in s.a.kernels.items()),
                 key=lambda x: -x[1])[:n]
    idle = s.b.idle_by_host if s.b is not None else {}
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
