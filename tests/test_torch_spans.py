"""The span recorder (``repro_torch.spans``): nesting and parent links,
wrap-around, reads by window, exit on an exception, the profiler mirror on
the trace's clock; and the spans a CPU ``ServeEngine`` records against its
own ``EngineStats``."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import UnifiedMemory
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine
from repro_torch.spans import CAPACITY, SPANS, Recorder


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all(rec):
    return rec.read(0.0, time.perf_counter() + 1.0)


def test_nesting_parent_links_and_tags():
    rec = Recorder(16)
    with rec.span("outer", 7) as outer:
        with rec.span("a"):
            pass
        with rec.span("b", 1) as b:
            with rec.span("c"):
                pass
            b.tag = 3
    with rec.span("after"):
        pass
    spans, lost = _all(rec)
    assert not lost
    assert [s.name for s in spans] == ["outer", "a", "b", "c", "after"]
    o, a, b, c, after = spans
    assert (o.parent, a.parent, b.parent, c.parent, after.parent) == (
        -1, o.seq, o.seq, b.seq, -1)
    assert (o.tag, a.tag, b.tag, c.tag) == (7, -1, 3, -1)
    assert outer.seq == o.seq
    for s in spans:
        assert 0 <= s.dur_ns and s.t1_ns >= s.t0_ns
    assert o.t0_ns <= a.t0_ns <= a.t1_ns <= b.t0_ns <= c.t0_ns <= c.t1_ns \
        <= b.t1_ns <= o.t1_ns <= after.t0_ns
    assert not rec.stack


def test_capacity_is_a_power_of_two():
    with pytest.raises(ValueError):
        Recorder(12)
    assert CAPACITY == 1 << 17 and SPANS.capacity == CAPACITY


def test_wrap_around_reports_an_overwritten_start():
    rec = Recorder(8)
    for i in range(20):
        with rec.span("s", i):
            pass
    spans, lost = _all(rec)
    assert lost
    assert [s.tag for s in spans] == list(range(12, 20))
    # a window that starts after the oldest kept span is whole
    t0 = (spans[2].t1_ns + spans[3].t0_ns) / 2e9
    part, lost = rec.read(t0, time.perf_counter())
    assert not lost and [s.tag for s in part] == [15, 16, 17, 18, 19]
    # a span left open while the ring wraps past it is not written back
    with rec.span("long") as long:
        for _ in range(8):
            with rec.span("x"):
                pass
    spans, _ = _all(rec)
    assert long.seq not in {s.seq for s in spans}
    assert not rec.stack


def test_read_by_window():
    rec = Recorder(64)
    marks = []
    for i in range(10):
        marks.append(time.perf_counter())
        with rec.span("w", i):
            time.sleep(1e-4)
    marks.append(time.perf_counter())
    spans, lost = rec.read(marks[3], marks[7])
    assert not lost and [s.tag for s in spans] == [3, 4, 5, 6]
    assert rec.read(marks[-1], marks[-1] + 1.0) == ([], False)


def test_a_span_exits_on_an_exception():
    rec = Recorder(16)
    with pytest.raises(KeyError):
        with rec.span("outer"):
            with rec.span("inner", 2):
                raise KeyError("x")
    assert not rec.stack
    with rec.span("next"):
        pass
    spans, _ = _all(rec)
    assert [(s.name, s.parent, s.tag) for s in spans] == [
        ("outer", -1, -1), ("inner", spans[0].seq, 2), ("next", -1, -1)]
    assert all(s.t1_ns >= s.t0_ns for s in spans)


def test_the_mirror_shares_the_profilers_clock():
    rec = Recorder(16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first record_function resolves its operator (about a
        # millisecond) between the range's start and the span's
        with rec.span("mirror.first"):
            pass
        with rec.span("mirror.outer"):
            with pytest.raises(RuntimeError):
                with rec.span("mirror.inner"):
                    torch.ones(4).sum()
                    raise RuntimeError("leaves the range too")
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans, _ = _all(rec)
    for s in spans[1:]:
        e = events[s.name]
        assert abs(e.start_ns() - (s.t0_ns + rec.trace_offset_ns)) < 1_000_000
        assert e.end_ns() >= e.start_ns()
    assert events["mirror.inner"].end_ns() <= events["mirror.outer"].end_ns()


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = Recorder(16)
    assert not torch.autograd._profiler_enabled()
    with rec.span("quiet", 1):
        pass
    assert [s.name for s in _all(rec)[0]] == ["quiet"]


def _ancestors(s, by_seq):
    out = []
    while s.parent in by_seq:
        s = by_seq[s.parent]
        out.append(s.name)
    return out


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_engine_spans_match_its_stats(arch):
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=3, device="cpu")
    eng = ServeEngine(cfg, model, max_seqs=4, max_len=96, page_size=8,
                      prefill_chunk=16, um=UnifiedMemory(), device="cpu")
    norms = [0]
    model.final_norm.register_forward_hook(
        lambda m, a, o: norms.__setitem__(0, norms[0] + 1))
    rng = np.random.default_rng(0)
    for plen in (5, 21, 40, 9, 30):
        eng.add_request(rng.integers(2, cfg.vocab_size, plen), 6)
    seen = {"decode": 0, "charge_in_decode": 0, "moe": 0}
    more = True
    while more:
        st0 = dict(vars(eng.stats))
        n0, t0 = norms[0], time.perf_counter()
        more = eng.step()
        spans, lost = SPANS.read(t0, time.perf_counter())
        d = {k: v - st0[k] for k, v in vars(eng.stats).items()}
        assert not lost
        by_seq = {s.seq: s for s in spans}
        names = [s.name for s in spans]
        assert names.count("serve.step") == 1 and names[0] == "serve.step"
        assert names.count("serve.admit") == 1
        assert spans[names.index("serve.admit")].tag == d["admitted"] + d["resumed"]
        assert names.count("serve.prefill") == d["prefill_chunks"]
        assert names.count("serve.decode") == d["decode_batches"]
        dec = [s for s in spans if s.name == "serve.decode"]
        assert sum(s.tag for s in dec) == d["decode_tokens"]
        for s in spans:
            assert s.t1_ns >= s.t0_ns
            if s.name != "serve.step":
                assert "serve.step" in _ancestors(s, by_seq), s.name
            if s.name == "serve.sync":
                assert by_seq[s.parent].name in ("serve.decode", "serve.prefill")
            if s.name == "um.charge":
                up = _ancestors(s, by_seq)
                seen["charge_in_decode"] += up[0] == "serve.decode"
                assert up[0] in ("serve.step", "serve.admit", "serve.prefill",
                                 "serve.decode", "serve.pages")
            if s.name == "serve.prefill":
                assert s.tag in eng.requests  # the rid
            if s.name == "moe.block":
                assert by_seq[s.parent].name in ("serve.prefill", "serve.decode")
        for s in dec:
            kids = [c.name for c in spans if c.parent == s.seq]
            assert kids.count("serve.sync") == 1 and "um.charge" in kids
        # um.sync's charge, directly under the step
        step = spans[0]
        assert any(s.name == "um.charge" and s.parent == step.seq for s in spans)
        passes = d["decode_batches"] + sum(
            1 for s in spans if s.name == "serve.prefill"
            and any(c.parent == s.seq and c.name == "serve.sync" for c in spans))
        assert norms[0] - n0 == passes  # one final norm a token-producing pass
        if cfg.num_experts:
            assert names.count("moe.block") == cfg.num_layers * (
                d["prefill_chunks"] + d["decode_batches"])
        seen["decode"] += d["decode_batches"]
        seen["moe"] += names.count("moe.block")
    assert seen["decode"] > 0 and seen["charge_in_decode"] == seen["decode"]
    assert (seen["moe"] > 0) == bool(cfg.num_experts)
