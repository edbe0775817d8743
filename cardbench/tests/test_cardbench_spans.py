"""The span readers on a tiny CPU run of a cell, its quiet window cut as a
traced run's is: each reads a share in (0, 100) or a time above 0, and
None once the program's ring has overwritten the window's start, or where
the program records no spans at all."""
import sys
from types import SimpleNamespace

import pytest

from cardbench.lib import bench, metrics, window
from cardbench.tests import tiny

READERS = {
    "yi6b-chat": ["charge_host_share.chat", "sched_host_share.chat",
                  "decode_issue_ms_p50.chat"],
    "olmoe-batch": ["charge_host_share.batch", "sched_host_share.batch",
                    "decode_issue_ms_p50.batch", "moe_host_share"],
}


def _view(cell, monkeypatch):
    """The RunView of a tiny run, with a stand-in trace whose stretch A
    starts at the window's middle step (so ``quiet`` ends there)."""
    seen = []
    real = metrics.compute

    def compute(entries, run):
        seen.append(run)
        return real(entries, run)
    monkeypatch.setattr(bench.metrics, "compute", compute)
    out = tiny.run(tiny.spec(cell), seconds=0.8)
    assert out["correct"], out["checks"]
    run = seen[0]
    inside = [i for i, s in enumerate(run.sess.steps)
              if run.sess.t_open <= s.t0 < run.sess.t_close]
    run.trace = SimpleNamespace(a=SimpleNamespace(
        steps=(inside[len(inside) // 2], len(run.sess.steps))))
    assert len(window.quiet_steps(run)) >= 3
    return run


@pytest.mark.parametrize("cell", sorted(READERS))
def test_span_readers(cell, monkeypatch):
    run = _view(cell, monkeypatch)
    for name in READERS[cell]:
        v = metrics.reader(name)(run)
        assert v is not None, name
        if name.startswith("decode_issue_ms"):
            assert v > 0
        else:
            assert 0 < v < 100, (name, v)
    if cell == "yi6b-chat":  # a dense model has no MoE blocks
        assert metrics.reader("moe_host_share")(run) is None
    # a program without spans (the checkout before them): silent
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "repro_torch.spans", None)
        assert all(metrics.reader(n)(run) is None for n in READERS[cell])
    # the ring overwrites the window's start: silent
    from repro_torch.spans import SPANS
    for _ in range(SPANS.capacity):
        with SPANS.span("flood"):
            pass
    for name in READERS[cell]:
        assert metrics.reader(name)(run) is None, name
