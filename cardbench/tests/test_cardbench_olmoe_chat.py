"""``olmoe-chat`` cut to a CPU size: a sound run is correct, and its MoE
shares, split from the batch cells' because this cell moves ``itl_p95_ms``,
read the MoE blocks' host time (and nothing for a dense model)."""
from types import SimpleNamespace

from cardbench.lib import bench, metrics, window
from cardbench.tests import tiny


def _view(cell, monkeypatch):
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
        steps=(inside[len(inside) // 2], len(run.sess.steps))), b=None)
    assert len(window.quiet_steps(run)) >= 3
    return run


def test_chat_moe_host_share(monkeypatch):
    run = _view("olmoe-chat", monkeypatch)
    v = metrics.reader("moe_host_share.chat")(run)
    assert 0 < v < 100
    assert v == metrics.reader("moe_host_share")(run)
    assert metrics.reader("moe_device_share.chat")(run) is None  # no stretch B
    dense = _view("yi6b-chat", monkeypatch)
    assert metrics.reader("moe_host_share.chat")(dense) is None
    assert metrics.reader("moe_device_share.chat")(dense) is None
