"""The reader of the share of a window's decode batches replayed as a CUDA
graph (``decode_graph_share.*``), on fake runs."""
from types import SimpleNamespace

import pytest

from cardbench.lib import metrics, serve


def _fake_run(stats):
    """A RunView over one engine step per ``stats`` entry, all in the quiet
    window of an untraced run."""
    steps = [serve.Step(10.0 + i, 10.5 + i, [], [], [], s, [])
             for i, s in enumerate(stats)]
    sess = SimpleNamespace(steps=steps, t_open=10.0, t_close=10.0 + len(steps),
                           t_end=10.0 + len(steps))
    return metrics.RunView({"name": "x"}, {"arch": {}}, {}, sess, 3.0, 0)


@pytest.mark.parametrize("name", ["decode_graph_share.batch",
                                  "decode_graph_share.chat"])
def test_decode_graph_share_reader(name):
    read = metrics.reader(name)
    replayed = [{"decode_batches": 1, "decode_graph_replays": 1}] * 4
    assert read(_fake_run(replayed)) == 100.0
    one_eager = [{"decode_batches": 1, "decode_graph_replays": 0}] + replayed
    assert read(_fake_run(one_eager)) == 80.0
    # a program that counts no replays (before decode graphs): silent
    assert read(_fake_run([{"decode_batches": 1}] * 4)) is None
    # no decode batch in the window: nothing to read
    assert read(_fake_run([{"decode_batches": 0,
                            "decode_graph_replays": 0}])) is None
