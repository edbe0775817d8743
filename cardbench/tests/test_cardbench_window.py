"""Window accounting of the metric readers, on a hand-made record: a
request with no token by the window's end counts (end - due) in the TTFT;
tokens, gaps and steps count inside the window only."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cardbench.lib import metrics, serve, stats, window

ROOT = Path(__file__).resolve().parents[2]
CFG = {"arch": {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
                "head_dim": 2, "d_ff": 16, "vocab_size": 10}}


def _req(rid, due, plen, tokens, admit=None, done=None, max_new=4):
    return serve.Req(rid, rid, None, due, due, np.zeros(plen, np.int64),
                     max_new, admit, list(tokens), done)


def _step(t0, t1, chunks=(), decode=(), dlen=()):
    return serve.Step(t0, t1, list(chunks), list(decode), list(dlen),
                      {"decode_batches": int(bool(decode)),
                       "decode_tokens": len(decode),
                       "prefill_chunks": len(chunks)}, [])


def _run(reqs, steps, t_open=10.0, t_close=20.0, t_end=20.5):
    sess = SimpleNamespace(reqs={q.rid: q for q in reqs}, steps=steps,
                           t_open=t_open, t_close=t_close, t_end=t_end)
    sess.due_in_window = lambda: [q for q in reqs if t_open <= q.due < t_close]
    return metrics.RunView({"name": "x"}, CFG, {}, sess, 3.0, 2 ** 30)


def _read(name, run):
    return metrics.reader(name)(run)


def test_ttft_counts_a_request_with_no_token_as_end_minus_due():
    reqs = [_req(0, 9.0, 4, [9.5]),                  # due before: not counted
            _req(1, 11.0, 4, [11.2, 11.3], 11.1),    # 200 ms
            _req(2, 12.0, 4, [], None),              # no token: 20.5 - 12
            _req(3, 19.0, 4, [21.0])]                # token after the end
    run = _run(reqs, [])
    ttft = sorted(window.ttfts_ms(run))
    assert ttft == pytest.approx([200.0, 1500.0, 8500.0])
    assert stats.percentile(window.ttfts_ms(run), 90) == pytest.approx(
        np.percentile(ttft, 90))


def test_tokens_and_gaps_inside_the_window_only():
    reqs = [_req(0, 5.0, 4, [9.0, 10.5, 11.0, 21.0]),
            _req(1, 12.0, 4, [12.5, 13.0])]
    steps = [_step(8.0, 9.0, chunks=[(0, 0, 4)]),
             _step(10.0, 10.5, decode=[0], dlen=[5]),
             _step(10.5, 11.0, decode=[0], dlen=[6]),
             _step(12.0, 12.5, chunks=[(1, 0, 4)]),
             _step(12.5, 13.0, decode=[1], dlen=[5]),
             _step(20.6, 21.0, decode=[0], dlen=[7])]  # after the end
    run = _run(reqs, steps)
    # generated inside: 10.5, 11.0, 12.5, 13.0; prefilled inside: request 1's 4
    assert _read("tokens_per_s", run) == pytest.approx((4 + 4) / 10.5)
    assert sorted(window.itls_ms(run)) == pytest.approx([500.0, 500.0])
    assert _read("decode_batch_mean", run) == 1.0
    assert _read("decode_step_ms_p50", run) == pytest.approx(500.0)


def test_queue_wait_median():
    reqs = [_req(0, 11.0, 4, [], 11.5), _req(1, 12.0, 4, [], 12.1),
            _req(2, 13.0, 4, [], None)]
    waits = window.queue_waits_ms(_run(reqs, []))
    assert sorted(waits) == pytest.approx([100.0, 500.0, 7500.0])
    assert stats.percentile(waits, 50) == pytest.approx(500.0)


def test_setup_and_memory():
    run = _run([], [])
    assert _read("setup_s", run) == 3.0
    assert _read("memory_peak_gib", run) == 1.0


def test_device_readers_are_silent_without_a_trace():
    run = _run([], [])
    for name in ("moe_device_share", "paged_attention_roofline",
                 "device_idle_share.chat", "step_host_share.batch",
                 "prefill_tokens_per_s.batch"):
        assert _read(name, run) is None


def test_every_metric_has_a_reader_and_cells_report_what_they_move():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metrics.reader(m["name"]))
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in metrics.for_cell(bench, cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = metrics.for_cell(bench, cell["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)
