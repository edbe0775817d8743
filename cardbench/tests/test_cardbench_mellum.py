"""``mellum-code32`` cut to a size the CPU runs in seconds (4 layers, three
window layers of 16 keys and one YaRN layer, pages of 4, 8 experts top-2,
prompts 3-5 windows long): a sound run is judged correct by the model
module's reference (``cardbench/models/mellum.py``), and the three planted
faults the cell's limits were set against are not: window layers that
attend every key, full layers on plain rope, a served token altered. The
window pool's readers report on it and stay silent without window layers;
the module's counts are the sums they stand for."""
import contextlib
import copy
import math
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cardbench.lib import bench, counts, metrics, model, weights, window
from cardbench.tests import tiny
from repro_torch.serve.paged import window_pages

ROOT = Path(__file__).resolve().parents[2]


def spec() -> dict:
    s = bench.load(ROOT, "mellum-code32")
    cf = copy.deepcopy(s["cfg_file"])
    cf["arch"].update(num_layers=4, d_model=64, d_ff=32, vocab_size=256,
                      num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
                      top_k=2, local_window=16)
    cf["engine"].update(max_seqs=8, max_len=160, page_size=4, prefill_chunk=16,
                        num_pages={"attention": 400, "local": 100})
    t = copy.deepcopy(s["traffic"])
    t["prompt"].update(lo=48, hi=80, mean=56)
    t["output"].update(lo=4, hi=30, mean=12)
    t.update(block=16, clients=6)
    s.update(cfg_file=cf, traffic=t)
    return s


def _run(s, prepare=None, seconds=1.0):
    torch.set_num_threads(1)
    return bench.run_cell(s, 2 ** 31 + 7, seconds, False, time.perf_counter(),
                          device="cpu", log=lambda line: None,
                          prepare=prepare, readings=True)


def test_sound_run_is_correct():
    out = _run(spec())
    assert out["correct"], out["checks"]
    r = out["readings"]
    assert r["served_logit_gap"] == 0.0 and r["final_hidden_err"] < 1e-4


def _window_ignored(model_, eng):
    eng.wcache.window = 0  # its layers keep and attend every key


def _plain_rope(model_, eng):
    for blk in model_.layers:
        blk.mixer.yarn = False


def _altered_token(model_, eng):
    real, calls = model_.logits_out, [0]

    def logits_out(x, *a, **kw):
        lg = real(x, *a, **kw)
        calls[0] += 1
        if calls[0] % 7 == 0:  # now and then, the second best wins
            top2 = torch.topk(lg, 2, dim=-1).indices[..., 1:]
            lg = lg.scatter(-1, top2, float(lg.max()) + 1.0)
        return lg
    model_.logits_out = logits_out


@pytest.mark.parametrize("fault", [_window_ignored, _plain_rope, _altered_token])
def test_fault_is_not_correct(fault):
    s = spec()
    s["cfg_file"]["engine"]["num_pages"]["local"] = 400  # every key fits
    out = _run(s, prepare=fault)
    assert not out["correct"], out["checks"]


def _view(s, monkeypatch, prepare=None):
    """The RunView of a tiny run, its quiet window ending at the window's
    middle step as a traced run's does."""
    seen = []
    real = metrics.compute

    def compute(entries, run):
        seen.append(run)
        return real(entries, run)
    monkeypatch.setattr(bench.metrics, "compute", compute)
    if "mellum" in s["cfg_file"]["name"]:
        out = _run(s, prepare)
    else:
        out = tiny.run(s, seconds=0.8)
    assert out["correct"], out["checks"]
    run = seen[0]
    inside = [i for i, st in enumerate(run.sess.steps)
              if run.sess.t_open <= st.t0 < run.sess.t_close]
    run.trace = SimpleNamespace(a=SimpleNamespace(
        steps=(inside[len(inside) // 2], len(run.sess.steps))))
    assert len(window.quiet_steps(run)) >= 3
    return run


def test_window_readers(monkeypatch):
    stats = []
    run = _view(spec(), monkeypatch, lambda m, eng: stats.append(eng.stats))
    kv = metrics.reader("window_kv_share")(run)
    host = metrics.reader("window_host_share")(run)
    assert 0 < kv < 100 and 0 < host < 100, (kv, host)
    # a decode batch's share is what the pool holds over every key's pages
    st = [s.stats for s in window.quiet_steps(run) if s.stats["decode_batches"]]
    assert all(0 < s["window_pages_held"] < s["window_pages_all_keys"] for s in st)
    # no sequence held more than its window and a prefill chunk need
    assert 0 < stats[0].window_seq_pages_max <= window_pages(16, 16, 4)


def test_window_readers_silent_without_window_layers(monkeypatch):
    run = _view(tiny.spec("olmoe-batch"), monkeypatch)
    assert metrics.reader("window_kv_share")(run) is None
    assert metrics.reader("window_host_share")(run) is None


@pytest.mark.parametrize("size", ["full", "tiny"])
def test_counts(size):
    cf = (bench.load(ROOT, "mellum-code32")["cfg_file"] if size == "full"
          else spec()["cfg_file"])
    m, cfg = model.load(cf), cf["arch"]
    assert m.layout(cfg) == weights.layout(cfg)
    W = cfg["local_window"]
    for a, b in ((0, 5), (0, 256), (W - 3, W + 40), (3000, 3256), (7000, 7001)):
        assert math.isclose(m.span_flops(cfg, a, b),
                            sum(m.token_flops(cfg, p) for p in range(a, b)),
                            rel_tol=1e-12)
    lens = [1, W, W + 1, 4 * W]
    n_local = sum(1 for i in range(cfg["num_layers"])
                  if cfg["layer_pattern"][i % 4] == "local")
    assert m.paged_bytes(cfg, lens) == (
        (cfg["num_layers"] - n_local) * counts.paged_attention_bytes(cfg, lens)
        + n_local * counts.paged_attention_bytes(cfg, [min(n, W) for n in lens]))
    if size == "full":  # 48.6 GB of fp32 weights
        assert n_local == 21 and weights.param_count(cfg) == 12_149_915_904


def test_traced_run_lets_go_of_the_program_before_the_reference(monkeypatch):
    """A traced run's tracer holds the program's model until the run ends;
    the reference's weights are made only once that model is gone, since
    the two sets of weights do not fit on one card together."""
    from cardbench.lib import trace
    from cardbench.models import mellum

    held = []

    class Tracer:  # holds the model as the harness's tracer does
        def __init__(self, model_, a, b):
            self.model = model_
            held.append(weakref.ref(model_))

        def on_step(self, sess, st):
            pass

        def step_ctx(self):
            return contextlib.nullcontext()

        def busy(self):
            return False

        def stop(self, sess):
            pass

        def read(self):
            return None

    alive_at_make = []
    make = weights.make

    def make_after(cfg, seed, device, *a, **k):
        if held:  # the reference's weights; the program's come first
            alive_at_make.append(held[0]() is not None)
        return make(cfg, seed, device, *a, **k)

    monkeypatch.setattr(trace, "prime", lambda: None)
    monkeypatch.setattr(trace, "Tracer", Tracer)
    monkeypatch.setattr(mellum.weights, "make", make_after)
    torch.set_num_threads(1)
    out = bench.run_cell(spec(), 2 ** 31 + 7, 1.0, True, time.perf_counter(),
                         device="cpu", log=lambda line: None)
    assert out["correct"], out["checks"]
    assert alive_at_make == [False]
