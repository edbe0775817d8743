"""The seeded request streams: the same seed gives the same schedule,
another seed another one; a stratified mix gives every seed the same sizes
in each block; the frozen generators still draw as the port's do."""
import json
from itertools import islice
from pathlib import Path

import numpy as np
import pytest

from cardbench.lib.traffic import ArrivalProcess, LengthDist, RequestStream

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def _mix(mix):
    return json.loads((TRAFFIC / f"{mix}.json").read_text())


def _take(mix, seed, n=128):
    return list(islice(RequestStream(_mix(mix), seed, 50304), n))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_schedule(mix):
    a, b = _take(mix, 2 ** 31 + 11), _take(mix, 2 ** 31 + 11)
    assert [(r.gap, r.max_new, r.prompt.tolist()) for r in a] == \
        [(r.gap, r.max_new, r.prompt.tolist()) for r in b]


def _sizes(reqs):
    """The multisets of prompt lengths, output lengths and gaps."""
    return (sorted(len(r.prompt) for r in reqs), sorted(r.max_new for r in reqs),
            np.round(sorted(r.gap for r in reqs), 12).tolist())


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_schedule_same_sizes(mix):
    n = int(_mix(mix)["block"])
    a, b = _take(mix, 2 ** 31 + 11, 2 * n), _take(mix, 2 ** 31 + 12, 2 * n)
    assert [r.max_new for r in a] != [r.max_new for r in b]
    assert a[0].prompt.tolist() != b[0].prompt.tolist()
    for lo in (0, n):  # each block holds the same sizes and gaps
        blk = slice(lo, lo + n)
        assert _sizes(a[blk]) == _sizes(b[blk])


OPEN = [m for m in MIXES if _mix(m)["loop"] == "open"]
RUN_SECONDS = json.loads((TRAFFIC.parents[1] / "BENCHMARK.json").read_text())[
    "run_seconds"]


@pytest.mark.parametrize("mix", OPEN)
def test_window_holds_the_same_blocks_for_two_seeds(mix):
    """The lead-in is one block of arrivals and the window two: the requests
    due in the window are blocks 1 and 2, the same sizes for every seed,
    but for those due within the quantile grid's shortfall of its edges (a
    block of gaps lasts a little less than block / rate)."""
    t = _mix(mix)
    n, lead = int(t["block"]), float(t["lead_in_s"])
    rate = float(t["arrival"]["rate"])
    assert n == round(rate * lead) and RUN_SECONDS == 2 * lead
    short = 3 * (lead - sum(ArrivalProcess("poisson", rate=rate).gap_quantiles(n)))
    assert 0 < short < 0.5
    held = []
    for seed in (2 ** 31 + 11, 2 ** 31 + 12):
        reqs = _take(mix, seed, 4 * n)
        due = np.cumsum([r.gap for r in reqs])
        blocks = set(range(n, 3 * n))
        inside = {r.index for r, d in zip(reqs, due) if lead <= d < lead + RUN_SECONDS}
        assert all(lead - short <= due[i] < lead for i in blocks - inside)
        assert all(lead + RUN_SECONDS - short <= due[i] for i in inside - blocks)
        held.append(_sizes(reqs[n:3 * n]))
    assert held[0] == held[1]


def test_poisson_quantile_gaps_keep_the_rate():
    gaps = ArrivalProcess("poisson", rate=2.5).gap_quantiles(64)
    assert abs(64 / gaps.sum() - 2.5) < 0.1
    assert len(set(np.round(gaps, 9))) == 64


def test_lognormal_quantiles_clip_and_mean():
    d = LengthDist("lognormal", lo=16, hi=2048, mean=256, sigma=1.0)
    q = d.quantiles(64)
    assert q.min() >= 16 and q.max() <= 2048
    assert 220 < q.mean() < 280


@pytest.mark.parametrize("kind", ["poisson", "bursty", "uniform"])
def test_frozen_arrivals_draw_as_the_port(kind):
    from repro_torch.serve.traffic import ArrivalProcess as Port
    a = ArrivalProcess(kind, rate=3.0, burst_size=4).times(np.random.default_rng(5), 40)
    b = Port(kind, rate=3.0, burst_size=4).times(np.random.default_rng(5), 40)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["lognormal", "pareto", "fixed"])
def test_frozen_lengths_draw_as_the_port(kind):
    from repro_torch.serve.traffic import LengthDist as Port
    kw = dict(lo=4, hi=300, mean=40.0, sigma=0.9, alpha=1.3)
    a = LengthDist(kind, **kw).sample(np.random.default_rng(9), 50)
    b = Port(kind, **kw).sample(np.random.default_rng(9), 50)
    assert np.array_equal(a, b)


def test_iid_draw_follows_the_seed():
    t = {"loop": "open", "draw": "iid", "block": 16,
         "arrival": {"kind": "bursty", "rate": 4.0, "burst_size": 4},
         "prompt": {"kind": "pareto", "lo": 16, "hi": 512, "alpha": 1.4},
         "output": {"kind": "lognormal", "lo": 4, "hi": 64, "mean": 16}}
    a = [(r.gap, r.max_new, len(r.prompt)) for r in islice(RequestStream(t, 3, 100), 40)]
    b = [(r.gap, r.max_new, len(r.prompt)) for r in islice(RequestStream(t, 3, 100), 40)]
    c = [(r.gap, r.max_new, len(r.prompt)) for r in islice(RequestStream(t, 4, 100), 40)]
    assert a == b and a != c
    assert all(g >= 0 for g, _, _ in a)


@pytest.mark.parametrize("sizes", [(1, 8), (3, 6), (2, 64), (5, 5)])
def test_warm_up_runs_each_decode_size_twice(sizes):
    """A traffic file's ``warm_decode_sizes`` (lo, hi) makes the warm-up's
    decode batches a ramp: hi down to lo, two of each size (hi at most the
    engine's slots); its requests all finish. Without it the warm-up is as
    before."""
    import torch

    from cardbench.lib import model, serve
    from cardbench.tests import tiny
    torch.set_num_threads(1)
    cf = tiny.spec("yi6b-chat")["cfg_file"]
    n = cf["engine"]["max_seqs"]
    runs = []
    for arg in (None, sizes):
        _, eng = serve.build_engine(cf, model.make_weights(cf, 3, "cpu"), "cpu")
        seen, real = [], eng._decode_pass
        eng._decode_pass = lambda B, seen=seen, real=real: seen.append(B) or real(B)
        serve.warm_up(eng, cf, 3, arg)
        assert all(r.done for r in eng.requests.values())
        runs.append(seen)
    lo, hi = sizes[0], min(sizes[1], n)
    ramp = [b for b in range(hi, lo - 1, -1) for _ in (0, 1)]
    assert runs[1][:len(ramp)] == ramp
    assert runs[0][:3] == [n, n - 1, n - 2]  # the plain warm-up's own
