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


def _take(mix, seed, n=128):
    t = json.loads((TRAFFIC / f"{mix}.json").read_text())
    return list(islice(RequestStream(t, seed, 50304), n))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_schedule(mix):
    a, b = _take(mix, 2 ** 31 + 11), _take(mix, 2 ** 31 + 11)
    assert [(r.gap, r.max_new, r.prompt.tolist()) for r in a] == \
        [(r.gap, r.max_new, r.prompt.tolist()) for r in b]


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_schedule_same_sizes(mix):
    a, b = _take(mix, 2 ** 31 + 11), _take(mix, 2 ** 31 + 12)
    assert [r.max_new for r in a] != [r.max_new for r in b]
    assert a[0].prompt.tolist() != b[0].prompt.tolist()
    for lo in (0, 64):  # each block of 64 holds the same sizes and gaps
        blk = slice(lo, lo + 64)
        assert sorted(len(r.prompt) for r in a[blk]) == \
            sorted(len(r.prompt) for r in b[blk])
        assert sorted(r.max_new for r in a[blk]) == sorted(r.max_new for r in b[blk])
        assert np.allclose(sorted(r.gap for r in a[blk]), sorted(r.gap for r in b[blk]))


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
