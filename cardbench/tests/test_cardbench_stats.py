"""The percentile arithmetic and the run-to-run spread."""
import statistics

import numpy as np
import pytest

from cardbench.lib import stats


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_interpolates_as_the_port(q):
    from repro_torch.serve.metrics import _dist
    v = list(np.random.default_rng(3).lognormal(5, 1, 37))
    assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)))
    if q in (50, 99):
        assert stats.percentile(v, q) == _dist(v)[f"p{q}"]


def test_percentile_hand_worked():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([10, 20, 30, 40, 50], 90) == 46.0
    assert stats.percentile([], 90) is None


def test_spread_is_quartiles_over_median():
    v = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))
