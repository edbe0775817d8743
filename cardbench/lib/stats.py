"""Percentile arithmetic of the benchmark.

``percentile`` is a frozen copy of the arithmetic of ``_dist`` in
``src/repro_torch/serve/metrics.py`` (numpy's linear interpolation between
the two nearest ranks, on float64), applied here to wall-clock stamps that
the harness takes, never to the engine's modeled clock. ``spread`` is the
run-to-run spread the bounds of ``BENCHMARK.json`` are set from: the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median.
"""
from __future__ import annotations

import statistics
from typing import Iterable, Optional

import numpy as np


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100) of the values; None when there are
    none."""
    a = np.asarray(list(values), dtype=np.float64)
    if a.size == 0:
        return None
    return float(np.percentile(a, q))


def spread(values: Iterable[float]) -> float:
    """(Q3 - Q1) / median of at least two values."""
    v = list(values)
    q1, _, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / statistics.median(v)
