"""95th percentile of every gap between consecutive tokens of one request
inside the window (host clock)."""
from cardbench.lib import stats, window


def read(run):
    return stats.percentile(window.itls_ms(run), 95)
