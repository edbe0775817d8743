"""Median wall time of the window's steps whose EngineStats delta shows one
decode batch and no prefill chunk."""
from cardbench.lib import stats, window


def read(run):
    return stats.percentile(
        [(s.t1 - s.t0) * 1e3 for s in window.quiet_steps(run)
         if s.stats["decode_batches"] == 1 and s.stats["prefill_chunks"] == 0], 50)
