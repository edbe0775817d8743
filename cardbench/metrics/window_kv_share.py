"""Pages the sliding-window layers' KV pool holds over the pages those
layers would hold with every key, at each decode batch, in percent, the
mean over the quiet window's decode batches (``EngineStats``
``window_pages_held`` and ``window_pages_all_keys`` deltas); nothing to
read for a model without window layers, or a program without the
counters."""
from cardbench.lib import window


def read(run):
    shares = [100.0 * s.stats["window_pages_held"]
              / s.stats["window_pages_all_keys"]
              for s in window.quiet_steps(run)
              if s.stats.get("window_pages_all_keys")]
    return sum(shares) / len(shares) if shares else None
