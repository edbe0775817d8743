"""Host time of the window pool's release of pages that left the window
(``kv.window`` spans, one at the start of each step) over the engine's step
time, in percent, over the quiet window; nothing to read for a model
without window layers."""
from cardbench.lib import spans


def read(run):
    v = spans.step_share_pct(run, lambda s: spans.total_ns(s, "kv.window"))
    return v if v else None
