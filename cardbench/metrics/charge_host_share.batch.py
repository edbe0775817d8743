"""Host time inside the charge model (``um.charge`` spans: every call of
the engine and the paged cache into ``UnifiedMemory``) over the engine's
step time (``serve.step`` spans), in percent, over the quiet window."""
from cardbench.lib import spans


def read(run):
    return spans.step_share_pct(run, lambda s: spans.total_ns(s, "um.charge"))
