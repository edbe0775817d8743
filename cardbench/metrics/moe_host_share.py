"""Host time inside the MoE blocks (``moe.block`` spans around each
``MoE.forward``) over the engine's step time, in percent, over the quiet
window; nothing to read for a dense model. The device works while the
host issues, so this is the host's time, not the device's."""
from cardbench.lib import spans


def read(run):
    v = spans.step_share_pct(run, lambda s: spans.total_ns(s, "moe.block"))
    return v if v else None
