"""``moe_host_share`` in the open-loop chat cells (it moves their
``itl_p95_ms``): host time inside the MoE blocks (``moe.block`` spans)
over the engine's step time, in percent, over the quiet window."""
from cardbench.lib import spans


def read(run):
    v = spans.step_share_pct(run, lambda s: spans.total_ns(s, "moe.block"))
    return v if v else None
