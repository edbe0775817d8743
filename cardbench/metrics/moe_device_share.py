"""Device time of the work launched inside the MoE blocks (forward hooks
on each block's ffn open a profiler range) over the device's busy time,
in percent, over the traced stretch B."""
from cardbench.lib import window


def read(run):
    if not run.cfg.get("num_experts"):
        return None
    return window.range_share_pct(run, "cardbench.ffn")
