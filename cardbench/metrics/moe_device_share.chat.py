"""``moe_device_share`` in the open-loop chat cells (it moves their
``itl_p95_ms``): device time of the work launched inside the MoE blocks
over the device's busy time, in percent, over the traced stretch B."""
from cardbench.lib import window


def read(run):
    if not run.cfg.get("num_experts"):
        return None
    return window.range_share_pct(run, "cardbench.ffn")
