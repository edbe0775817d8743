"""Share of the traced steps' wall time in which no operation ran on the
device: the host's share of a step (device busy time over the summed wall
time of the traced engine steps), in percent."""
from cardbench.lib import window


def read(run):
    return window.step_host_share_pct(run)
