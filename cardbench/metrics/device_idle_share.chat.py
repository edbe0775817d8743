"""Share of the traced stretch (host clock, synchronized at both ends)
in which no operation ran on the device, in percent."""
from cardbench.lib import window


def read(run):
    return window.idle_share_pct(run)
