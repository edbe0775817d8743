"""Prompt tokens of the traced prefill chunks over the device time of the
work launched inside the prefill passes (a profiler range opened by a hook
on the first layer's norm, closed by one on the last layer's ffn)."""
from cardbench.lib import window


def read(run):
    return window.prefill_rate(run)
