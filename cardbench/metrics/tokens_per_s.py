"""Prompt tokens prefilled plus tokens generated inside the window, over
the window's seconds (host clock)."""
from cardbench.lib import window


def read(run):
    prefill, gen = window.tokens_in_window(run)
    return (prefill + gen) / run.window_s
