"""Sequences a decode batch holds, on average over the window: the
engine's decode_tokens over its decode_batches (EngineStats deltas)."""
from cardbench.lib import window


def read(run):
    st = window.quiet_steps(run)
    batches = sum(s.stats["decode_batches"] for s in st)
    return sum(s.stats["decode_tokens"] for s in st) / batches if batches else None
