"""Byte-bound time over device time of the paged decode attention kernel
(both of its passes, by name in the profiler trace), in percent. Bytes a
call: q, the K and V of the tokens each sequence attends, each read once,
and the output, over 3.35 TB/s."""
from cardbench.lib import window

KERNELS = ("paged_partial_kernel", "paged_combine_kernel")


def read(run):
    t = window.traced(run, "a")
    if t is None:
        return None
    dev = sum(v[0] for k, v in t.kernels.items() if any(n in k for n in KERNELS))
    if dev <= 0:
        return None
    return 100.0 * window.paged_bound_s(run, run.steps_of(t)) / dev
