"""Model FLOPs of the tokens the window processed (``counts``: 2 x the
matmul parameters a token meets, active experts only, plus attention at
its context, plus the head for each produced token) over the seconds they
took x 67 TFLOP/s (fp32 outside the tensor cores), in percent. Read over
the untraced part of the window."""
from cardbench.lib import window
from cardbench.lib.h100 import PEAK_FP32_FLOPS


def read(run):
    t0, t1 = run.quiet
    f = sum(window.step_flops(run, s) for s in window.quiet_steps(run))
    return 100.0 * f / ((t1 - t0) * PEAK_FP32_FLOPS) if t1 > t0 else None
