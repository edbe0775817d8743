"""Host time of the scheduler itself (self time of the ``serve.step``,
``serve.admit`` and ``serve.pages`` spans: the step outside its passes and
charges, admission, page backing and preemption) over the engine's step
time, in percent, over the quiet window."""
from cardbench.lib import spans

NAMES = ("serve.step", "serve.admit", "serve.pages")


def read(run):
    return spans.step_share_pct(run, lambda s: spans.self_ns(s, NAMES))
