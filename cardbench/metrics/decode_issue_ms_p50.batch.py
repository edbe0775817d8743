"""Median over the quiet window's decode batches of the host's time to
issue one: from the start of its ``serve.decode`` span to the start of its
``serve.sync`` span (the copy of the sampled tokens to the host), in ms."""
from cardbench.lib import spans, stats


def read(run):
    s = spans.window(run)
    return None if s is None else stats.percentile(spans.decode_issue_ms(s), 50)
