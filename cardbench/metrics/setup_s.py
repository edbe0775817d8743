"""Process start to the opening of the window: imports, weights, the
engine and its pool, the warm-up, the lead-in of the load (host clock)."""


def read(run):
    return run.setup_s
