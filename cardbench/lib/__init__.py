"""The harness: traffic, the served load, tracing, metric arithmetic, the
plain reference and the check that decides ``correct``."""
