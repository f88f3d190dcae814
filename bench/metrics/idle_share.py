"""The share of the traced part of the window in which nothing ran on the
card, in %."""


def read(run):
    if not run.traced_s or run.busy_s is None or run.trace_lost:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
