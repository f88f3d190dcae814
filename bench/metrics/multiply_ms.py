"""Milliseconds a multiply: the window's wall time over the multiplies
completed in it (the harness's check of each answer included)."""


def read(run):
    return run.window_s * 1e3 / run.completed if run.completed else None
