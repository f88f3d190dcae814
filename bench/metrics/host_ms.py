"""Milliseconds of host work a multiply: from the call into ``matmul``
until the host begins to wait for the card inside the harness's
``bench.multiply`` range, or until the call returns where it never waits,
the mean over the traced part of the window.

A traced multiply of the stacked executor no longer waits inside
``matmul`` (its spans' CUDA events are read after the window), so this
reads to the call's return.  Readings from before that change of the
program stopped at ``matmul``'s own wait, earlier in the call: a
comparison across it is not like for like."""


def read(run):
    return sum(run.host_ms) / len(run.host_ms) if run.host_ms else None
