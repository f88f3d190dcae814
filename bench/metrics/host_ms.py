"""Milliseconds of host work a multiply: from the call into ``matmul``
until the host begins to wait for the card (in a traced run ``matmul``
waits inside its own span), the mean over the traced part of the window."""


def read(run):
    return sum(run.host_ms) / len(run.host_ms) if run.host_ms else None
