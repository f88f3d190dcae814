"""The 95th percentile of every multiply's time in the window, each from
the call into ``matmul`` until the card has finished it."""
import statistics


def read(run):
    if len(run.times_ms) < 2:
        return None
    return statistics.quantiles(run.times_ms, n=20, method="inclusive")[18]
