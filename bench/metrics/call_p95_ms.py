"""The 95th percentile of each multiply's time, from the call into
``matmul`` until the card has finished it, over the part of a traced
run's window that the profiler and the spans leave alone (the traced
part's multiplies carry the tracing's host time).  ``multiply_p95_ms``
where a cell's host makes that tail too unsteady to bound end to end."""
import statistics


def read(run):
    times = run.times_ms[run.traced_completed:]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
