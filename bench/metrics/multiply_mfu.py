"""The whole multiply's share of the chip's peak: the flops its inputs
need over (the wall time a multiply in the traced part of the window x the
dtype's peak), in %."""
from bench import work


def read(run):
    if not run.traced_completed or not run.traced_s:
        return None
    per = run.traced_s / run.traced_completed
    peak = work.PEAK_FLOPS[run.work["dtype"]]
    return 100.0 * run.work["flops"] / (per * peak)
