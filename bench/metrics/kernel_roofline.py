"""The least time a multiply's inputs need on one H100 (``bench/work.py``:
flops from the inputs' nonzeros at the dtype's peak, or their bytes at the
HBM's rate, whichever is longer) over the card's busy time a multiply (every
kernel and copy in the traced part of the window), in %."""
from bench import work


def read(run):
    if not run.busy_s or run.trace_lost or not run.traced_completed:
        return None
    least = work.least_time(run.work)["seconds"]
    return 100.0 * least / (run.busy_s / run.traced_completed)
