"""Microseconds from the start of a call's ``matmul.coerce`` span (the
call into ``matmul``) to the start of its first ``kernel.bsr_spmm`` span
(B1's first launch enqueued), the mean over the calls in the traced part
of the window that have both."""
from bench import calls


def read(run):
    leads = []
    for spans in calls.in_window(run).values():
        coerce = [e["ts"] for e in spans if e["name"] == "matmul.coerce"]
        b1 = [e["ts"] for e in spans if e["name"] == "kernel.bsr_spmm"]
        if coerce and b1:
            leads.append(min(b1) - min(coerce))
    return sum(leads) / len(leads) if leads else None
