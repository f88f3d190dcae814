"""B1's device milliseconds a multiply, from the program's own CUDA event
pairs: the ``device_ms`` of every ``kernel.bsr_spmm`` span (the kernel
and its NaN pass) of the calls in the traced part of the window, over
those calls.  Read without the profiler, so it stands where CUPTI drops
kernel records."""
from bench import calls


def read(run):
    got = calls.in_window(run)
    times = [t for spans in got.values()
             for t in calls.device_ms(spans, "kernel.bsr_spmm")]
    return sum(times) / len(got) if times else None
