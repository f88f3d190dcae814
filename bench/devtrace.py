"""Reading a ``torch.profiler`` trace of the measured window: the device
intervals, the harness's own host ranges, the card's busy time and idle
gaps, and what the host was doing in each gap.

Times are microseconds on the profiler's clock.  The program's obs spans
count microseconds from a Unix time read once (advanced by
``perf_counter_ns``), the base the profiler's Chrome export writes too;
the harness moves them onto the profiler's in-memory events through an
anchor that it records in both at once.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

# the harness's host ranges (torch.profiler.record_function names)
MULTIPLY = "bench.multiply"
SYNC = "bench.sync"
ANCHOR = "bench.anchor"
WINDOW = "bench.window"
RANGES = (MULTIPLY, SYNC, ANCHOR, WINDOW)
# the CUDA runtime's waits for the card
WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")
TOP = 10


def kernel_name(raw: str) -> str:
    """``void ns::(anonymous namespace)::kern<...>(...)`` -> ``ns::kern``."""
    name = raw.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("<")[0].split("(")[0].strip()


def read(prof) -> dict:
    """Device intervals ``(name, start, end)`` (kernels and copies), the
    harness's host ranges by name, and the runtime's waits, from a
    finished profiler.  The trace also shows each host range on the
    device's timeline (a user annotation): those are not device work."""
    from torch.autograd import DeviceType
    device, host, waits = [], defaultdict(list), []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in RANGES:
                device.append((kernel_name(e.name), start, end))
        elif e.name in RANGES:
            host[e.name].append((start, end))
        elif e.name in WAITS:
            waits.append((start, end))
    device.sort(key=lambda x: x[1])
    waits.sort()
    return {"device": device, "host": {k: sorted(v) for k, v in host.items()},
            "waits": waits}


def busy_and_gaps(device: list, lo: float, hi: float):
    """The union of the device intervals inside [lo, hi] (us), and the
    gaps between them (start, end), the window's ends included."""
    busy, gaps, last = 0.0, [], lo
    for _, start, end in device:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > last:
            gaps.append((last, start))
        if end > last:
            busy += end - max(start, last)
            last = end
    if hi > last:
        gaps.append((last, hi))
    return busy, gaps


def lost(device: list, launched: dict, lo: float, hi: float) -> dict:
    """``{kernel: (in the trace, launched)}`` for each kernel name in
    ``launched`` whose device intervals inside [lo, hi] do not number its
    launches (a kernel the profiler dropped, or one counted under another
    name); {} where every launch is in the trace."""
    out = {}
    for kern, count in launched.items():
        seen = sum(1 for d in device if d[0] == kern and lo <= d[1] <= hi)
        if seen != count:
            out[kern] = (seen, count)
    return out


def host_time_per_call(calls: list, waits: list) -> list:
    """For each host range in ``calls``: us from its start until the host
    began to wait for the card inside it (its first runtime wait), or
    until it returned where it never waited."""
    starts = [w[0] for w in waits]
    out = []
    for start, end in calls:
        i = bisect.bisect_left(starts, start)
        stop = starts[i] if i < len(starts) and starts[i] < end else end
        out.append(stop - start)
    return out


def innermost(ranges: list, t: float):
    """The name of the shortest (name, start, end) range holding ``t``."""
    best, width = None, None
    for name, start, end in ranges:
        if start <= t <= end and (width is None or end - start < width):
            best, width = name, end - start
    return best


def breakdown(device: list, gaps: list, host_ranges: list) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing in it (the innermost obs span or harness range
    open at each gap's middle), each as [[name, seconds], ...] (at most
    ten, longest first)."""
    by_op = defaultdict(float)
    for name, start, end in device:
        by_op[name] += (end - start) / 1e6
    by_host = defaultdict(float)
    ranges = sorted(host_ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    for start, end in gaps:
        mid = (start + end) / 2
        # ranges that start before the middle; the innermost that holds it
        near = ranges[:bisect.bisect_right(starts, mid)]
        by_host[innermost(near[-64:], mid) or "bench.between_calls"] += \
            (end - start) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
