"""One run of one cell: set-up, the measured window, the check.

The window is a closed loop with one caller.  Each multiply is timed on
the host clock from the call into the program until the card has
finished it (``torch.cuda.synchronize``); its answer's kind and shape are
then checked on the host, a check for a NaN or an inf in it is queued on
the card (read once the window has closed), and a sample of the answers
is drawn from the seed.  Of each answer drawn the harness holds what the
operation keeps (``keep``: the answer itself, or a lossless record of
it), and takes those bytes out of the peak memory.  Once the window has
closed and the peak memory is read, the program's state is freed and
the sample is held against the plain reference (``bench/reference.py``).

With ``trace`` the program's obs spans are on from the start and a
``torch.profiler`` records the first ``TRACE_SECONDS`` of the window; the
per-layer metrics are read from both, over that part.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import random
import statistics
import time
import traceback
from typing import Callable, Optional

import torch

from bench import devtrace, manifest, work

# a traced run traces the first seconds of its window
TRACE_SECONDS = 10.0
# multiplies before the window, which build and load every kernel the
# window runs
WARMUP = 3
# answers of the window, drawn from the seed, held against the reference
SAMPLES = 3


@dataclasses.dataclass
class Run:
    """What one run saw; the metric readers (``metrics/*.py``) read it."""
    setup_s: float
    window_s: float
    times_ms: list
    host_ms: list
    attempted: int
    failed: int
    peak_bytes: int          # the program's: the sample's bytes left out
    raw_peak: int            # the card's, the sample with it
    work: dict
    spans: list = dataclasses.field(default_factory=list)
    window_us: tuple = (0.0, 0.0)      # the window on the obs spans' clock
    busy_s: Optional[float] = None       # device busy in the traced part
    traced_s: Optional[float] = None     # the traced part's length
    traced_completed: int = 0            # multiplies in the traced part
    trace_lost: dict = dataclasses.field(default_factory=dict)
    breakdown: dict = dataclasses.field(default_factory=dict)

    @property
    def completed(self) -> int:
        return len(self.times_ms)


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()


def _launches() -> dict:
    """Launches so far of B1, by the kernel each ran (its wrapper's
    counters by path): the block path's ``spmm_kernel``, the element
    path's ``spmm_elem_kernel``."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_cuda
    paths = bsr_spmm_cuda.paths
    return {"spmm_kernel": paths["blocks"],
            "spmm_elem_kernel": paths["elements"]}


class _Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from the
    seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, item, hold=None) -> bool:
        """Draw, then, for an item drawn only, keep ``hold(item)`` (the
        item itself without ``hold``); False where ``hold`` refused it
        (gave None), which leaves the sample as it was."""
        self.seen += 1
        if len(self.kept) < self.k:
            j = len(self.kept)
        else:
            j = self.rng.randrange(self.seen)
            if j >= self.k:
                return True
        held = hold(item) if hold else item
        if held is None:
            return False
        if j == len(self.kept):
            self.kept.append(held)
        else:
            self.kept[j] = held
        return True


def _held(op):
    """What the harness holds of a drawn ``(key, answer)``: the key and
    what ``op`` keeps of the answer, or None where ``op`` refuses it."""
    def hold(item):
        key, out = item
        got = op.keep(out, key)
        return None if got is None else (key, got)
    return hold


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _held_bytes(kept: list) -> int:
    """Device bytes the kept records hold: every storage of every tensor
    in them, each storage once."""
    storages = {}
    for t in _tensors(kept):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())


def cell_files(name: str, overrides: Optional[dict] = None):
    """The manifest, and cell ``name``'s configuration and traffic mix as
    their files give them, updated by ``overrides`` (tests: ``"config"``,
    ``"traffic"``)."""
    overrides = overrides or {}
    man = manifest.load()
    cell = manifest.workload(man, name)
    cfg = dict(manifest.config(man, cell), **overrides.get("config", {}))
    mix = dict(manifest.traffic(cell), **overrides.get("traffic", {}))
    return man, cfg, mix


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", overrides: Optional[dict] = None,
             log: Callable = print):
    """Run cell ``name`` once.  Returns the result line's object and the
    compared numbers as ``{name: (value, limit)}``.  ``overrides``: see
    :func:`cell_files`."""
    from repro_torch import obs
    man, cfg, mix = cell_files(name, overrides)
    if trace:
        obs.enable(clear=True)
    try:
        op = manifest.operation(mix["op"]).setup(cfg, mix, seed, device, log)
        if _cuda(device):
            op.diagnose(log)
        for _ in range(WARMUP):
            out, _ = op.call()
            _sync(device)
            op.watch(out)
            del out
        op.nonfinite()
        # set-up's objects leave the collector's generations, so that no
        # full collection walks them inside the window
        gc.collect()
        gc.freeze()
        run, sample = _window(op, seed, seconds, trace, t_start,
                              device, log)
    finally:
        obs.disable()
        gc.unfreeze()
    run.work = op.work()
    least = work.least_time(run.work)
    log(f"needed work of one multiply (from the inputs' nonzeros): "
        f"{run.work['flops']} flops, {run.work['bytes']} bytes, "
        f"{run.work['dtype']}: least time {least['seconds'] * 1e3:.6f} ms "
        f"({least['bound_by']}-bound; flops {least['flops_s'] * 1e3:.6f} "
        f"ms, bytes {least['bytes_s'] * 1e3:.6f} ms at "
        f"{work.HBM_BYTES_PER_S:g} B/s, {work.PEAK_FLOPS[run.work['dtype']]:g}"
        f" flop/s)")
    # the reference runs once the program's state is freed
    op.free_program()
    _free(device)
    compared = op.judge(sample, log)
    del sample
    limits = mix["limits"]
    correct = all(compared[k] <= limits[k] for k in limits) \
        and run.failed == 0 and run.completed > 0
    metrics = {}
    for m in manifest.cell_metrics(man, name, trace):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if _cuda(device) else "cpu",
           "kind": torch.cuda.get_device_name(device) if _cuda(device)
           else "cpu", "count": 1, "memory_peak_bytes": run.raw_peak}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.traced_s
        result["breakdown"] = run.breakdown
    checked = {k: (compared[k], limits[k]) for k in limits}
    checked["failed"] = (run.failed, 0)
    result["compared"] = {k: {"value": v if math.isfinite(v) else repr(v),
                              "limit": lim}
                          for k, (v, lim) in checked.items()}
    return result, checked


class _Tracer:
    """The profiler and the program's obs spans over the first
    ``TRACE_SECONDS`` of a traced run's window (the per-layer metrics'
    part of it; the rest of the window runs as an untraced one)."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch import obs
        self.obs, self.range = obs, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if _cuda(device) else []))
        self.prof.__enter__()
        with record_function(devtrace.ANCHOR):
            obs.instant(devtrace.ANCHOR)
        self.open = True

    def start(self) -> None:
        self.window = self.range(devtrace.WINDOW)
        self.window.__enter__()
        self.obs.instant("bench.window_start")
        self.launches0 = _launches()

    def record(self, name: str):
        return self.range(name) if self.open else contextlib.nullcontext()

    def close(self, completed: int) -> None:
        self.window.__exit__(None, None, None)
        self.obs.instant("bench.window_end")
        self.obs.disable()
        self.completed = completed
        self.launched = {k: v - self.launches0[k]
                         for k, v in _launches().items()}
        self.prof.__exit__(None, None, None)
        self.open = False


def _window(op, seed, seconds, trace, t_start, device, log):
    tracer = _Tracer(device) if trace else None
    record = tracer.record if trace else lambda _: contextlib.nullcontext()
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = _launches()
    keep, hold = _Reservoir(SAMPLES, seed), _held(op)
    times, host, attempted, failed, shown = [], [], 0, 0, False
    if trace:
        tracer.start()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    while time.perf_counter() - t_w0 < seconds:
        if trace and tracer.open \
                and time.perf_counter() - t_w0 >= TRACE_SECONDS:
            tracer.close(len(times))
        attempted += 1
        t0 = time.perf_counter()
        try:
            with record(devtrace.MULTIPLY):
                out, key = op.call()
            t_ret = time.perf_counter()
            with record(devtrace.SYNC):
                _sync(device)
            t1 = time.perf_counter()
        except Exception:          # a multiply that raises has failed
            failed += 1
            if not shown:
                log(traceback.format_exc())
                shown = True
            continue
        times.append((t1 - t0) * 1e3)
        host.append((t_ret - t0) * 1e3)
        if op.valid(out):
            op.watch(out)
            # an answer the operation refuses to keep has failed
            failed += not keep.offer((key, out), hold)
        else:
            failed += 1
        del out
    t_w1 = time.perf_counter()
    if trace and tracer.open:
        tracer.close(len(times))
    # the kept records are the harness's: from the sample's k-th answer on
    # the card holds them all through every multiply
    raw = torch.cuda.max_memory_allocated(device) if _cuda(device) else 0
    held = _held_bytes(keep.kept)
    peak = raw - held if raw else 0
    # an answer that holds a NaN or an inf has failed
    nonfinite = op.nonfinite()
    failed += nonfinite
    launched = {k: v - launches0[k] for k, v in _launches().items()}
    window_s = t_w1 - t_w0
    n = max(1, len(times))
    quarters, hquarters = (
        [round(statistics.fmean(x[len(x) * q // 4:len(x) * (q + 1) // 4]
                                or [0.0]), 4) for q in range(4)]
        for x in (times, host))
    log(f"window: {len(times)} multiplies in {window_s:.3f} s "
        f"({attempted} attempted, {failed} failed); host time to return "
        f"{sum(host) / n:.4f} ms a multiply; mean ms a multiply by quarter "
        f"of the window {quarters} (host {hquarters})"
        f"; launches a multiply "
        f"{ {k: v / n for k, v in launched.items()} }; {nonfinite} answers "
        f"not finite; peak {raw / 1e9:.4f} GB, of it {held / 1e9:.4f} GB "
        f"the kept sample's")
    run = Run(setup_s=setup_s, window_s=window_s,
              times_ms=times, host_ms=host, attempted=attempted,
              failed=failed, peak_bytes=peak, raw_peak=raw, work={})
    if trace:
        t0 = time.perf_counter()
        _read_trace(run, tracer, log)
        log(f"trace read in {time.perf_counter() - t0:.1f} s")
    return run, keep.kept


def _read_trace(run: Run, tracer: _Tracer, log) -> None:
    """Fill ``run``'s trace fields from the profiler and the obs spans."""
    from repro_torch import obs
    got = devtrace.read(tracer.prof)
    run.traced_completed = tracer.completed
    events = obs.events()
    marks = {e["name"]: e["ts"] for e in events if e.get("dur") == 0.0}
    run.spans = [e for e in events if e.get("dur", 0) > 0]
    run.window_us = (marks["bench.window_start"], marks["bench.window_end"])
    lo, hi = got["host"][devtrace.WINDOW][0]
    busy_us, gaps = devtrace.busy_and_gaps(got["device"], lo, hi)
    run.busy_s = busy_us / 1e6
    run.traced_s = (hi - lo) / 1e6
    lost = devtrace.lost(got["device"], tracer.launched, lo, hi)
    if lost:
        whole = not devtrace.too_lost(got["device"], lost, lo, hi, busy_us)
        log(f"the profiler's trace lost kernels (in the trace, launched): "
            f"{lost}; " + ("under a share of the busy time of "
                           f"{devtrace.DROP_SHARE}: read" if whole
                           else "the device metrics go unread"))
        run.trace_lost = {} if whole else lost
    # the host time of each multiply: until it began to wait for the card
    run.host_ms = [us / 1e3 for us in devtrace.host_time_per_call(
        got["host"].get(devtrace.MULTIPLY, []), got["waits"])]
    offset = got["host"][devtrace.ANCHOR][0][0] - marks[devtrace.ANCHOR]
    ranges = [(e["name"], e["ts"] + offset, e["ts"] + e["dur"] + offset)
              for e in run.spans]
    for name in (devtrace.MULTIPLY, devtrace.SYNC):
        ranges += [(name, s, e) for s, e in got["host"].get(name, [])]
    run.breakdown = devtrace.breakdown(
        [d for d in got["device"] if lo <= d[1] <= hi], gaps, ranges)
    log(f"device busy {run.busy_s:.6f} s of the {run.traced_s:.6f} s "
        f"traced window; {len(got['device'])} device events")
