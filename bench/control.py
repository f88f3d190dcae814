"""Readings for the limits of ``correct``: the program's number on many
seeds, and the control's (the plain reference computed in the precision
below the cell's, put in the program's place) on a few, at the cell's own
size, in one process; optionally each planted fault's (``faults.py``).

    python3 bench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults 1] [--multiplies 8]

Each seed sets the cell up as a run does, makes ``--multiplies``
multiplies through the same call, keeps as many answers as a run's check
compares (drawn from the seed) and judges them; the control is judged on
the same inputs.  One JSON line a reading; the benchmark's runs do not run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def reading(workload: str, seed: int, multiplies: int, control: bool,
            device="cuda", overrides=None, log=print) -> dict:
    """The program's number for ``seed`` (and, with ``control``, the
    control's) as a run of ``workload`` judges it."""
    import torch

    from bench import harness, manifest
    from repro_torch.core import api
    _, cfg, mix = harness.cell_files(workload, overrides)
    api.clear_plan_cache()
    op = manifest.operation(mix["op"]).setup(cfg, mix, seed, device, log)
    keep = harness._Reservoir(harness.SAMPLES, seed)
    failed = 0
    for _ in range(max(multiplies, harness.SAMPLES)):
        out, key = op.call()
        if op.valid(out):
            failed += not keep.offer((key, out), harness._held(op))
        else:
            failed += 1
        del out
    sample = keep.kept
    ctrl = op.control(sample, mix["control"]) if control else None
    op.free_program()
    harness._free(device)
    got = {"seed": seed, "failed": failed,
           "program": op.judge(sample, log)}
    del sample
    if control:
        got["control"] = op.judge(ctrl, log)
        got["control_precision"] = mix["control"]
    del op
    harness._free(device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--multiplies", type=int, default=8)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from bench import faults
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    for seed in seeds:
        t0 = time.perf_counter()
        got = reading(args.workload, seed, args.multiplies, seed in ctrl,
                      log=log)
        got["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, **got}), flush=True)
    if args.faults:
        for name, plant in faults.FAULTS.items():
            for seed in sorted(ctrl)[:3] or seeds[:3]:
                with plant():
                    got = reading(args.workload, seed, args.multiplies,
                                  False, log=log)
                print(json.dumps({"workload": args.workload, "fault": name,
                                  **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
