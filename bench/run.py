"""Run one cell of the port's benchmark once, on one card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints diagnostics, then, as the last line
of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
its last key, ``compared``, and the last lines of standard error give
each number held against the reference beside its limit.  Exits non-zero
and prints no result without a CUDA card, or with JAX (or the JAX
package, or its ``benchmarks``) loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``bench``) and its ``src`` (the program), in
# place of this file's directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# caches of the program's tool chain stay inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "_bench_cache" / sub)
# one host thread for the CPU's math: the host's share of a multiply sets
# much of its time, and idle pool threads spinning on a shared host make
# that share swing from run to run
os.environ["OMP_NUM_THREADS"] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or its benchmarks' (names compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    from bench import harness, manifest
    cell = manifest.workload(manifest.load(), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    log = lambda *a: print(*a, flush=True)   # noqa: E731
    log(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; cell {args.workload}, seed {args.seed}, "
        f"{args.seconds} s, trace {args.trace}")
    result, compared = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START, device="cuda", log=log)
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, (value, limit) in compared.items():
        print(f"compared {name}: {value!r} (limit {limit!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
