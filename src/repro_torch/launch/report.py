"""Render the dry run's tables from its JSON cache.

Port of ``repro/launch/report.py``.  The records are the port's dry run's
(``launch/dryrun.py``): predictions of the port's program for a pod of
H100 ranks (``"fsdp_tp"``, every record says so) from the card's
data-sheet constants (``core/roofline.py``), not measurements.

  PYTHONPATH=src python -m repro_torch.launch.report --dir results/torch_dryrun
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from typing import Dict, List

from ..core.roofline import H100_SXM_HBM_BYTES, H100_SXM_PEAK_OPS

# H100 80GB HBM3, 700 W (data sheet): bf16 tensor-core peak, device memory
PEAK_FLOPS = H100_SXM_PEAK_OPS["bfloat16"]
HBM_GB = H100_SXM_HBM_BYTES / 1e9

__all__ = ["load", "dryrun_table", "roofline_table", "worst_cells",
           "reanalyze", "compare", "main"]


def load(dir_: str) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}"


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | compile_s | args GiB/chip | "
        "temp GiB/chip | HLO flops/chip | collective counts |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | - | - "
                f"| - | - | {r['reason'][:60]} |")
            continue
        mem = r.get("memory_analysis", {})
        cc = r.get("hlo_stats", {}).get("collective_count", {})
        cc_s = " ".join(f"{k.split('-')[-1]}:{v}" for k, v in cc.items()
                        if v) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r['compile_seconds']} "
            f"| {fmt_bytes(mem.get('argument_size_in_bytes'))} "
            f"| {fmt_bytes(mem.get('temp_size_in_bytes'))} "
            f"| {r['hlo_stats']['dot_flops']:.3e} | {cc_s} |")
    return "\n".join(lines)


def roofline_table(recs: List[Dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck "
        "| model_flops | useful/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        dom = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        # roofline fraction: ideal-compute time / dominant achieved term
        ideal = rf["model_flops"] / r["n_chips"] / PEAK_FLOPS
        frac = ideal / dom if dom else 0.0
        ur = rf.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3e} "
            f"| {rf['memory_s']:.3e} | {rf['collective_s']:.3e} "
            f"| {rf['bottleneck'].replace('_s', '')} "
            f"| {rf['model_flops']:.3e} "
            f"| {ur if ur is None else round(ur, 3)} "
            f"| {frac:.4f} |")
    return "\n".join(lines)


def worst_cells(recs: List[Dict], mesh: str = "single", n: int = 5):
    rows = []
    for r in recs:
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        dom = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        ideal = rf["model_flops"] / r["n_chips"] / PEAK_FLOPS
        rows.append((ideal / dom if dom else 0.0, r["arch"], r["shape"],
                     rf["bottleneck"]))
    rows.sort()
    return rows[:n]


def fits_table(recs: List[Dict]) -> str:
    """Each cell's predicted peak a rank (arguments + temp, GB) on the
    single / multi-pod mesh, ``*`` where it exceeds the card's 80 GB,
    ``skip`` where the cell does not apply, ``-`` where there is no
    record: an arch a row (with the program its records ran), a shape a
    column."""
    shapes = list(dict.fromkeys(r["shape"] for r in recs))
    cells = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}

    def cell(arch, shape, mesh):
        r = cells.get((arch, shape, mesh))
        if r is None or r["status"] == "error":
            return "-"
        if r["status"] == "skipped":
            return "skip"
        return f"{r['peak_bytes'] / 1e9:.1f}" + ("" if r["fits"] else "*")

    lines = ["| arch | program | " + " | ".join(shapes) + " |",
             "|---|---|" + "---|" * len(shapes)]
    for arch in dict.fromkeys(r["arch"] for r in recs):
        program = " / ".join(dict.fromkeys(
            r.get("program", "-") for r in recs if r["arch"] == arch))
        lines.append(f"| {arch} | {program} | " + " | ".join(
            f"{cell(arch, sh, 'single')} / {cell(arch, sh, 'multi')}"
            for sh in shapes) + " |")
    return "\n".join(lines)


def reanalyze(dir_: str) -> None:
    """Recompute hlo_stats/roofline in every JSON from the cached op stream
    (``.ops.json.gz``, after analyzer changes) without tracing again."""
    from . import op_analysis
    from .dryrun import _ops_path, _stats_record, roofline_terms

    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        ops_path = _ops_path(path)
        if rec.get("status") != "ok" or not os.path.exists(ops_path):
            continue
        with gzip.open(ops_path, "rt") as f:
            stats = op_analysis.stats_of(json.load(f))
        rec["hlo_stats"] = _stats_record(stats)
        rec["roofline"] = roofline_terms(stats, rec["n_chips"],
                                         rec["roofline"]["model_flops"])
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=float)
        print(f"reanalyzed {os.path.basename(path)}")


def compare(baseline_dir: str, dir_: str, mesh: str = "single") -> str:
    """Markdown diff of dominant roofline terms: the baseline records
    (``<baseline_dir>/baseline_*__<mesh>.json``) against ``dir_``'s."""
    base = {}
    for path in sorted(glob.glob(os.path.join(baseline_dir,
                                              "baseline_*__%s.json" % mesh))):
        with open(path) as f:
            r = json.load(f)
        base[(r["arch"], r["shape"])] = r
    lines = ["| cell | baseline dominant | optimized dominant | speedup |",
             "|---|---|---|---|"]
    for (arch, shape), rb in sorted(base.items()):
        cur_path = os.path.join(dir_, f"{arch}__{shape}__{mesh}.json")
        if not os.path.exists(cur_path):
            continue
        with open(cur_path) as f:
            rc = json.load(f)
        tb = rb["roofline"]
        tc = rc["roofline"]
        db = max(tb["compute_s"], tb["memory_s"], tb["collective_s"])
        dc = max(tc["compute_s"], tc["memory_s"], tc["collective_s"])
        lines.append(
            f"| {arch} {shape} | {db:.3e} ({tb['bottleneck'][:-2]}) "
            f"| {dc:.3e} ({tc['bottleneck'][:-2]}) | {db / dc:.1f}x |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="results/torch_dryrun")
    p.add_argument("--mesh", default="single")
    p.add_argument("--baseline-dir", default="results")
    p.add_argument("--reanalyze", action="store_true")
    p.add_argument("--compare", action="store_true")
    args = p.parse_args(argv)
    if args.compare:
        print(compare(args.baseline_dir, args.dir, args.mesh))
        return
    if args.reanalyze:
        reanalyze(args.dir)
        return
    recs = load(args.dir)
    print("## Dry-run (predictions for H100 ranks from data-sheet "
          "constants)\n")
    print(dryrun_table(recs))
    print(f"\n## Peak GB a rank, single / multi pod (* over {HBM_GB:.0f} GB)"
          "\n")
    print(fits_table(recs))
    print("\n## Roofline (single-pod 16x16 = 256 H100 ranks)\n")
    print(roofline_table(recs, "single"))
    print("\n### Worst roofline fractions (hillclimb candidates)\n")
    for frac, arch, shape, bn in worst_cells(recs):
        print(f"- {arch} {shape}: {frac:.4f} ({bn})")


if __name__ == "__main__":
    main()
