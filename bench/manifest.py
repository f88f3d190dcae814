"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
manifest gives, and a traffic mix, ``traffic/<name>.json``; the mix names
its operation, ``ops/<op>.py``; each metric is read by
``metrics/<name>.py``.  A later cell, mix, operation or metric is a new
file and a new entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
OPTIONAL = {"end_to_end": {"workloads"}, "per_layer": {"workloads"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _one_line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def problems(man: dict) -> list:
    """Every way ``man`` departs from the benchmark's contract that can be
    seen without running it (names, units, keys, references); [] if none."""
    out = []
    if set(man) != TOP_KEYS:
        out.append(f"top-level keys {sorted(man)}")
    for section, keys in ENTRY_KEYS.items():
        seen = set()
        for e in man.get(section, []):
            extra = set(e) - keys - OPTIONAL.get(section, set())
            if keys - set(e) or extra:
                out.append(f"{section} entry {e.get('name')}: keys "
                           f"{sorted(e)}")
                continue
            name = e.get("name", "")
            if not NAME.fullmatch(name):
                out.append(f"{section}: bad name {name!r}")
            if name in seen:
                out.append(f"{section}: {name!r} twice")
            seen.add(name)
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                out.append(f"{name}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{name}: better {e['better']!r}")
            if "source" in e and section in ("end_to_end", "per_layer") \
                    and e["source"] not in SOURCES:
                out.append(f"{name}: source {e['source']!r}")
            for key in ("why", "layer"):
                if key in e and not _one_line(e[key]):
                    out.append(f"{name}: {key} not one line of 1-200")
    if out:
        return out
    configs = {c["name"]: c for c in man.get("configs", [])}
    cells = {w["name"]: w for w in man.get("workloads", [])}
    e2e = {m["name"]: m for m in man.get("end_to_end", [])}
    for c in configs.values():
        if not _one_line(c["source"]):
            out.append(f"config {c['name']}: source")
        for key in c["reduced"]:
            if not NAME.fullmatch(key):
                out.append(f"config {c['name']}: reduced key {key!r}")
        if not (ROOT / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
    pairs = set()
    for w in cells.values():
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: no config {w['config']!r}")
        if not NAME.fullmatch(w["traffic"]) \
                or not traffic_path(w["traffic"]).is_file():
            out.append(f"cell {w['name']}: no traffic {w['traffic']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips {w['chips']}")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            out.append(f"cell {w['name']}: {pair} twice")
        pairs.add(pair)
    for m in man.get("end_to_end", []):
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source {m['source']}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in man.get("end_to_end", []) + man.get("per_layer", []):
        if not metric_path(m["name"]).is_file():
            out.append(f"metric {m['name']}: no reader")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {m['name']}: no cell {cell!r}")
    for m in man.get("per_layer", []):
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']!r}")
    return out


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                   f"{[w['name'] for w in man['workloads']]}")


def config(man: dict, cell: dict) -> dict:
    entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def traffic(cell: dict) -> dict:
    with open(traffic_path(cell["traffic"])) as f:
        return json.load(f)


def metric_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def _module(path: Path, prefix: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = f"bench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operation(name: str) -> ModuleType:
    """``ops/<name>.py``: the operation a traffic mix drives."""
    return _module(BENCH / "ops" / f"{name}.py", "op")


def reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: a metric's reader (``read(run)``)."""
    return _module(metric_path(name), "metric")


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a metric with ``workloads`` only
    in the cells listed there)."""
    section = man["per_layer" if trace else "end_to_end"]
    return [m for m in section if cell in m.get("workloads", [cell])]
