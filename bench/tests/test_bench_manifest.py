"""BENCHMARK.json against the contract, and every file it names found."""
import json

import pytest

from bench import manifest


def test_manifest_has_no_problems():
    assert manifest.problems(manifest.load()) == []


@pytest.mark.parametrize("bad", [{"run_seconds": 10},
                                 {"end_to_end": [{"name": "x y"}]}])
def test_problems_seen(bad):
    man = dict(manifest.load(), **bad)
    if "run_seconds" in bad:
        man["extra"] = 1
    assert manifest.problems(man)


@pytest.mark.parametrize("name, ok", [("multiply_ms", True), ("a.b-c_1", True),
                                      ("1x", True), ("with space", False),
                                      ("a/b", False), ("a,b", False),
                                      ("-lead", False), ("x" * 65, False),
                                      ("µs", False)])
def test_name_characters(name, ok):
    assert bool(manifest.NAME.fullmatch(name)) == ok


@pytest.mark.parametrize("unit, ok", [("ms", True), ("%", True),
                                      ("tokens/s", True), ("us", True),
                                      ("tokens per s", False),
                                      ("x" * 17, False), ("µs", False)])
def test_unit_characters(unit, ok):
    assert bool(manifest.UNIT.fullmatch(unit)) == ok


def test_every_name_and_unit_allowed():
    man = manifest.load()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[section]:
            assert manifest.NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert manifest.UNIT.fullmatch(e["unit"]), e["unit"]
    for w in man["workloads"]:
        assert manifest.NAME.fullmatch(w["traffic"])
        assert manifest.NAME.fullmatch(w["config"])
    for c in man["configs"]:
        for key in c["reduced"]:
            assert manifest.NAME.fullmatch(key)


def test_files_found_by_name():
    man = manifest.load()
    for w in man["workloads"]:
        cfg = manifest.config(man, w)
        mix = manifest.traffic(w)
        op = manifest.operation(mix["op"])
        assert callable(op.setup)
        assert set(mix["limits"]) and mix["control"] in ("tf32", "fp8")
        assert cfg["name"] == w["config"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_config_files_hold_reduced_keys():
    man = manifest.load()
    for c in man["configs"]:
        with open(manifest.ROOT / c["file"]) as f:
            cfg = json.load(f)
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced_because"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_cell_metrics(cell):
    """Every cell reports the end-to-end metrics and, traced, the nine
    per-layer ones that each SpMM cell reads alike; the host-bound w128
    cell reports its tail per layer (``call_p95_ms``), not end to end."""
    man = manifest.load()
    host_bound = cell == "spmm-rmat16-f32-w128"
    e2e = manifest.cell_metrics(man, cell, trace=False)
    assert [m["name"] for m in e2e] == (
        ["setup_s", "multiply_ms", "peak_gb"] if host_bound else
        ["setup_s", "multiply_ms", "multiply_p95_ms", "peak_gb"])
    per = manifest.cell_metrics(man, cell, trace=True)
    assert {m["name"] for m in per} == {
        "plan_cold_s", "plan_lookup_us", "host_ms", "kernel_roofline",
        "idle_share", "multiply_mfu", "launch_lead_us", "b1_device_ms",
        "epilogue_device_ms"} | ({"call_p95_ms"} if host_bound else set())
    names = {m["name"] for m in e2e}
    assert all(m["moves"] in names for m in per)
    assert manifest.cell_metrics(man, "no-such-cell", trace=True) == []


def test_bs16_cell_is_the_w512_cell_at_block_size_16():
    """The bs 16 cell resolves to its own configuration: rmat16-spmm's
    graph and grid at block size 16, under the w512 cell's traffic."""
    man = manifest.load()
    cell = manifest.workload(man, "spmm-rmat16-f32-w512-bs16")
    w512 = manifest.workload(man, "spmm-rmat16-f32-w512")
    cfg, base = manifest.config(man, cell), manifest.config(man, w512)
    assert cfg["block_size"] == 16 and base["block_size"] == 128
    assert {k for k in cfg.keys() | base.keys()
            if cfg.get(k) != base.get(k)} == {"name", "source",
                                               "block_size", "assumed"}
    assert manifest.traffic(cell) == manifest.traffic(w512)
    assert cell["chips"] == 1


def test_unknown_workload():
    with pytest.raises(KeyError):
        manifest.workload(manifest.load(), "no-such-cell")
