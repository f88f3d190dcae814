"""``repro_torch.launch.report`` against the JAX package's
``repro.launch.report``: on a directory of the port's dry-run records
(smoke cells traced here), the tables and the worst cells are the strings
JAX's report renders from the same records, its ``PEAK_FLOPS`` patched to
the port's (the H100's); ``compare`` and ``reanalyze`` each get a case."""
import json
import os
import shutil

import pytest

from repro.launch import report as jreport
from repro_torch.configs import Shape, get_config
from repro_torch.launch import dryrun, report

CELLS = (
    ("qwen2.5-3b", Shape("train_small", "train", 16, 4), "single", (2, 2)),
    ("mamba2-130m", Shape("decode_small", "decode", 32, 4), "single",
     (1, 2)),
    ("olmoe-1b-7b", Shape("prefill_small", "prefill", 16, 4), "multi",
     (1, 2, 2)),
)


@pytest.fixture(scope="module")
def recdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dryrun")
    for arch, shape, mesh, dims in CELLS:
        out = str(d / f"{arch}__{shape.name}__{mesh}.json")
        rec = dryrun.run_cell(arch, shape.name, mesh, out, verbose=False,
                              cfg=get_config(arch, smoke=True), shape=shape,
                              mesh_shape=dims)
        assert rec["status"] == "ok", rec.get("traceback")
    dryrun.run_cell("llama3-8b", "long_500k", "single",
                    str(d / "llama3-8b__long_500k__single.json"),
                    verbose=False)
    return d


@pytest.fixture
def jax_peak(monkeypatch):
    monkeypatch.setattr(jreport, "PEAK_FLOPS", report.PEAK_FLOPS)


def test_constants_are_the_h100s():
    assert report.PEAK_FLOPS == 989e12
    assert report.HBM_GB == 80.0


def test_dryrun_table_equals_jax(recdir, jax_peak):
    got = report.dryrun_table(report.load(str(recdir)))
    assert got == jreport.dryrun_table(jreport.load(str(recdir)))
    assert "SKIP" in got and got.count("| ok |") == len(CELLS)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_table_equals_jax(recdir, jax_peak, mesh):
    got = report.roofline_table(report.load(str(recdir)), mesh)
    assert got == jreport.roofline_table(jreport.load(str(recdir)), mesh)
    assert got.count("\n") == 1 + sum(c[2] == mesh for c in CELLS)


def test_worst_cells_equal_jax(recdir, jax_peak):
    got = report.worst_cells(report.load(str(recdir)), "single", n=5)
    assert got == jreport.worst_cells(jreport.load(str(recdir)), "single",
                                      n=5)
    assert sorted(a for _, a, _, _ in got) == ["mamba2-130m", "qwen2.5-3b"]


def test_compare_against_a_baseline(recdir, tmp_path):
    """A baseline whose dominant term is twice the current one reads as
    a 2.0x speedup."""
    src = recdir / "qwen2.5-3b__train_small__single.json"
    rec = json.load(open(src))
    for k in ("compute_s", "memory_s", "collective_s"):
        rec["roofline"][k] *= 2
    base = tmp_path / "base"
    base.mkdir()
    with open(base / "baseline_qwen2.5-3b__single.json", "w") as f:
        json.dump(rec, f)
    got = report.compare(str(base), str(recdir), "single")
    lines = got.splitlines()
    assert len(lines) == 3
    assert lines[2].startswith("| qwen2.5-3b train_small |")
    assert lines[2].endswith("| 2.0x |")


def test_reanalyze_recomputes_from_the_op_stream(recdir, tmp_path):
    d = tmp_path / "re"
    shutil.copytree(recdir, d)
    path = d / "qwen2.5-3b__train_small__single.json"
    want = json.load(open(path))
    assert os.path.exists(dryrun._ops_path(str(path)))
    broken = dict(want, hlo_stats={}, roofline=dict(
        want["roofline"], compute_s=0.0, bottleneck="none"))
    with open(path, "w") as f:
        json.dump(broken, f)
    report.reanalyze(str(d))
    got = json.load(open(path))
    assert got["hlo_stats"] == want["hlo_stats"]
    assert got["roofline"] == want["roofline"]


def test_main_prints_the_tables(recdir, capsys):
    report.main(["--dir", str(recdir)])
    out = capsys.readouterr().out
    assert "## Roofline (single-pod 16x16 = 256 H100 ranks)" in out
    assert "Peak GB a rank, single / multi pod (* over 80 GB)" in out
    assert "| qwen2.5-3b | train_small | single |" in out


def test_fits_table_marks_the_cells_over_80_gb(recdir):
    recs = report.load(str(recdir))
    rows = report.fits_table(recs).splitlines()
    assert rows[0].startswith("| arch | ")
    olmoe = next(r for r in rows if r.startswith("| olmoe-1b-7b |"))
    assert " - / " in olmoe                   # no single-pod record
    llama = next(r for r in rows if r.startswith("| llama3-8b |"))
    assert "skip / -" in llama
    ok = next(r for r in recs if r["status"] == "ok")
    big = dict(ok, peak_bytes=81e9, fits=False)
    assert "81.0*" in report.fits_table([big])
