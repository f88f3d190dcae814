"""The whole run, its look for a card skipped, on the CPU at a small size:
``correct`` true as it stands, false with each fault planted underneath
the timed path, and the control read against the limit."""
import time

import pytest

from bench import control, faults, harness, manifest
from bench.tests.conftest import SMALL

CELLS = sorted(SMALL)


def _run(cell: str, seed: int = 2 ** 31 + 11, trace: bool = False):
    return harness.run_cell(cell, seed, 0.3, trace,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=SMALL[cell], log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, compared = _run(cell)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    names = {m["name"] for m in manifest.cell_metrics(manifest.load(), cell,
                                                      trace=False)}
    assert names - {"peak_gb"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["spmm-rmat16-f32-w512",
                                  "spmm-rmat17-bf16-w512",
                                  "spmm-rmat16-f32-w512-bs16"])
def test_fault_makes_the_run_incorrect(cell, fault):
    with faults.FAULTS[fault]():
        result, compared = _run(cell)
    assert not result["correct"], compared
    assert compared["err_share"][0] > compared["err_share"][1]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    """The reference in the precision below the cell's, in the program's
    place, reads above the limit on three seeds; the program below it."""
    limit = manifest.traffic(manifest.workload(manifest.load(), cell))[
        "limits"]["err_share"]
    for seed in (1, 2, 3):
        got = control.reading(cell, seed, 4, True, device="cpu",
                              overrides=SMALL[cell], log=lambda *a: None)
        assert got["program"]["err_share"] <= limit < \
            got["control"]["err_share"], got


@pytest.mark.parametrize("every", [1, 7])
def test_non_finite_answer_fails(monkeypatch, every):
    """Every answer in the window that holds a NaN counts as failed, also
    where the sample kept for the check holds none of them."""
    from repro_torch.core.api import MatmulPlan
    old = MatmulPlan._epilogue
    calls = []

    def nan(self, *a, **kw):
        out = old(self, *a, **kw)
        calls.append(1)
        if len(calls) % every == 0:
            out.view(-1)[-1] = float("nan")
        return out
    monkeypatch.setattr(MatmulPlan, "_epilogue", nan)
    result, compared = _run("spmm-rmat16-f32-w512")
    assert not result["correct"]
    # one epilogue a multiply: the window's are those after the warm-up
    window = (result["attempted"] + harness.WARMUP) // every \
        - harness.WARMUP // every
    assert result["failed"] == window > 1


def test_the_samples_bytes_are_counted_once():
    import torch
    a, b = torch.zeros(10), torch.zeros(4, dtype=torch.float64)
    kept = [(0, a), (1, b), (2, a), (3, a[2:])]
    assert harness._held_bytes(kept) == 40 + 32
