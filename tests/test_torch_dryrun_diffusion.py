"""The port's dry run (``launch/dryrun``) of the diffusion cells against the
reference's, on the CPU: DiT-XL/2 and Flux-dev at train_256, gen_1024,
gen_fast and train_1024, SMOKE configs at the published shapes, traced on
``meta`` (the rules and bands in ``test_torch_analysis.py``); the work units
behind MODEL_FLOPS at the full configs; and chip_smoke's dryrun phase,
rehearsed on those SMOKE records with made-up card readings."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
from test_torch_analysis import check_dot_flops, check_flash_bytes, check_totals, check_work_units, family_cells
from test_torch_analysis import port_cell, reference_work_units

from repro_torch.launch import dryrun

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

FAMILIES = ("dit", "flux")
CELLS = family_cells(FAMILIES)


@pytest.fixture(scope="module")
def ref_units():
    return reference_work_units(FAMILIES)


def test_cells_cover_the_family():
    assert len(CELLS) == 8


@pytest.mark.parametrize("name,shape", CELLS)
def test_dot_flops_equal_reference(name, shape):
    check_dot_flops(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_totals_beside_reference(name, shape):
    check_totals(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_flash_accounting_lowers_bytes(name, shape):
    check_flash_bytes(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_work_units_equal_reference(ref_units, name, shape):
    check_work_units(ref_units, name, shape)


BESIDE = 1 << 30  # bytes an earlier phase leaves resident beside the step's arguments


def _readings(scale_ms: float, scale_peak: float) -> dict:
    """Made-up card readings of chip_smoke's DRYRUN_CELLS at SMOKE size: ms a
    step ``scale_ms`` times the roofline bound, the step's own peak
    ``scale_peak`` times the estimate, with BESIDE bytes resident beside."""
    out = {}
    for name, shape in chip_smoke.DRYRUN_CELLS:
        rec = port_cell(name, shape, False)
        key = "flash_peak_bytes" if rec["kind"] == "denoise_step" else "peak_bytes"
        args = rec["memory"]["argument_bytes"]
        out[(name, shape)] = {"ms": scale_ms * rec["roofline"]["step_s_lower_bound"] * 1e3,
                              "memory": {"peak_bytes": rec["memory"][key] * scale_peak + BESIDE,
                                         "resident_bytes": args + BESIDE, "argument_bytes": args}}
    return out


@pytest.mark.parametrize("scale_ms,scale_peak,passes", [(3.0, 1.1, True), (3.0, 0.9, True), (0.9, 1.0, False),
                                                         (3.0, 1.3, False), (3.0, 0.75, False)])
def test_chip_smoke_dryrun_phase(monkeypatch, scale_ms, scale_peak, passes):
    """chip_smoke's dryrun phase rehearsed at the SMOKE configs: it passes
    readings at or above the bound and within DRYRUN_PEAK_RTOL of the
    estimate, and fails a step faster than its bound or a peak off by more."""
    readings = _readings(scale_ms, scale_peak)
    monkeypatch.setattr(dryrun, "run_cell", lambda name, shape, out_dir: port_cell(name, shape, False))
    if passes:
        report = chip_smoke.phase_dryrun(dryrun, readings, "card")
        assert set(report) == set(chip_smoke.DRYRUN_CELLS)
        assert all(r["ratio"] == pytest.approx(scale_ms) for r in report.values())
        assert all(r["rel"] == pytest.approx(1 / scale_peak - 1) for r in report.values())
    else:
        with pytest.raises(RuntimeError, match="chip_smoke check failed: dryrun"):
            chip_smoke.phase_dryrun(dryrun, readings, "card")
    with pytest.raises(RuntimeError, match="not measured"):
        chip_smoke.phase_dryrun(dryrun, dict(list(readings.items())[1:]), "card")
