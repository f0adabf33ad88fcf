"""``chip_smoke.SWEEP_GOLDENS`` against the reference, and the port's
engine against the table on the CPU.

chip_smoke's sweep phase holds the port's lane-batched engine on the card
against this table, which must be the reference's numbers: its per-point
loop (``run_sweep(backend="reference")``), computed here from ``repro`` on
the CPU.  The port's engine on the CPU meets the same contract (the max_*
policies: integer stats exact, accuracy sums within ``AUDIT_TOL``).
"""
from __future__ import annotations

import sys

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

sys.path.insert(0, str(test_torch_ref.REPO))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402
from chip_smoke import SWEEP_GOLDENS  # noqa: E402

from repro import session as jsession  # noqa: E402
from repro_torch import session as tsession  # noqa: E402
from repro_torch.core.audit import AUDIT_TOL  # noqa: E402


def test_sweep_goldens_equal_reference():
    table = chip_smoke.sweep_table(
        jsession, lambda spec, grid: jsession.Session(spec).run_sweep(grid, backend="reference"))
    assert table == SWEEP_GOLDENS
    assert len(table) == 8 and sum(map(len, table.values())) == 6 * 20 + 2 * 6


def test_port_engine_meets_the_goldens_on_the_cpu():
    table = chip_smoke.sweep_table(
        tsession, lambda spec, grid: tsession.Session(spec, device="cpu").run_sweep(grid, backend="batched"))
    assert table.keys() == SWEEP_GOLDENS.keys()
    for name, rows in table.items():
        assert chip_smoke.sweep_agree(name, rows, SWEEP_GOLDENS[name], AUDIT_TOL), name


def test_golden_cases_cover_the_skip_path_offloads_and_tracking():
    rows = [r for name, rs in SWEEP_GOLDENS.items() for r in rs]
    assert any(r[1] == 0 and r[4] == r[0] for r in rows)  # 10 ms: every round a horizon-1 skip
    assert any(r[3] > 0 for name, rs in SWEEP_GOLDENS.items() if name.startswith("max_") for r in rs)
    assert any(r[3] > 0 for name, rs in SWEEP_GOLDENS.items() if name.startswith("track_") for r in rs)
