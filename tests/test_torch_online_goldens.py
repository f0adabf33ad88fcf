"""``chip_smoke.ONLINE_GOLDENS`` against the reference, and the port's online
engine against the table on the CPU.

chip_smoke's online phase holds the port's lane-batched online engine on
the card against this table, which must be the reference's numbers: its
per-point ``run_online`` loop (``run_sweep(mode="online",
backend="reference")``), computed here from ``repro`` on the CPU.  The
port's engine on the CPU meets the same contract (integer stats and rounds
exact, accuracy sums within ``AUDIT_TOL``, ``estimated_bps`` bit for bit).
"""
from __future__ import annotations

import sys

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

sys.path.insert(0, str(test_torch_ref.REPO))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402
from chip_smoke import ONLINE_GOLDENS  # noqa: E402

from repro import scenariogen as jscenariogen  # noqa: E402
from repro import session as jsession  # noqa: E402
from repro_torch import scenariogen as tscenariogen  # noqa: E402
from repro_torch import session as tsession  # noqa: E402
from repro_torch.core.audit import AUDIT_TOL  # noqa: E402


def test_online_goldens_equal_reference():
    table = chip_smoke.online_table(
        jsession, jscenariogen,
        lambda spec, grid: jsession.Session(spec).run_sweep(grid, backend="reference", mode="online"))
    assert table == ONLINE_GOLDENS
    assert len(table) == 7 and sum(map(len, table.values())) == 2 * (2 + 2 + 12) + 1


def test_port_engine_meets_the_goldens_on_the_cpu():
    table = chip_smoke.online_table(
        tsession, tscenariogen,
        lambda spec, grid: tsession.Session(spec, device="cpu").run_sweep(grid, backend="batched", mode="online"))
    assert table.keys() == ONLINE_GOLDENS.keys()
    for name, rows in table.items():
        assert chip_smoke.online_agree(rows, ONLINE_GOLDENS[name], AUDIT_TOL), name


def test_golden_cases_cover_offloads_misses_and_the_dead_link():
    rows = [r for rs in ONLINE_GOLDENS.values() for r in rs]
    assert all(r[4] == r[6] for r in rows)  # planner calls == rounds
    assert any(r[3] > 0 and r[2] > 0 for r in rows)  # offloads, and misses the belief caused
    assert any(r[7] < 3.5e6 * 0.9 for r in rows)  # beliefs that learned the collapse
    (dead,) = ONLINE_GOLDENS["max_accuracy/dead"]
    assert dead[3] == dead[2] == 0 and dead[7] == 0.0
