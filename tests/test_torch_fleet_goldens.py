"""``chip_smoke.FLEET_GOLDENS`` against the reference, and the port's fleet
engine against the table on the CPU.

chip_smoke's fleet phase holds the port's lane-batched fleet engine on the
card against this table, which must be the reference's numbers: its
per-point ``run_multi`` loop (``run_sweep(backend="reference")``) on the
sub-grids of ``tests/test_sim_multi_batch.py`` that ``chip_smoke.
fleet_cases`` names, computed here from ``repro`` on the CPU.  The port's
engine on the CPU meets the same contract: bit-equal with equal weights,
and under weights and priorities integer stats, server jobs, grants and
denials exact with accuracy sums and server utilization within
``MULTI_TOL``.
"""
from __future__ import annotations

import sys

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

sys.path.insert(0, str(test_torch_ref.REPO))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402
from chip_smoke import FLEET_GOLDENS  # noqa: E402

from repro import session as jsession  # noqa: E402
from repro_torch import session as tsession  # noqa: E402
from repro_torch.core.sim_multi_batch import MULTI_TOL, multi_batched_policies  # noqa: E402

CASES = ("small", "planner", "piecewise", "capacity", "backlog", "weights")


def hold_case(name: str) -> None:
    """``chip_smoke.fleet_cases()[name]`` through the port's fleet engine on
    the CPU, held against the reference's fleet engine (npu_busy_s
    included, which only the batched engines fill) and against the port's
    own per-point run_multi loop, under the reference's contract; the shape
    groups show one host read per round plus one per group."""
    spec, grid = chip_smoke.fleet_cases()[name]
    ref = jsession.Session(jsession.ScenarioSpec.from_json(spec)).run_sweep(
        jsession.SweepGrid.from_json(grid), backend="batched")
    session = tsession.Session(tsession.ScenarioSpec.from_json(spec), device="cpu")
    got = session.run_sweep(tsession.SweepGrid.from_json(grid), backend="batched")
    loop = session.run_sweep(tsession.SweepGrid.from_json(grid), backend="reference")
    assert got.meta["engine"] == ref.meta["engine"] == "sim_multi_batch" and loop.backend == "reference"
    assert chip_smoke.fleet_agree(name, chip_smoke.fleet_rows(got), chip_smoke.fleet_rows(ref), MULTI_TOL)
    assert chip_smoke.fleet_agree(name, chip_smoke.fleet_rows(got), chip_smoke.fleet_rows(loop), MULTI_TOL)
    npu = [[s.npu_busy_s for s in p.streams] for p in got.points]
    assert npu == [[s.npu_busy_s for s in p.streams] for p in ref.points]
    assert [p.meta["allocation"] for p in got.points] == [p.meta["allocation"] for p in ref.points]
    assert all(g["host_reads"] == g["rounds"] + 1 for g in got.meta["groups"])


def test_fleet_goldens_equal_reference():
    table = chip_smoke.fleet_table(
        jsession, lambda spec, grid: jsession.Session(spec).run_sweep(grid, backend="reference"))
    assert table == FLEET_GOLDENS
    assert len(table) == 6 * 7 and sum(map(len, table.values())) == 18 * 7


def test_port_engine_meets_the_goldens_on_the_cpu():
    def run(spec, grid):
        report = tsession.Session(spec, device="cpu").run_sweep(grid, backend="batched")
        assert report.meta["engine"] == "sim_multi_batch"
        return report

    table = chip_smoke.fleet_table(tsession, run)
    assert table.keys() == FLEET_GOLDENS.keys()
    for name, rows in table.items():
        assert chip_smoke.fleet_agree(name, rows, FLEET_GOLDENS[name], MULTI_TOL), name
        assert rows == FLEET_GOLDENS[name], name  # bit-equal here, weights included


def test_golden_cases_cover_every_planner_and_the_contention():
    assert {name.split("/")[0] for name in FLEET_GOLDENS} == set(multi_batched_policies())
    rows = [r for rs in FLEET_GOLDENS.values() for r in rs]
    assert any(r[-4] > 0 for r in rows)  # server jobs
    assert any(r[-1] > 0 for r in rows) and any(r[-2] > 0 for r in rows)  # denials and grants
    assert any(c[2] > 0 for r in rows for c in r[:-4])  # completion-audit misses
    # capacity 0 denies every lease under weighted_fair (fifo grants all)
    wf = [rs[0] for name, rs in FLEET_GOLDENS.items() if name.endswith("/capacity")]
    assert all(r[-4] == 0 and r[-2] == 0 and r[-1] > 0 for r in wf)
