"""The port's fleet engine for ``max_accuracy`` against the reference's fleet engine
and the port's own per-point run_multi loop, on the CPU, over the
sub-grids of tests/test_sim_multi_batch.py that ``chip_smoke.fleet_cases``
names (all three allocations, a piecewise shared link, capacity 0, a
backlog-gated starved link, weights and priority tiers)."""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from test_torch_fleet_goldens import CASES, hold_case


@pytest.mark.parametrize("case", CASES)
def test_fleet_grid_matches_reference(case):
    hold_case(f"max_accuracy/{case}")
