"""The port's fleet engine for the local-only planners (``jax_accuracy``,
``jax_utility``: one lane per scenario, the single-stream round plus the
scheduler's grant and denial counters, copied to every client) against the
reference's fleet engine and the port's own per-point run_multi loop, on
the CPU, over the sub-grids ``chip_smoke.fleet_cases`` names."""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from test_torch_fleet_goldens import CASES, hold_case


@pytest.mark.parametrize("policy", ["jax_accuracy", "jax_utility"])
@pytest.mark.parametrize("case", CASES)
def test_fleet_grid_matches_reference(policy, case):
    hold_case(f"{policy}/{case}")
