"""The port's offline oracle (``core/brute_force``) and the DeepDecision
baseline against the reference's.  Float64 Python and numpy on both sides,
in the same order, so every comparison is exact: actions, the exhaustive
search, both grid DPs, and the oracle policy's plans.
"""
from __future__ import annotations

import itertools

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro.core import brute_force as jbf
from repro.core import profiles as jprofiles
from repro.core import registry as jregistry
from repro_torch.core import brute_force as tbf
from repro_torch.core import profiles as tprofiles
from repro_torch.core import registry as tregistry

NETS = [0.5, 2.5, 8.0]
STREAMS = [(30.0, 0.2), (10.0, 0.3), (30.0, 0.1)]


def _pair(fps, deadline, mbps):
    return (
        (jprofiles.PAPER_MODELS, jprofiles.StreamSpec(fps=fps, deadline=deadline), jprofiles.network_mbps(mbps)),
        (tprofiles.PAPER_MODELS, tprofiles.StreamSpec(fps=fps, deadline=deadline), tprofiles.network_mbps(mbps)),
    )


@pytest.mark.parametrize("mbps", NETS)
def test_actions_equal_reference(mbps):
    for fps, deadline in STREAMS:
        j, t = _pair(fps, deadline, mbps)
        assert [vars(a) for a in tbf.enumerate_actions(*t)] == [vars(a) for a in jbf.enumerate_actions(*j)]
        assert [vars(a) for a in tbf._window_actions(*t)] == [vars(a) for a in jbf._window_actions(*j)]


@pytest.mark.parametrize("mbps", NETS)
def test_exhaustive_best_equals_reference(mbps):
    for (fps, deadline), alpha in itertools.product(STREAMS, (None, 150.0)):
        j, t = _pair(fps, deadline, mbps)
        assert tbf.exhaustive_best(*t, 4, alpha=alpha) == jbf.exhaustive_best(*j, 4, alpha=alpha)


@pytest.mark.parametrize("mbps", NETS)
def test_grid_dps_equal_reference(mbps):
    for fps, deadline in STREAMS:
        j, t = _pair(fps, deadline, mbps)
        assert tbf.optimal_accuracy(*t, 12) == jbf.optimal_accuracy(*j, 12)
        assert tbf.optimal_accuracy(*t, 6, grid=1e-3) == jbf.optimal_accuracy(*j, 6, grid=1e-3)
        assert tbf.optimal_utility(*t, 8, alpha=200.0) == jbf.optimal_utility(*j, 8, alpha=200.0)


def _plan_key(plan):
    return (
        tuple((d.frame, d.where.value, d.model, d.resolution, d.start, d.finish) for d in plan.decisions),
        plan.horizon, plan.expected_accuracy_sum, plan.expected_utility,
        plan.npu_busy_until, plan.net_busy_until,
    )


@pytest.mark.parametrize("name,params", [
    ("brute_force", {}),
    ("brute_force", {"alpha": 200.0}),
    ("brute_force", {"window_frames": 4, "grid": 1e-2}),
    ("deepdecision", {}),
    ("deepdecision", {"alpha": 50.0, "window_s": 0.5}),
], ids=str)
def test_oracle_and_deepdecision_plans_equal_reference(name, params):
    jpol = jregistry.PolicySpec(name, params).build()
    tpol = tregistry.PolicySpec(name, params).build()
    for mbps, (fps, deadline), npu_free in itertools.product((0.8, 2.5, 8.0, 30.0), STREAMS, (0.0, 0.04)):
        j, t = _pair(fps, deadline, mbps)
        assert _plan_key(tpol(*t, npu_free=npu_free)) == _plan_key(jpol(*j, npu_free=npu_free)), \
            (mbps, fps, deadline, npu_free)
