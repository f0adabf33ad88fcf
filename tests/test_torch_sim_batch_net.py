"""The port's network-aware sweep planners (``max_accuracy``,
``max_utility`` in ``core/sim_batch``) against the reference, on the CPU.

Contract (``src/repro/core/sim_batch.py:50-55``): integer stats exact,
``accuracy_sum`` within ``AUDIT_TOL``; the number of points that came out
bit-equal is recorded as a test property.  The grids are the reference's
(tests/test_sim_batch.py): the 100-point golden grid on constant traces and
the piecewise grid with an rtt axis.  Then ``max_utility``'s rerun at the
prune cap: forced on every lane by a fast width of 2, and taken for a 1e-12
utility tie that its fast keep rule cannot settle.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest
from test_torch_sim_batch import BATCHED_PARAMS, INT_FIELDS, PIECEWISE, PIECEWISE_GRID, assert_contract, \
    golden_grid, spec_of, sweeps

from repro.core import profiles as jprofiles
from repro.core import simulator as jsim
from repro.core.registry import PolicySpec as JPolicySpec
from repro_torch.core import profiles as tprofiles
from repro_torch.core import sim_batch as tsim_batch
from repro_torch.core import simulator as tsim
from repro_torch.core.audit import AUDIT_TOL
from repro_torch.core.registry import PolicySpec as TPolicySpec

CPU = "cpu"


@pytest.mark.parametrize("name", ["max_accuracy", "max_utility"])
def test_golden_grid_equals_reference(name, record_property):
    base, axis = BATCHED_PARAMS[name]
    got, ref, loop = sweeps(spec_of(name, base), golden_grid(axis))
    assert len(got.points) == 100
    assert sum(p.stats.frames_offloaded for p in got.points) > 0  # the offload phase is exercised
    record_property("bit_equal_points", (assert_contract(name, got, ref), assert_contract(name, got, loop)))


@pytest.mark.parametrize("name", ["max_accuracy", "max_utility"])
def test_piecewise_grid_equals_reference(name, record_property):
    """Bandwidth steps across segment boundaries mid-stream, an rtt axis
    varies the offload budget, and 10 ms forces the skip path
    (tests/test_sim_batch.py:121-140)."""
    base, _ = BATCHED_PARAMS[name]
    got, ref, loop = sweeps(spec_of(name, base, n_frames=36, trace=PIECEWISE), PIECEWISE_GRID)
    record_property("bit_equal_points", (assert_contract(name, got, ref), assert_contract(name, got, loop)))


def test_fast_width_overflow_reruns_the_lanes_exactly(monkeypatch):
    """A fast width of 2 overflows on every lane: each lane reruns at the
    prune cap, and the spliced results still equal the reference loop."""
    monkeypatch.setattr(tsim_batch, "_UTIL_FAST_WIDTH", 2)
    grid = {"deadline_ms": [200.0, 350.0], "fps": [30.0]}
    got, ref, loop = sweeps(spec_of("max_utility", {"alpha": 200.0}, n_frames=12), grid)
    assert_contract("max_utility", got, loop)
    assert any(p.stats.frames_processed > 0 for p in got.points)
    groups = []
    scens = [tsim_batch.BatchScenario(stream=tprofiles.StreamSpec(fps=30.0, deadline=dl), n_frames=12,
                                      params={"alpha": 200.0}) for dl in (0.2, 0.35)]
    tsim_batch.simulate_batch("max_utility", tprofiles.PAPER_MODELS, scens, device=CPU, groups=groups)
    assert [g["reruns"] for g in groups] == [1, 1, 1, 1]  # each group, then its rerun
    assert [g["lanes"] for g in groups] == [1, 1, 1, 1]


def _tied_models(prof):
    """Utilities 0.6e-12 apart, rising with NPU time: the reference keeps
    entries a running-maximum prune would drop."""
    return [prof.profile_ms(n, t_npu_ms=t, t_server_ms=9.0, acc_server={45: 0.2, 224: 0.6}, acc_npu={224: a})
            for n, t, a in (("a", 20.0, 0.5), ("b", 21.0, 0.5 + 6e-13), ("c", 22.0, 0.5 + 1.2e-12))]


@pytest.mark.parametrize("fps,deadline,n", [(30.0, 0.2, 18), (50.0, 0.35, 24), (10.0, 0.1, 12)])
def test_epsilon_ties_rerun_and_equal_simulate(fps, deadline, n):
    groups = []
    got, = tsim_batch.simulate_batch(
        "max_utility", _tied_models(tprofiles),
        [tsim_batch.BatchScenario(stream=tprofiles.StreamSpec(fps=fps, deadline=deadline), n_frames=n,
                                  params={"alpha": 1.0}, bw_segments=((0.0, 0.2e6),))],
        device=CPU, groups=groups)
    assert groups[0]["reruns"] == 1
    stream = dict(fps=fps, deadline=deadline)
    ref = jsim.simulate(JPolicySpec("max_utility", {"alpha": 1.0}).build(), _tied_models(jprofiles),
                        jprofiles.StreamSpec(**stream), jsim.Trace.constant(0.2), n)
    port = tsim.simulate(TPolicySpec("max_utility", {"alpha": 1.0}).build(device=CPU), _tied_models(tprofiles),
                         tprofiles.StreamSpec(**stream), tsim.Trace.constant(0.2), n)
    for want in (ref, port):
        assert [getattr(got, f) for f in INT_FIELDS] == [getattr(want, f) for f in INT_FIELDS]
        assert abs(got.accuracy_sum - want.accuracy_sum) <= AUDIT_TOL
