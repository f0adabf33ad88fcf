"""The port's detect+track sweep planners (``track_accuracy``,
``track_fixed`` in ``core/sim_batch``) against the reference, on the CPU.

Contract: every ``StreamStats`` field but ``schedule_time`` bit-equal to
the reference's ``simulate_batch`` and to ``simulate`` (``npu_busy_s``
against the engine only: ``simulate`` leaves it 0).  The grids are the
reference's (tests/test_tracking.py): both planners, three parameter sets,
four world-truth decay specs, constant, zero-bandwidth and piecewise traces,
at two deadlines and two frame rates; then its ``run_sweep`` grid.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest
from test_torch_sim_batch import assert_contract, sweeps

from repro.core import profiles as jprofiles
from repro.core import sim_batch as jsim_batch
from repro.core import simulator as jsim
from repro.core.registry import PolicySpec as JPolicySpec
from repro.core.tracking import WorkloadSpec as JWorkload
from repro_torch.core import profiles as tprofiles
from repro_torch.core import sim_batch as tsim_batch
from repro_torch.core.registry import PolicySpec as TPolicySpec
from repro_torch.core.tracking import WorkloadSpec as TWorkload

CPU = "cpu"
GOLD_FRAMES = 24
FIELDS = ("frames_total", "frames_processed", "frames_missed_deadline", "frames_offloaded", "schedule_calls",
          "accuracy_sum", "elapsed")
PLANNERS = (  # tests/test_tracking.py:49-53
    ("track_accuracy", {}),
    ("track_accuracy", {"decay": 0.35, "density": 2.0, "k_max": 4}),
    ("track_fixed", {"k": 3}),
)
WORKLOADS = ({}, {"decay": 0.4, "density": 2.0}, {"decay": 0.0}, {"decay": 1.0})  # :57-62
TRACES = (((0.0, 6.0),), ((0.0, 0.0),), ((0.0, 4.0), (0.25, 0.4), (0.8, 8.0)))  # Mbps; :65, :83


def _points():
    return [(wl, segs, dl, fps) for wl in WORKLOADS for segs in TRACES for dl in (0.1, 0.2) for fps in (30.0, 60.0)]


def _scenarios(sim_batch, prof, policy_spec, workload, policy, params):
    return [sim_batch.BatchScenario(
        stream=prof.StreamSpec(fps=fps, deadline=dl), n_frames=GOLD_FRAMES,
        params=dict(policy_spec(policy, params).params), rtt=0.060,
        bw_segments=tuple((t, v * 1e6) for t, v in segs), workload=workload("track", **wl))
        for wl, segs, dl, fps in _points()]


@pytest.mark.parametrize("policy,params", PLANNERS)
def test_track_grid_equals_reference(policy, params):
    got = tsim_batch.simulate_batch(policy, tprofiles.PAPER_MODELS,
                                    _scenarios(tsim_batch, tprofiles, TPolicySpec, TWorkload, policy, params),
                                    device=CPU)
    ref = jsim_batch.simulate_batch(policy, list(jprofiles.PAPER_MODELS),
                                    _scenarios(jsim_batch, jprofiles, JPolicySpec, JWorkload, policy, params))
    assert len(got) == len(_points()) == 48
    for g, r in zip(got, ref):
        assert [getattr(g, f) for f in FIELDS + ("npu_busy_s",)] == [getattr(r, f) for f in FIELDS + ("npu_busy_s",)]
    for (wl, segs, dl, fps), g in zip(_points(), got):
        want = jsim.simulate(JPolicySpec(policy, params).build(), list(jprofiles.PAPER_MODELS),
                             jprofiles.StreamSpec(fps=fps, deadline=dl), jsim.Trace.piecewise(list(segs), rtt_ms=60.0),
                             GOLD_FRAMES, workload=JWorkload("track", **wl))
        assert [getattr(g, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS], (wl, segs, dl, fps)
    assert sum(g.frames_offloaded for g in got) > 0 and sum(g.frames_processed for g in got) > 0


@pytest.mark.parametrize("policy,params", [("track_accuracy", {"k_max": 5}), ("track_fixed", {"k": 4})])
def test_run_sweep_track_grid_equals_reference(policy, params):
    """tests/test_tracking.py:213-228's grid, through run_sweep: the port's
    engine, the reference's engine and the port's per-point loop."""
    spec = {"policy": {"name": policy, "params": params}, "n_frames": GOLD_FRAMES,
            "trace": {"kind": "constant", "mbps": 2.5, "rtt_ms": 80.0},
            "workload": {"kind": "track", "decay": 0.2, "density": 1.5}}
    got, ref, loop = sweeps(spec, {"bandwidth_mbps": [0.5, 3.0, 9.0], "deadline_ms": [100.0, 200.0]})
    assert_contract(policy, got, ref)
    assert_contract(policy, got, loop)
    assert any(p.stats.frames_processed > 0 for p in got.points)
