"""The port's lane-batched sweep engine (``core/sim_batch``) against the
reference, on the CPU: the ``jax_*`` planners, and what every planner
shares (the shape-group partition, the skip path, lane independence).

The reference's exactness contract (``src/repro/core/sim_batch.py:14-56``):
``jax_*`` and ``track_*`` stats are bit-equal to ``simulate`` in every
``StreamStats`` field but ``schedule_time``; ``max_*`` have integer stats
exact and ``accuracy_sum`` within ``AUDIT_TOL``.  Each grid runs three
ways, all through ``Session.run_sweep``: the port's engine
(``backend="batched"``, ``device="cpu"``), the reference's engine, and the
port's per-point loop (``backend="reference"``, the port's ``simulate``,
itself held equal to the reference's in tests/test_torch_sim.py).  The
``max_*`` planners are in tests/test_torch_sim_batch_net.py, the track
planners in tests/test_torch_sim_batch_track.py.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro import session as jsession
from repro_torch import session as tsession
from repro_torch.core import sim_batch as tsim_batch
from repro_torch.core.audit import AUDIT_TOL
from repro_torch.core.profiles import PAPER_MODELS, StreamSpec

CPU = "cpu"
GOLD_FRAMES = 24  # tests/test_sim_batch.py's
INT_FIELDS = ("frames_total", "frames_processed", "frames_missed_deadline", "frames_offloaded",
              "schedule_calls")
NET_POLICIES = frozenset({"max_accuracy", "max_utility"})
BATCHED_PARAMS = {  # tests/test_sim_batch.py:40-45: base params, the param axis of the golden grid
    "jax_accuracy": ({}, {"grid": (1e-3, 2e-3)}),
    "jax_utility": ({"alpha": 200.0}, {"alpha": (50.0, 200.0)}),
    "max_accuracy": ({}, {"grid": (1e-3, 2e-3)}),
    "max_utility": ({"alpha": 200.0}, {"alpha": (50.0, 200.0)}),
}
PIECEWISE = {"kind": "piecewise", "points": [[0.0, 3.0], [0.3, 0.8], [0.9, 6.0]], "rtt_ms": 60.0}


def golden_grid(param_axis: dict) -> dict:
    """tests/test_sim_batch.py::_golden_grid: 2 x 5 x 5 x 2 = 100 points;
    deadline 10 ms < every NPU latency forces the skip path, mixed fps
    forces window padding."""
    return {"bandwidth_mbps": [1.0, 2.5], "deadline_ms": [10.0, 100.0, 150.0, 200.0, 350.0],
            "fps": [10.0, 24.0, 30.0, 50.0, 60.0], "params": {k: list(v) for k, v in param_axis.items()}}


PIECEWISE_GRID = {"deadline_ms": [10.0, 150.0, 200.0, 350.0], "fps": [10.0, 30.0, 60.0], "rtt_ms": [40.0, 100.0]}


def sweeps(spec: dict, grid: dict):
    """(port engine, reference engine, port per-point loop) over one grid."""
    port = tsession.Session(tsession.ScenarioSpec.from_json(spec), device=CPU)
    tgrid = tsession.SweepGrid.from_json(grid)
    got = port.run_sweep(tgrid, backend="batched")
    ref = jsession.Session(jsession.ScenarioSpec.from_json(spec)).run_sweep(
        jsession.SweepGrid.from_json(grid), backend="batched")
    loop = port.run_sweep(tgrid, backend="reference")
    assert got.backend == ref.backend == "batched" and loop.backend == "reference"
    assert got.meta["engine"] == ref.meta["engine"] == "sim_batch"
    return got, ref, loop


def assert_contract(name: str, got, want) -> int:
    """The reference's contract, point by point; returns how many points
    came out bit-equal in every compared field.  ``npu_busy_s`` is compared
    between engines only: the per-point loop (``simulate``) leaves it 0."""
    exact = name not in NET_POLICIES
    fields = ("accuracy_sum", "npu_busy_s") if want.backend == "batched" else ("accuracy_sum",)
    assert len(got.points) == len(want.points)
    bit_equal = 0
    for pg, pw in zip(got.points, want.points):
        assert pg.overrides == pw.overrides
        (g,), (w,) = pg.streams, pw.streams
        for f in INT_FIELDS:
            assert getattr(g, f) == getattr(w, f), (pg.overrides, f)
        assert g.elapsed == w.elapsed, pg.overrides
        for f in fields:
            if exact:
                assert getattr(g, f) == getattr(w, f), (pg.overrides, f)
            else:
                assert abs(getattr(g, f) - getattr(w, f)) <= AUDIT_TOL, (pg.overrides, f)
        bit_equal += all(getattr(g, f) == getattr(w, f) for f in fields)
    return bit_equal


def spec_of(name: str, base: dict, **kw) -> dict:
    return {"policy": {"name": name, "params": base}, "n_frames": GOLD_FRAMES, **kw}


@pytest.mark.parametrize("name", ["jax_accuracy", "jax_utility"])
def test_golden_grid_equals_reference(name, record_property):
    base, axis = BATCHED_PARAMS[name]
    got, ref, loop = sweeps(spec_of(name, base), golden_grid(axis))
    assert len(got.points) == 100
    record_property("bit_equal_points", (assert_contract(name, got, ref), assert_contract(name, got, loop)))


@pytest.mark.parametrize("name", ["jax_accuracy", "jax_utility"])
def test_piecewise_grid_equals_reference(name):
    """The local-only planners on a piecewise base trace (which they never
    consult) and an rtt axis."""
    base, _ = BATCHED_PARAMS[name]
    got, ref, loop = sweeps(spec_of(name, base, n_frames=36, trace=PIECEWISE), PIECEWISE_GRID)
    assert_contract(name, got, ref)
    assert_contract(name, got, loop)


def test_infeasible_deadline_takes_the_skip_path():
    """Deadline 10 ms is below every NPU latency: every round is a
    horizon-1 SKIP that processes nothing, as in the reference."""
    grid = {"deadline_ms": [10.0, 200.0], "fps": [30.0]}
    got, ref, loop = sweeps(spec_of("jax_accuracy", {}), grid)
    assert_contract("jax_accuracy", got, ref)
    skip, real = (p.stats for p in got.points)
    assert skip.frames_processed == 0 and skip.schedule_calls == GOLD_FRAMES
    assert real.frames_processed > 0 and real.schedule_calls < GOLD_FRAMES


def test_width_axis_partitions_groups():
    """``width`` is a front shape: each value is its own shape group, and
    the results equal the reference's."""
    grid = {"deadline_ms": [150.0, 350.0], "fps": [30.0, 60.0], "params": {"width": [8, 16, 64]}}
    got, ref, loop = sweeps(spec_of("jax_utility", {"alpha": 200.0}), grid)
    assert_contract("jax_utility", got, ref)
    assert_contract("jax_utility", got, loop)
    groups = []
    scens = [tsim_batch.BatchScenario(stream=StreamSpec(fps=30.0, deadline=0.35), n_frames=12,
                                      params={"alpha": 200.0, "window_frames": None, "width": w})
             for w in (8, 16, 64, 8)]
    tsim_batch.simulate_batch("jax_utility", PAPER_MODELS, scens, device=CPU, groups=groups)
    assert sorted(g["key"] for g in groups) == [(10, 8), (10, 16), (10, 64)]
    assert sorted(g["lanes"] for g in groups) == [1, 1, 2]


@pytest.mark.parametrize("name", sorted(BATCHED_PARAMS))
def test_lanes_are_independent(name):
    """A scenario alone equals the same scenario inside a mixed group
    (other deadlines, fps, params and traces), field for field."""
    base, axis = BATCHED_PARAMS[name]
    (key, values), = axis.items()
    mixed = [tsim_batch.BatchScenario(stream=StreamSpec(fps=fps, deadline=dl), n_frames=30,
                                      params=tsession.PolicySpec(name, {**base, key: v}).params,
                                      rtt=0.06, bw_segments=segs)
             for fps in (24.0, 30.0) for dl in (0.15, 0.2) for v in values
             for segs in (((0.0, 2.5e6),), ((0.0, 4e6), (0.4, 0.5e6)))]
    together = tsim_batch.simulate_batch(name, PAPER_MODELS, mixed, device=CPU)
    for scen, st in zip(mixed, together):
        alone, = tsim_batch.simulate_batch(name, PAPER_MODELS, [scen], device=CPU)
        assert [getattr(alone, f) for f in (*INT_FIELDS, "accuracy_sum", "npu_busy_s")] == \
            [getattr(st, f) for f in (*INT_FIELDS, "accuracy_sum", "npu_busy_s")]


def test_rejects_unbatched_policy_and_wrong_workload():
    with pytest.raises(ValueError, match="no batched backend"):
        tsim_batch.simulate_batch("local", [], [], device=CPU)
    with pytest.raises(ValueError, match="plans classify workloads"):
        tsim_batch.simulate_batch("jax_accuracy", PAPER_MODELS, [tsim_batch.BatchScenario(
            params={"grid": 1e-3, "window_frames": None}, workload=tsession.WorkloadSpec("track"))], device=CPU)


def test_engine_counts_one_host_read_per_round():
    """The group record: one read per round (the termination test after
    it) and one for the results."""
    groups = []
    scens = [tsim_batch.BatchScenario(stream=StreamSpec(fps=30.0, deadline=dl), n_frames=30,
                                      params={"grid": 1e-3, "window_frames": None}) for dl in (0.2, 0.21)]
    stats = tsim_batch.simulate_batch("jax_accuracy", PAPER_MODELS, scens, device=CPU, groups=groups)
    (g,) = groups
    assert g["rounds"] == max(s.schedule_calls for s in stats) and g["host_reads"] == g["rounds"] + 1
