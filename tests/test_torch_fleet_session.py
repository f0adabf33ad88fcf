"""Routing of fleet grids through ``Session.run_sweep`` to the port's fleet
engine, and the engine's own surface, on the CPU: the planner table against
the registry and the reference's, the logged fallback for policies without
a fleet planner and for grids that mix fleet and single-stream points,
the shape groups' records (one host read per round plus one per group,
drain replays apart), and results that do not depend on the drain's
per-round event count.
"""
from __future__ import annotations

import dataclasses
import logging
from unittest import mock

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro.core import sim_multi_batch as jmulti
from repro_torch import session as tsession
from repro_torch.core import EdgeServerScheduler, PolicySpec, Trace, make_fleet, simulate_multi
from repro_torch.core import sim_multi_batch, sweep_shard
from repro_torch.core.registry import available_policies, get_policy
from repro_torch.core.sim_multi_batch import MULTI_TOL, FleetScenario, simulate_multi_batch

CPU = "cpu"


def _session(policy="offload", params=None, **fleet):
    fleet.setdefault("capacity", 2)
    return tsession.Session(tsession.ScenarioSpec(
        policy=PolicySpec(policy, params or {}), n_frames=16, trace=tsession.TraceSpec(mbps=6.0),
        fleet=tsession.FleetSpec(**fleet)), device=CPU)


def _rows(report) -> list:
    return [([dataclasses.replace(s, schedule_time=0.0) for s in p.streams], p.meta) for p in report.points]


def test_planner_table_matches_registry_and_reference():
    flagged = {n for n in available_policies() if get_policy(n).batched_multi}
    assert set(sim_multi_batch.multi_batched_policies()) == flagged
    assert sim_multi_batch.multi_batched_policies() == jmulti.multi_batched_policies()
    assert (sim_multi_batch.MULTI_TOL, sim_multi_batch.EQUIV_INT_FIELDS) == (jmulti.MULTI_TOL,
                                                                             jmulti.EQUIV_INT_FIELDS)


def test_unknown_policy_and_wrong_workload_raise():
    with pytest.raises(ValueError, match="no batched fleet backend"):
        simulate_multi_batch("local", [], [FleetScenario()], device=CPU)
    with pytest.raises(ValueError, match="plans track workloads"):
        simulate_multi_batch("track_fixed", [], [FleetScenario(params={"k": 3})], device=CPU)
    assert simulate_multi_batch("offload", [], [], device=CPU) == []


def test_fleet_grid_routes_to_the_engine_with_its_records(caplog):
    """Every batched_multi policy's fleet grid runs on the engine, with no
    fallback; each shape group reads the device once a round plus once for
    its results, and records its drain replays."""
    for policy, params in (("offload", {}), ("max_accuracy", {}), ("max_utility", {"alpha": 150.0})):
        with caplog.at_level(logging.WARNING, logger="repro_torch.session"):
            report = _session(policy, params).run_sweep(
                tsession.SweepGrid(bandwidth_mbps=(1.0, 6.0), n_clients=(2, 3)), backend="batched")
        assert report.backend == "batched" and report.meta["engine"] == "sim_multi_batch"
        assert "fallback" not in report.meta and not caplog.records
        groups = report.meta["groups"]
        assert len(groups) == 2 and all(g["host_reads"] == g["rounds"] + 1 for g in groups)
        assert all(g["drain_replays"] >= 0 and g["drain_events"] == 2 and g["lanes"] == 2 for g in groups)
        assert [p.meta["allocation"] for p in report.points] == ["weighted_fair"] * 4


def test_python_only_fleet_grid_warns_and_falls_back(caplog):
    """A policy with no fleet planner (``local``) logs the reference's
    warning, which names the fleet planners, and runs the per-point loop;
    auto mode falls back silently."""
    session = _session("local")
    grid = tsession.SweepGrid(bandwidth_mbps=(6.0,), n_clients=(2,))
    with caplog.at_level(logging.WARNING, logger="repro_torch.session"):
        report = session.run_sweep(grid, backend="batched")
    assert report.backend == "reference"
    assert "no batched fleet backend" in report.meta["fallback"]
    (record,) = [r for r in caplog.records if "falling back" in r.message]
    assert str(sim_multi_batch.multi_batched_policies()) in record.message
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.session"):
        auto = session.run_sweep(grid)
    assert auto.backend == "reference" and not caplog.records


def test_mixed_fleet_and_single_stream_points_have_no_batched_engine():
    session = _session("max_accuracy")
    fleet = session.spec
    single = dataclasses.replace(fleet, fleet=None)
    ok, why = session._batched_capability(get_policy("max_accuracy"), [fleet, single])
    assert not ok and "needs a fleet at every grid point" in why
    assert session._batched_capability(get_policy("max_accuracy"), [fleet, fleet]) == (True, "")


@pytest.mark.parametrize("policy,params", [("offload", {}), ("max_accuracy", {}), ("track_accuracy", {"k_max": 5})])
def test_results_do_not_depend_on_the_drain_event_count(policy, params):
    """One completion event a round (most drains spill into replays) and
    eight (almost none do) give the same results bit for bit."""
    spec = tsession.ScenarioSpec(
        policy=PolicySpec(policy, params), n_frames=24, trace=tsession.TraceSpec(mbps=4.0),
        fleet=tsession.FleetSpec(n_clients=3, capacity=1),
        workload=tsession.WorkloadSpec(kind="track") if policy.startswith("track") else tsession.WorkloadSpec())
    grid = tsession.SweepGrid(bandwidth_mbps=(1.5, 4.0, 9.0), allocation=("weighted_fair", "priority", "fifo"))
    runs = {}
    for events in (1, 8):
        with mock.patch.object(sim_multi_batch, "DRAIN_EVENTS", events), \
                mock.patch.object(sweep_shard, "PROGRAMS", sweep_shard.LaneCache()):
            report = tsession.Session(spec, device=CPU).run_sweep(grid, backend="batched")
        runs[events] = (_rows(report), sum(g["drain_replays"] for g in report.meta["groups"]),
                        [g["drain_events"] for g in report.meta["groups"]])
    assert runs[1][0] == runs[8][0]
    assert runs[1][1] > runs[8][1]  # the drain spilled into replays at E = 1
    assert runs[1][2] == [1] * len(runs[1][2]) and runs[8][2] == [8] * len(runs[8][2])


def test_direct_backend_call_matches_simulate_multi():
    """One scenario through the module's own API (no Session), against the
    port's event loop: the MultiStreamStats shape and the scheduler's
    counters."""
    fleet = make_fleet(2, policy=PolicySpec("offload"))
    sched = EdgeServerScheduler(fleet, policy="weighted_fair", capacity=2)
    ms_ref = simulate_multi(sched, Trace.piecewise([(0.0, 5.0), (0.25, 1.0)]), 16)
    (ms, meta), = simulate_multi_batch(
        "offload", list(fleet[0].models),
        [FleetScenario(n_frames=16, bw_segments=((0.0, 5e6), (0.25, 1e6)), n_clients=2, capacity=2)],
        device=CPU)
    assert ms.server_jobs == ms_ref.server_jobs and ms.miss_rates == ms_ref.miss_rates
    assert abs(ms.server_busy_s - ms_ref.server_busy_s) <= MULTI_TOL
    assert abs(ms.aggregate_accuracy - ms_ref.aggregate_accuracy) <= MULTI_TOL
    assert meta == {"grants": sched.audit.grants, "denials": sched.audit.denials}
    for s in ms.per_client:
        assert s.frames_offloaded == s.frames_processed  # offload plans hold no NPU frame
