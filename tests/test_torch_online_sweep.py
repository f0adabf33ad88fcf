"""``Session.run_sweep(mode="online")`` and the sweep CLI's ``--mode online``
in the port against the reference, on the CPU.

Routing and ``meta`` equal the reference's (``engine`` is
``sim_online_batch`` for the ``batched_online`` policies; others run the
per-point ``run_online`` loop, with a logged fallback when ``batched`` was
asked for); the port also records its shape groups in ``meta["groups"]``.
Points meet the reference's online contract (integer stats and rounds
exact, accuracy within ``AUDIT_TOL``, ``estimated_bps`` bit for bit);
reports round-trip through JSON into either package; chunking changes no
result; fleet and track grids are refused as the reference refuses them.
"""
from __future__ import annotations

import json
import logging

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro import session as jsession
from repro_torch import session as tsession
from repro_torch.core.audit import AUDIT_TOL

CPU = "cpu"
META_KEYS = ("requested_backend", "grid_points", "mode", "engine", "fallback", "chunks", "chunk_size")
SQUARE = {"kind": "piecewise", "points": [[0.0, 3.5], [1.0, 0.8]], "rtt_ms": 100.0}
INT_FIELDS = ("frames_total", "frames_processed", "frames_missed_deadline", "frames_offloaded",
              "schedule_calls")


def _spec(name, params=None, **kw):
    return {"policy": {"name": name, "params": params or {}}, "n_frames": 30, "trace": SQUARE, **kw}


def _both(spec, grid, **kw):
    ref = jsession.Session(jsession.ScenarioSpec.from_json(spec)).run_sweep(
        jsession.SweepGrid.from_json(grid), mode="online", **kw)
    got = tsession.Session(tsession.ScenarioSpec.from_json(spec), device=CPU).run_sweep(
        tsession.SweepGrid.from_json(grid), mode="online", **kw)
    return got, ref


def assert_online_equal(got, ref):
    assert len(got.points) == len(ref.points)
    for pg, pr in zip(got.points, ref.points):
        assert pg.overrides == pr.overrides
        (sg,), (sr,) = pg.streams, pr.streams
        assert [getattr(sg, f) for f in INT_FIELDS] == [getattr(sr, f) for f in INT_FIELDS]
        assert abs(sg.accuracy_sum - sr.accuracy_sum) <= AUDIT_TOL
        assert pg.meta["rounds"] == pr.meta["rounds"]
        assert pg.meta["estimated_bps"] == pr.meta["estimated_bps"]


ROUTES = [  # (spec, grid, run_sweep kwargs)
    (_spec("max_accuracy", {"grid": 0.01}), {"rtt_ms": [60.0, 100.0], "deadline_ms": [150.0, 200.0]}, {}),
    (_spec("max_utility", {"alpha": 200.0}), {"rtt_ms": [60.0, 100.0], "params": {"alpha": [50.0, 200.0]}},
     {"backend": "batched"}),
    (_spec("max_utility", {"alpha": 200.0}), {"deadline_ms": [150.0, 200.0, 250.0]}, {"chunk_size": 2}),
    (_spec("max_accuracy", {"grid": 0.01}), {"deadline_ms": [150.0, 200.0]}, {"backend": "reference"}),
    (_spec("local"), {"deadline_ms": [150.0, 200.0]}, {}),  # no online planner: the loop, silently
]


@pytest.mark.parametrize("spec,grid,kw", ROUTES)
def test_online_routing_and_meta_equal_reference(spec, grid, kw):
    got, ref = _both(spec, grid, **kw)
    assert got.backend == ref.backend
    assert {k: got.meta.get(k) for k in META_KEYS} == {k: ref.meta.get(k) for k in META_KEYS}
    assert_online_equal(got, ref)
    if got.backend == "batched":
        assert got.meta["engine"] == "sim_online_batch"
        assert sum(g["lanes"] for g in got.meta["groups"]) >= len(got)  # reruns at the cap add lanes
        assert all(p.meta["policy"] == spec["policy"]["name"] for p in got.points)
    else:
        assert "groups" not in got.meta


def test_fallback_without_online_backend_is_logged(caplog):
    """jax_accuracy is batched for oracle sweeps but has no online backend:
    ``backend="batched"`` warns and records the fallback, and the points
    equal the reference's loop."""
    with caplog.at_level(logging.WARNING, logger="repro_torch.session"):
        got, ref = _both(_spec("jax_accuracy"), {"rtt_ms": [60.0, 100.0]}, backend="batched")
    assert got.backend == ref.backend == "reference"
    assert got.meta["fallback"] == ref.meta["fallback"] == "policy 'jax_accuracy' has no batched online backend"
    assert any("falling back" in r.getMessage() for r in caplog.records)
    assert_online_equal(got, ref)


@pytest.mark.parametrize("writer,reader", [(jsession, tsession), (tsession, jsession)])
def test_online_report_json_loads_in_the_other_package(writer, reader):
    spec = writer.ScenarioSpec.from_json(_spec("max_accuracy", {"grid": 0.01}))
    kw = {"device": CPU} if writer is tsession else {}
    report = writer.Session(spec, **kw).run_sweep(writer.SweepGrid(rtt_ms=(60.0, 100.0)), mode="online",
                                                  chunk_size=1)
    payload = json.dumps(report.to_json())
    loaded = reader.SweepReport.from_json(payload)
    assert loaded.to_json() == json.loads(payload)
    assert loaded.meta["mode"] == "online" and loaded.meta["engine"] == "sim_online_batch"
    assert [p.meta["estimated_bps"] for p in loaded.points] == [p.meta["estimated_bps"] for p in report.points]


def test_online_chunked_equals_unchunked():
    session = tsession.Session(tsession.ScenarioSpec.from_json(_spec("max_utility", {"alpha": 200.0})), device=CPU)
    grid = tsession.SweepGrid(deadline_ms=(150.0, 200.0, 250.0), rtt_ms=(60.0, 100.0))
    whole = session.run_sweep(grid, mode="online")
    chunked = session.run_sweep(grid, mode="online", chunk_size=4)
    strip = lambda r: [(p.overrides, [s.__dict__ | {"schedule_time": 0} for s in p.streams], p.meta)  # noqa: E731
                       for p in r.points]
    assert strip(chunked) == strip(whole) and chunked.meta["chunks"] == 2


def test_online_sweep_rejects_fleet_and_track_grids():
    fleet = tsession.ScenarioSpec.from_json({**_spec("max_accuracy"), "fleet": {"n_clients": 2}})
    with pytest.raises(ValueError, match="single-stream"):
        tsession.Session(fleet, device=CPU).run_sweep(tsession.SweepGrid(), mode="online")
    track = tsession.ScenarioSpec.from_json({**_spec("track_fixed", {"k": 3}), "workload": {"kind": "track"}})
    with pytest.raises(ValueError, match="tracking workload"):
        tsession.Session(track, device=CPU).run_sweep(tsession.SweepGrid(), mode="online")
    # a fleet axis with mode="online" too; without it the grid runs on the fleet engine
    with pytest.raises(ValueError, match="single-stream"):
        tsession.Session(fleet, device=CPU).run_sweep(tsession.SweepGrid(n_clients=(1, 2)), mode="online")
    report = tsession.Session(fleet, device=CPU).run_sweep(tsession.SweepGrid(n_clients=(1, 2)))
    assert report.backend == "batched" and report.meta["engine"] == "sim_multi_batch"


def test_cli_online_sweep_equals_reference(tmp_path, capsys):
    spec, grid = tmp_path / "spec.json", tmp_path / "grid.json"
    spec.write_text(json.dumps(_spec("max_accuracy", {"grid": 0.01})))
    grid.write_text(json.dumps({"rtt_ms": [60.0, 100.0], "deadline_ms": [150.0, 200.0]}))
    args = ["sweep", str(spec), "--grid", str(grid), "--mode", "online"]
    assert tsession.main([*args, "--device", "cpu"]) == 0
    got = jsession.SweepReport.from_json(capsys.readouterr().out)
    assert jsession.main(args) == 0
    ref = jsession.SweepReport.from_json(capsys.readouterr().out)
    assert got.backend == ref.backend == "batched" and got.meta["engine"] == ref.meta["engine"]
    assert got.meta["device"] == CPU
    assert_online_equal(got, ref)
