"""``Session.run_sweep`` and the ``sweep`` CLI of the port against the
reference's, on the CPU.

Routing and ``meta`` (engine, fallback, trace override, chunks, summary,
points streamed) equal the reference's on the same grids; grids and
reports written by either package load in the other; chunking and
``keep_points=False`` change no result; the CLI prints the reference's
stats and refuses bad input with exit 2 and one ``error:`` line.  Fleet
grids run on the fleet engine, online grids on the online engine, and the
compile cache is accepted (tests/test_torch_fleet_*.py,
tests/test_torch_online_sweep.py and tests/test_torch_compile_cache.py hold
them to the reference).
"""
from __future__ import annotations

import json
import logging

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest
import torch

from repro import session as jsession
from repro.core import registry as jregistry
from repro.core import sim_batch as jsim_batch
from repro_torch import session as tsession
from repro_torch.core import registry as tregistry
from repro_torch.core import sim_batch as tsim_batch

CPU = "cpu"
META_KEYS = ("requested_backend", "grid_points", "mode", "engine", "fallback", "chunks", "chunk_size",
             "summary", "points_streamed")
PIECEWISE = {"kind": "piecewise", "points": [[0.0, 3.0], [0.3, 0.8], [0.9, 6.0]], "rtt_ms": 60.0}


def _spec(name, params=None, **kw):
    out = {"policy": {"name": name, "params": params or {}}, "n_frames": 12, **kw}
    if name.startswith("track"):
        out["workload"] = {"kind": "track"}
    return out


def _points(report):
    """Per-point JSON without the wall-clock ``schedule_time``."""
    out = [p.to_json() for p in report.points]
    for p in out:
        for s in p["streams"]:
            s.pop("schedule_time")
    return out


def _both(spec, grid, **kw):
    ref = jsession.Session(jsession.ScenarioSpec.from_json(spec)).run_sweep(
        jsession.SweepGrid.from_json(grid), **kw)
    got = tsession.Session(tsession.ScenarioSpec.from_json(spec), device=CPU).run_sweep(
        tsession.SweepGrid.from_json(grid), **kw)
    return got, ref


ROUTES = [  # (spec, grid, run_sweep kwargs)
    (_spec("max_accuracy"), {"bandwidth_mbps": [1.0, 2.5], "deadline_ms": [100.0, 200.0]}, {}),
    (_spec("jax_utility", {"alpha": 200.0}), {"fps": [15.0, 30.0], "params": {"alpha": [50.0, 200.0]}},
     {"backend": "batched"}),
    (_spec("track_fixed", {"k": 3}), {"bandwidth_mbps": [0.5, 3.0]}, {}),
    (_spec("local"), {"deadline_ms": [150.0, 200.0]}, {}),  # no batched planner: the loop, silently
    (_spec("local"), {"deadline_ms": [150.0, 200.0]}, {"backend": "batched"}),  # logged fallback
    (_spec("max_utility", {"alpha": 200.0}), {"deadline_ms": [150.0, 350.0]}, {"backend": "reference"}),
    (_spec("jax_accuracy", trace=PIECEWISE), {"bandwidth_mbps": [1.0, 2.5]}, {}),  # trace override
    (_spec("max_accuracy", fleet={"n_clients": 2}), {"n_clients": [1, 2]}, {"backend": "reference"}),
    (_spec("local", fleet={"n_clients": 2}), {"n_clients": [1, 2]}, {}),  # no fleet planner: the loop
    (_spec("max_accuracy"), {"deadline_ms": [150.0, 200.0]}, {"mode": "online", "backend": "reference"}),
    (_spec("local"), {"deadline_ms": [150.0, 200.0]}, {"mode": "online"}),  # no online planner: the loop
    (_spec("max_utility", {"alpha": 200.0}), {"deadline_ms": [100.0, 200.0, 350.0], "fps": [15.0, 30.0]},
     {"chunk_size": 4}),
    (_spec("jax_accuracy"), {"deadline_ms": [100.0, 200.0], "fps": [15.0, 30.0]}, {"keep_points": False}),
]


@pytest.mark.parametrize("spec,grid,kw", ROUTES)
def test_routing_and_meta_equal_reference(spec, grid, kw):
    got, ref = _both(spec, grid, **kw)
    assert got.backend == ref.backend
    assert {k: got.meta.get(k) for k in META_KEYS} == {k: ref.meta.get(k) for k in META_KEYS}
    assert _points(got) == _points(ref)
    assert got.meta["device"] == CPU


def test_fallback_and_trace_override_are_logged(caplog):
    with caplog.at_level(logging.WARNING, logger="repro_torch.session"):
        got, _ = _both(_spec("local"), {"deadline_ms": [150.0]}, backend="batched")
    assert got.meta["fallback"] == "policy 'local' has no batched backend"
    assert any("falling back" in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.session"):
        got, _ = _both(_spec("jax_accuracy", trace=PIECEWISE), {"bandwidth_mbps": [1.0]})
    assert any("piecewise base trace" in r.getMessage() for r in caplog.records)
    assert "trace_override" in got.points[0].meta


def test_registry_flags_equal_reference():
    """``{name: (batched, batched_multi, batched_online)}`` for all 10
    policies, and the engine's planner table matches ``batched=True``."""
    flags = {}
    for reg in (tregistry, jregistry):
        flags[reg] = {n: (reg.get_policy(n).batched, reg.get_policy(n).batched_multi,
                          reg.get_policy(n).batched_online) for n in reg.available_policies()}
    assert flags[tregistry] == flags[jregistry] and len(flags[tregistry]) == 10
    assert set(tsim_batch.batched_policies()) == {n for n, f in flags[tregistry].items() if f[0]}
    assert tsim_batch.batched_policies() == jsim_batch.batched_policies()


@pytest.mark.parametrize("writer,reader", [(jsession, tsession), (tsession, jsession)])
def test_grid_and_report_json_load_in_the_other_package(writer, reader):
    grid = writer.SweepGrid(bandwidth_mbps=(1.0, 2.5), deadline_ms=(150.0,), params={"alpha": (50.0, 200.0)})
    assert reader.SweepGrid.from_json(json.dumps(grid.to_json())).to_json() == grid.to_json()
    spec = writer.ScenarioSpec.from_json(_spec("max_utility", {"alpha": 200.0}, trace=PIECEWISE))
    kw = {"device": CPU} if writer is tsession else {}
    report = writer.Session(spec, **kw).run_sweep(grid, chunk_size=3)
    payload = json.dumps(report.to_json())
    loaded = reader.SweepReport.from_json(payload)
    assert loaded.to_json() == json.loads(payload)
    assert len(loaded) == 4 and loaded.meta["summary"]["n_points"] == 4
    assert reader.SweepSummary.from_json(loaded.meta["summary"]).to_json() == loaded.meta["summary"]


@pytest.mark.parametrize("name,params", [("max_utility", {"alpha": 200.0}), ("track_accuracy", {})])
def test_chunked_and_streamed_equal_unchunked(name, params):
    session = tsession.Session(tsession.ScenarioSpec.from_json(_spec(name, params)), device=CPU)
    grid = tsession.SweepGrid(deadline_ms=(100.0, 150.0, 200.0, 350.0), fps=(10.0, 30.0, 60.0))
    whole = session.run_sweep(grid, keep_points=True)
    chunked = session.run_sweep(grid, chunk_size=5)
    streamed = session.run_sweep(grid, chunk_size=5, keep_points=False)
    assert _points(chunked) == _points(whole) and chunked.meta["chunks"] == 3
    assert streamed.points == [] and streamed.meta["points_streamed"] == 12
    summary = tsession.SweepSummary()
    for p in whole.points:
        summary.update(p)
    assert chunked.meta["summary"] == streamed.meta["summary"] == summary.to_json()


def test_not_ported_engines_name_their_roadmap_item(monkeypatch, tmp_path):
    """Grids the reference runs on its fleet engine run on the port's, with
    the reference's per-point results; online grids run on the batched
    online engine, and the compile cache (argument or environment) is
    accepted, recorded as the port's in-process cache, and writes nothing."""
    got, ref = _both(_spec("max_accuracy", fleet={"n_clients": 2}), {"n_clients": [1, 2]})
    assert got.backend == ref.backend == "batched" and got.meta["engine"] == ref.meta["engine"] == "sim_multi_batch"
    assert _points(got) == _points(ref)  # equal weights: bit-equal
    online = tsession.Session(tsession.ScenarioSpec.from_json(_spec("max_utility", {"alpha": 200.0})), device=CPU)
    report = online.run_sweep(tsession.SweepGrid(deadline_ms=(150.0,)), mode="online")
    assert report.backend == "batched" and report.meta["engine"] == "sim_online_batch"
    cache = tmp_path / "cache"
    report = online.run_sweep(tsession.SweepGrid(), compile_cache=str(cache))
    assert report.meta["compile_cache"] == {"dir": str(cache), "persistent": False, "scope": "process"}
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(cache))
    assert online.run_sweep(tsession.SweepGrid()).meta["compile_cache"]["dir"] == str(cache)
    assert not cache.exists()


def test_batched_engine_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tsim_batch.simulate_batch("jax_accuracy", tsession.PAPER_MODELS, [tsim_batch.BatchScenario(
            params={"grid": 1e-3, "window_frames": None})])
    with pytest.raises(RuntimeError, match="is_available"):
        tsession.Session(tsession.ScenarioSpec.from_json(_spec("local"))).run_sweep(tsession.SweepGrid())


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("name,params", [("jax_accuracy", {}), ("max_utility", {"alpha": 200.0})])
def test_cli_sweep_equals_reference(name, params, tmp_path, capsys):
    spec, grid = tmp_path / "spec.json", tmp_path / "grid.json"
    spec.write_text(json.dumps(_spec(name, params)))
    grid.write_text(json.dumps({"bandwidth_mbps": [1.0, 2.5], "deadline_ms": [150.0, 200.0]}))
    rc_t, out_t, _ = _cli(tsession, ["sweep", str(spec), "--grid", str(grid), "--device", "cpu", "--chunk-size", "3"],
                          capsys)
    rc_j, out_j, _ = _cli(jsession, ["sweep", str(spec), "--grid", str(grid), "--chunk-size", "3"], capsys)
    assert rc_t == rc_j == 0
    got, ref = (jsession.SweepReport.from_json(out) for out in (out_t, out_j))
    assert _points(got) == _points(ref) and got.backend == ref.backend == "batched"
    assert got.meta["summary"] == ref.meta["summary"]
    assert _cli(tsession, ["sweep", "--example-grid"], capsys) == _cli(jsession, ["sweep", "--example-grid"], capsys)
    out = tmp_path / "report.json"
    rc, printed, _ = _cli(tsession, ["sweep", str(spec), "--grid", str(grid), "--device", "cpu", "--out", str(out)],
                          capsys)
    assert rc == 0 and "4 points via batched backend" in printed
    assert len(tsession.SweepReport.from_json(out.read_text())) == 4


@pytest.mark.parametrize("grid,extra,meta", [
    ("{not json", [], None),
    (json.dumps({"bandwidth": [1.0]}), [], None),  # unknown axis
    (json.dumps({"deadline_ms": 150.0}), [], None),  # a scalar axis
    # Options that now run: the report's meta records them.
    (json.dumps({"deadline_ms": [150.0]}), ["--compile-cache", "cache"],
     {"compile_cache": {"dir": "cache", "persistent": False, "scope": "process"}}),
    (json.dumps({"deadline_ms": [150.0]}), ["--mode", "online"], {"mode": "online", "engine": "sim_online_batch"}),
], ids=["bad-json", "unknown-axis", "scalar-axis", "compile-cache", "online-engine"])
def test_cli_sweep_errors_exit_2_with_one_line(grid, extra, meta, tmp_path, capsys, monkeypatch):
    """Bad grids exit 2 with one ``error:`` line; ``--compile-cache`` and
    ``--mode online`` run and are recorded in the report's meta."""
    monkeypatch.chdir(tmp_path)
    spec, path = tmp_path / "spec.json", tmp_path / "grid.json"
    spec.write_text(json.dumps(_spec("max_accuracy")))
    path.write_text(grid)
    rc, out, err = _cli(tsession, ["sweep", str(spec), "--grid", str(path), "--device", "cpu", *extra], capsys)
    if meta is None:
        assert rc == 2 and out == "" and err.startswith("error: ") and err.count("\n") == 1, err
        return
    report = tsession.SweepReport.from_json(out)
    assert rc == 0 and report.backend == "batched" and len(report) == 1
    assert {k: report.meta[k] for k in meta} == meta
    assert not (tmp_path / "cache").exists()
