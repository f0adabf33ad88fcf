"""The port's front door against the reference's: one ScenarioSpec JSON
runs in either package with the same audited result, and the CLI
(``python -m repro_torch.session``) lists the same policies, prints the same
example, reports the same run, and refuses a malformed spec the same way —
exit 2 with one ``error: ...`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest
import torch

from repro import session as jsession
from repro_torch import session as tsession

CPU = "cpu"

SPECS = [
    {"policy": {"name": "max_accuracy", "params": {}}, "n_frames": 40},
    {"policy": {"name": "jax_utility", "params": {"alpha": 120.0, "width": 16}}, "n_frames": 30,
     "stream": {"fps": 15.0, "deadline_ms": 250.0, "resolutions": [90, 224], "png_ratio": 0.4},
     "trace": {"kind": "piecewise", "rtt_ms": 80.0, "points": [[0.0, 2.0], [1.0, 0.5]]}},
    {"policy": {"name": "track_fixed", "params": {"k": 2}}, "n_frames": 33,
     "models": ["squeezenet", {"name": "tiny", "t_npu_ms": 4.0, "t_server_ms": 30.0,
                               "acc_server": {"224": 0.5}, "acc_npu": {"224": 0.3}}],
     "trace": {"kind": "constant", "mbps": 6.0},
     "workload": {"kind": "track", "decay": 0.2, "density": 2.0}, "strict": False},
    {"policy": {"name": "offload", "params": {"alpha": 20.0}}, "n_frames": 24,
     "trace": {"kind": "constant", "mbps": 12.0},
     "fleet": {"n_clients": 3, "allocation": "priority", "capacity": 2, "priorities": [2, 0, 1]}},
]


def _streams(report_json):
    return [{k: v for k, v in s.items() if k != "schedule_time"} for s in report_json["streams"]]


# run_online does not execute the tracking workload, in either package.
RUNS = [(i, mode) for i, p in enumerate(SPECS) for mode in ("sim", "multi", "online")
        if not (mode == "online" and "workload" in p)]


@pytest.mark.parametrize("i,mode", RUNS)
def test_spec_json_runs_the_same_in_either_package(i, mode):
    """A spec written by one package runs in the other: port JSON through
    the reference and reference JSON through the port, same results."""
    payload = SPECS[i]
    t_spec = tsession.ScenarioSpec.from_json(payload)
    j_spec = jsession.ScenarioSpec.from_json(t_spec.to_json())
    t_back = tsession.ScenarioSpec.from_json(json.dumps(j_spec.to_json()))
    assert t_back == t_spec and j_spec.to_json() == t_spec.to_json()
    j = jsession.Session(j_spec).run(mode).to_json()
    t = tsession.Session(t_back, device=CPU).run(mode).to_json()
    assert _streams(t) == _streams(j)
    assert {k: v for k, v in t.items() if k != "streams"} == {k: v for k, v in j.items() if k != "streams"}


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_list_policies_and_example_equal_reference(capsys):
    assert _cli(tsession, ["--list-policies"], capsys) == _cli(jsession, ["--list-policies"], capsys)
    assert _cli(tsession, ["--example"], capsys) == _cli(jsession, ["--example"], capsys)


@pytest.mark.parametrize("mode", ["sim", "multi", "online"])
def test_cli_runs_a_spec_file_like_reference(mode, tmp_path, capsys):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(SPECS[1]))
    rc_t, out_t, _ = _cli(tsession, [str(path), "--mode", mode, "--device", "cpu"], capsys)
    rc_j, out_j, _ = _cli(jsession, [str(path), "--mode", mode], capsys)
    assert rc_t == rc_j == 0
    assert _streams(json.loads(out_t)) == _streams(json.loads(out_j))


@pytest.mark.parametrize("payload", [
    "{not json",
    json.dumps({"n_frames": 10}),
    json.dumps({"policy": {"name": "no_such_policy"}}),
    json.dumps({"policy": {"name": "max_utility", "params": {}}}),
    json.dumps({"policy": {"name": "track_fixed", "params": {"k": 0}}, "workload": {"kind": "track"}}),
    json.dumps({"policy": {"name": "local"}, "trace": {"kind": "piecewise", "points": [[1.0, 2.0], [0.5, 1.0]]}}),
], ids=["bad-json", "no-policy", "unknown-policy", "missing-alpha", "k-out-of-bounds", "bad-trace"])
def test_cli_malformed_spec_exits_2_with_one_line(payload, tmp_path, capsys):
    path = tmp_path / "spec.json"
    path.write_text(payload)
    for mod, extra in ((jsession, []), (tsession, ["--device", "cpu"])):
        rc, out, err = _cli(mod, [str(path), *extra], capsys)
        assert rc == 2 and out == ""
        assert err.startswith("error: ") and err.count("\n") == 1, err


def test_cli_refuses_sweep_and_a_missing_card(tmp_path, capsys, monkeypatch):
    """A fleet grid runs on the fleet engine from the CLI with the
    reference's per-point results; a missing card is refused by both
    subcommands."""
    path, grid = tmp_path / "spec.json", tmp_path / "grid.json"
    path.write_text(json.dumps(SPECS[3]))
    grid.write_text(json.dumps({"allocation": ["priority", "fifo"]}))
    rc, out, err = _cli(tsession, ["sweep", str(path), "--grid", str(grid), "--device", "cpu"], capsys)
    assert rc == 0 and err == ""
    got = json.loads(out)
    assert got["backend"] == "batched" and got["meta"]["engine"] == "sim_multi_batch"
    ref = jsession.Session(jsession.ScenarioSpec.from_json(SPECS[3])).run_sweep(
        jsession.SweepGrid.from_json(grid.read_text()), backend="reference")
    assert len(got["points"]) == len(ref.points) == 2
    for p, r in zip(got["points"], ref.points):
        assert [{k: s[k] for k in ("frames_processed", "frames_missed_deadline", "frames_offloaded",
                                   "frames_total", "schedule_calls", "accuracy_sum")} for s in p["streams"]] == [
            {k: getattr(s, k) for k in ("frames_processed", "frames_missed_deadline", "frames_offloaded",
                                        "frames_total", "schedule_calls", "accuracy_sum")} for s in r.streams]
        assert {k: p["meta"][k] for k in ("server_jobs", "grants", "denials")} == {
            k: r.meta[k] for k in ("server_jobs", "grants", "denials")}
    path.write_text(json.dumps(SPECS[0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _cli(tsession, ["sweep", str(path), "--grid", str(grid)], capsys)
    assert rc == 2 and out == "" and err.startswith("error: ") and err.count("\n") == 1
    rc, out, err = _cli(tsession, [str(path)], capsys)  # --device defaults to cuda
    assert rc == 2 and out == "" and err.startswith("error: ") and err.count("\n") == 1
    with pytest.raises(RuntimeError, match="is_available"):
        tsession.Session(tsession.ScenarioSpec.from_json(SPECS[0]))


def test_run_sweep_names_the_roadmap(tmp_path):
    """A single-stream grid runs; the compile cache the reference offers is
    accepted and recorded as the port's in-process cache, with nothing
    written to its directory."""
    session = tsession.Session(tsession.ScenarioSpec(policy="local"), device=CPU)
    assert len(session.run_sweep(tsession.SweepGrid())) == 1
    cache = tmp_path / "cache"
    report = session.run_sweep(tsession.SweepGrid(), compile_cache=str(cache))
    assert len(report) == 1 and report.meta["compile_cache"]["persistent"] is False
    assert not cache.exists()


def test_module_entry_point_runs(tmp_path):
    """``python -m repro_torch.session`` in a fresh process: lists the ten
    policies, and refuses a missing file with one line and exit 2."""
    env = {**os.environ, "PYTHONPATH": str(test_torch_ref.REPO / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.session", "--list-policies"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and len(out.stdout.split()) == 10
    out = subprocess.run([sys.executable, "-m", "repro_torch.session", str(tmp_path / "missing.json"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stderr.startswith("error: ") and out.stderr.count("\n") == 1
