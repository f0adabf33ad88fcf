"""The sweep engines' scale-out over ranks (``core/sweep_shard.run_sharded``
over ``launch.mesh.make_sweep_mesh``) against the reference's over devices.

Four gloo ranks of the port, each its own process (``torch_ranks``), run
grids of ``jax_accuracy``, ``max_utility``, an online grid (``max_utility``)
and a fleet grid (``max_accuracy``), each with one shape group of 1, 5 and 8
lanes (fewer lanes than ranks, an uneven and an even count), plus the
reference's own 4-device grid (tests/test_sweep_scale.py:240-262: five
deadlines, groups of 1-2 lanes).  The reference runs the same grids in a
subprocess over 4 forced host devices, where every lane program runs under
``shard_map``.  Every stat and every point's meta must be ``==`` across the
three: 4 ranks, the reference's 4 devices, and the port on one rank; and
every rank must hold the whole report.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from test_torch_ref import REPO  # installs the jax 0.9 shims first

from torch_ranks import run_cases, run_ranks

from repro_torch.core import sweep_shard

ONLINE_TRACE = {"kind": "piecewise", "points": [[0.0, 3.5], [1.0, 0.8]], "rtt_ms": 100.0}
FLEET = {"trace": {"kind": "constant", "mbps": 6.0}, "fleet": {"n_clients": 2, "capacity": 2}}


def cases() -> dict:
    """name -> (ScenarioSpec JSON, SweepGrid JSON, mode)."""
    out = {"jax_accuracy/equiv": ({"policy": {"name": "jax_accuracy"}, "n_frames": 12},
                                  {"deadline_ms": [10.0, 100.0, 150.0, 200.0, 350.0], "fps": [30.0]}, "auto")}
    for n in (1, 5, 8):
        out[f"jax_accuracy/{n}"] = ({"policy": {"name": "jax_accuracy"}, "n_frames": 12},
                                    {"params": {"grid": [1e-3 * (1 + i) for i in range(n)]}}, "auto")
        out[f"max_utility/{n}"] = ({"policy": {"name": "max_utility", "params": {"alpha": 200.0}}, "n_frames": 16},
                                   {"bandwidth_mbps": [0.5 + 0.75 * i for i in range(n)]}, "auto")
        out[f"online/{n}"] = ({"policy": {"name": "max_utility", "params": {"alpha": 200.0}}, "n_frames": 30,
                               "trace": ONLINE_TRACE}, {"rtt_ms": [40.0 + 15.0 * i for i in range(n)]}, "online")
        out[f"fleet/{n}"] = ({"policy": {"name": "max_accuracy"}, "n_frames": 12, **FLEET},
                             {"bandwidth_mbps": [1.0 + 1.5 * i for i in range(n)]}, "auto")
    return out


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = {paths!r}
import json
import test_torch_ref  # the jax 0.9 shims
import jax
from repro.launch.mesh import make_sweep_mesh
from repro.session import ScenarioSpec, Session, SweepGrid
from torch_ranks import report_rows
assert jax.device_count() == 4 and make_sweep_mesh().size == 4
out = {{}}
for name, (spec, grid, mode) in json.loads(sys.argv[1]).items():
    report = Session(ScenarioSpec.from_json(spec)).run_sweep(SweepGrid.from_json(grid), backend="batched", mode=mode)
    out[name] = report_rows(report)
print(json.dumps(out))
"""


def reference_rows(grid_cases: dict) -> subprocess.Popen:
    """The reference over 4 forced host devices, started in the background."""
    code = REFERENCE.format(paths=[str(REPO / "tests"), str(REPO / "src")])
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(grid_cases)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def plain(rows):
    """JSON's view of the rows (tuples as lists), as the reference's come."""
    return json.loads(json.dumps(rows))


def test_four_ranks_equal_the_reference_four_devices_and_one_rank(tmp_path):
    grid_cases = cases()
    ref = reference_rows(grid_cases)
    try:
        ranks = run_ranks(tmp_path, 4, "torch_ranks:run_cases", grid_cases)
        sweep_shard.PROGRAMS.clear()
        one = run_cases(grid_cases)
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    want = json.loads(out.strip().splitlines()[-1])
    lanes = set()
    for name in grid_cases:
        rows_one, groups_one = one[name]
        assert plain(rows_one) == want[name], name
        for r, rank in enumerate(ranks):
            rows, groups = rank[name]
            assert plain(rows) == want[name], (name, r)
            assert len(groups) == len(groups_one)
            for g, g1 in zip(groups, groups_one):
                assert g["world"] == 4 and "world" not in g1
                assert g["lanes"] == g1["lanes"] and g["rank_lanes"] == -(-g["lanes"] // 4)
                assert g["host_reads"] == g["rounds"] + 1
                lanes.add(g["lanes"])
    assert {1, 5, 8} <= lanes


def test_switch_off_and_one_rank_run_the_plain_path(tmp_path):
    """``REPRO_SWEEP_SHARD=0`` over 2 ranks, and a group of one rank: every
    rank runs every lane (no ``world`` in the records), results unchanged."""
    grid_cases = {k: v for k, v in cases().items() if k in ("max_utility/5", "fleet/5")}
    sweep_shard.PROGRAMS.clear()
    one = run_cases(grid_cases)
    off = run_ranks(tmp_path, 2, "torch_ranks:run_cases", grid_cases, env={"REPRO_SWEEP_SHARD": "0"})
    single = run_ranks(tmp_path, 1, "torch_ranks:run_cases", grid_cases)
    for name in grid_cases:
        for rank in (*off, *single):
            rows, groups = rank[name]
            assert rows == one[name][0]
            assert all("world" not in g for g in groups)


def test_sweep_cli_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.session sweep``: the CLI
    joins the group from the environment, the groups spread over both ranks,
    and rank 0 alone writes the report, equal to one process's."""
    spec, grid, _ = cases()["max_utility/5"]
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    (tmp_path / "grid.json").write_text(json.dumps(grid))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    args = ["sweep", str(tmp_path / "spec.json"), "--grid", str(tmp_path / "grid.json"), "--device", "cpu", "--out"]
    procs = [subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                               "-m", "repro_torch.session", *args, str(tmp_path / "ranks.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, "-m", "repro_torch.session", *args, str(tmp_path / "one.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    try:
        (run_out, run_err), (_, one_err) = (p.communicate(timeout=180) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, run_err[-4000:]
    assert procs[1].returncode == 0, one_err[-4000:]
    assert run_out.count("points via batched backend") == 1
    ranks, single = (json.loads((tmp_path / f).read_text()) for f in ("ranks.json", "one.json"))
    assert [g.get("world") for g in ranks["meta"]["groups"]] == [2] * len(single["meta"]["groups"])
    assert all("world" not in g for g in single["meta"]["groups"])
    drop = ("schedule_time",)
    assert [[{k: v for k, v in s.items() if k not in drop} for s in p["streams"]] for p in ranks["points"]] == [
        [{k: v for k, v in s.items() if k not in drop} for s in p["streams"]] for p in single["points"]]
