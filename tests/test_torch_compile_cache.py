"""The sweep engines' cache of lane programs (``core/sweep_shard``) and its
``CompileCounter`` (``core/compile_cache``), on the CPU.

On the CPU a cached program holds its device buffers and no CUDA graph, so
hits, misses and buffer reuse are visible here (captures stay 0; the card
tests in tests/test_torch_cuda.py count them).  The contract is the same
results with and without the cache: a chunked sweep equals the unchunked
one and a fresh process's, bit for bit in every field, for the six
single-stream policies and both online ones; a grid run after another grid
of the same shape keys equals that grid run alone; padded lanes are inert.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro_torch import session as tsession
from repro_torch.core import compile_cache, sim_batch, sim_online_batch, sweep_shard
from repro_torch.core.profiles import PAPER_MODELS, StreamSpec

CPU = "cpu"
TRACK = {"kind": "track", "decay": 0.2, "density": 1.5}


def _spec(name, params, **kw):
    out = {"policy": {"name": name, "params": params}, "n_frames": 20,
           "trace": {"kind": "constant", "mbps": 2.5, "rtt_ms": 60.0}, **kw}
    if name.startswith("track"):
        out["workload"] = TRACK
    return out


# name: (mode, spec A, grid A, spec B, grid B).  B has A's shape keys (the
# same windows, bins, resolutions, lane buckets and step constants) and
# other values: bandwidth, RTT, deadlines within one window bucket, params.
GRID_A = {"bandwidth_mbps": [1.0, 2.5], "deadline_ms": [210.0, 250.0], "fps": [30.0]}
GRID_B = {"bandwidth_mbps": [0.6, 4.0], "deadline_ms": [212.0, 260.0], "fps": [30.0]}
CASES = {
    "jax_accuracy": ("auto", _spec("jax_accuracy", {}), GRID_A, _spec("jax_accuracy", {}), GRID_B),
    "jax_utility": ("auto", _spec("jax_utility", {"alpha": 200.0}), GRID_A,
                    _spec("jax_utility", {"alpha": 120.0}), GRID_B),
    "max_accuracy": ("auto", _spec("max_accuracy", {}), GRID_A, _spec("max_accuracy", {}), GRID_B),
    "max_utility": ("auto", _spec("max_utility", {"alpha": 200.0}), GRID_A,
                    _spec("max_utility", {"alpha": 120.0}), GRID_B),
    "track_accuracy": ("auto", _spec("track_accuracy", {"k_max": 5}), GRID_A,
                       _spec("track_accuracy", {"k_max": 5, "decay": 0.3}), GRID_B),
    "track_fixed": ("auto", _spec("track_fixed", {"k": 3}), GRID_A, _spec("track_fixed", {"k": 3}), GRID_B),
    "online/max_accuracy": ("online", _spec("max_accuracy", {"grid": 0.01}), {"rtt_ms": [60.0, 100.0], **GRID_A},
                            _spec("max_accuracy", {"grid": 0.01}), {"rtt_ms": [40.0, 90.0], **GRID_B}),
    "online/max_utility": ("online", _spec("max_utility", {"alpha": 200.0}), {"rtt_ms": [60.0, 100.0], **GRID_A},
                           _spec("max_utility", {"alpha": 120.0}), {"rtt_ms": [40.0, 90.0], **GRID_B}),
}

# Runs one (mode, spec, grid, chunk_size) per case in whatever process it is
# given and prints {case: rows}; a point's row is every StreamStats field
# but the wall-clock schedule_time, then its meta.
_ROWS = r'''
import json, sys
from repro_torch import session

def rows(report):
    return [[{k: v for k, v in s.items() if k != "schedule_time"} for s in p["streams"]] + [p["meta"]]
            for p in json.loads(json.dumps(report.to_json()))["points"]]

def run(mode, spec, grid, chunk):
    return rows(session.Session(session.ScenarioSpec.from_json(spec), device="cpu").run_sweep(
        session.SweepGrid.from_json(grid), mode=mode, chunk_size=chunk))

if __name__ == "__main__":
    cases = json.loads(sys.stdin.read())
    print(json.dumps({name: run(*case) for name, case in cases.items()}))
'''
_ns: dict = {}
exec(compile(_ROWS, "rows", "exec"), _ns)
rows, run = _ns["rows"], _ns["run"]


@pytest.fixture
def fresh_cache(monkeypatch):
    cache = sweep_shard.LaneCache()
    monkeypatch.setattr(sweep_shard, "PROGRAMS", cache)
    return cache


@pytest.fixture(scope="module")
def fresh_process():
    """Every case's grid A, unchunked, in a new process."""
    payload = {name: [mode, spec, grid, None] for name, (mode, spec, grid, _, _) in CASES.items()}
    out = subprocess.run([sys.executable, "-c", _ROWS], input=json.dumps(payload), capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(test_torch_ref.REPO / "src")}, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _primary(group: dict) -> bool:
    """A shape group's first pass (not max_utility's rerun of flagged lanes
    at the prune cap, whose lane count depends on the data)."""
    return not (group["policy"] == "max_utility" and group["statics"][0] == sim_batch._UTIL_CAP)


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_equals_unchunked_equals_fresh_process(name, fresh_cache, fresh_process):
    mode, spec, grid, _, _ = CASES[name]
    whole = run(mode, spec, grid, None)
    with compile_cache.CompileCounter() as counter:
        chunked = run(mode, spec, grid, 3)
    assert whole == chunked == fresh_process[name]
    assert counter.captures == 0 and counter.hits + counter.misses >= 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_b_after_grid_a_equals_b_alone(name, fresh_cache, monkeypatch):
    """Grid B after grid A reuses A's programs (every first-pass group is
    served from the cache) and gives what B gives with an empty cache: no
    value of A stays in a program's buffers or step."""
    mode, spec_a, grid_a, spec_b, grid_b = CASES[name]
    run(mode, spec_a, grid_a, None)
    session = tsession.Session(tsession.ScenarioSpec.from_json(spec_b), device=CPU)
    with compile_cache.CompileCounter() as counter:
        report = session.run_sweep(tsession.SweepGrid.from_json(grid_b), mode=mode)
    first = [g for g in report.meta["groups"] if _primary(g)]
    assert first and all(g["cached"] for g in first) and counter.hits >= len(first)
    after_a = rows(report)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    assert after_a == run(mode, spec_b, grid_b, None)


def test_counter_counts_hits_and_misses(fresh_cache):
    """The first sweep builds one program per shape group; the same sweep
    again serves every group from the cache.  Nested counters both count;
    on the CPU nothing is captured."""
    mode, spec, grid, _, _ = CASES["max_accuracy"]
    with compile_cache.CompileCounter() as outer:
        with compile_cache.CompileCounter() as first:
            run(mode, spec, grid, None)
        with compile_cache.CompileCounter() as second:
            run(mode, spec, grid, None)
    assert first.misses == len(fresh_cache) >= 2 and first.hits == 0
    assert (second.misses, second.hits) == (0, first.misses)
    assert (outer.misses, outer.hits) == (first.misses, second.hits)
    assert outer.captures == outer.compiles == 0


def _scenarios(n: int):
    """``n`` scenarios of one shape group (30 fps, deadlines in one window
    bucket), each different."""
    return [sim_batch.BatchScenario(stream=StreamSpec(fps=30.0, deadline=0.21 + 0.005 * i), n_frames=20 + i,
                                    params={"alpha": 200.0 - 10.0 * i}, rtt=0.05 + 0.01 * i,
                                    bw_segments=((0.0, (1.0 + 0.4 * i) * 1e6),)) for i in range(n)]


@pytest.mark.parametrize("n,bucket", [(1, 1), (4, 4), (5, 8)], ids=["one", "bucket-edge", "bucket-plus-one"])
@pytest.mark.parametrize("engine", ["sim_batch", "sim_online_batch"])
def test_padded_lanes_are_inert(engine, n, bucket, fresh_cache):
    """A group of ``n`` lanes pads to its bucket by repeating the last lane;
    each lane's results equal the lane run alone (a bucket of one)."""
    scens = _scenarios(n)
    if engine == "sim_online_batch":
        scens = [sim_online_batch.OnlineScenario(stream=s.stream, n_frames=s.n_frames, params=s.params, rtt=s.rtt,
                                                 bw_segments=s.bw_segments) for s in scens]
        simulate = sim_online_batch.simulate_online_batch
    else:
        simulate = sim_batch.simulate_batch
    groups = []
    together = simulate("max_utility", PAPER_MODELS, scens, device=CPU, groups=groups)
    assert groups[0]["lanes"] == n and groups[0]["bucket"] == bucket == sweep_shard.lane_bucket(n)
    fields = ("frames_processed", "frames_missed_deadline", "frames_offloaded", "schedule_calls", "accuracy_sum",
              "npu_busy_s")
    strip = lambda r: ([getattr(r[0], f) for f in fields], r[1]) if isinstance(r, tuple) else \
        [getattr(r, f) for f in fields]  # noqa: E731
    for scen, got in zip(scens, together):
        (alone,) = simulate("max_utility", PAPER_MODELS, [scen], device=CPU)
        assert strip(alone) == strip(got)


def test_least_recently_used_program_goes_first(monkeypatch):
    """A cache bounded at two programs keeps the two used last; a bound of
    0 keeps none, and every group builds its own."""
    cache = sweep_shard.LaneCache(max_entries=2)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", cache)
    spec = _spec("jax_accuracy", {})
    grids = [{"deadline_ms": [dl], "fps": [30.0]} for dl in (100.0, 150.0, 200.0)]  # three window buckets
    with compile_cache.CompileCounter() as counter:
        for grid in grids:
            run("auto", spec, grid, None)
    assert (counter.misses, len(cache)) == (3, 2)
    with compile_cache.CompileCounter() as counter:
        run("auto", spec, grids[2], None)  # kept
        run("auto", spec, grids[0], None)  # evicted, built again; evicts grids[1]
        run("auto", spec, grids[2], None)  # kept
    assert (counter.hits, counter.misses) == (2, 1)
    none = sweep_shard.LaneCache(max_entries=0)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", none)
    with compile_cache.CompileCounter() as counter:
        run("auto", spec, grids[0], None)
        run("auto", spec, grids[0], None)
    assert (counter.hits, counter.misses, len(none)) == (0, 2, 0)


def test_compile_cache_dir_is_recorded_not_written(tmp_path, monkeypatch):
    """``compile_cache=`` and ``$REPRO_COMPILE_CACHE`` name the reference's
    persistent cache: accepted, recorded as the port's in-process cache,
    and nothing is written there."""
    path = tmp_path / "xla-cache"
    assert compile_cache.enable_compile_cache(path) == {"dir": str(path), "persistent": False, "scope": "process"}
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    assert compile_cache.default_cache_dir() is None
    session = tsession.Session(tsession.ScenarioSpec.from_json(_spec("jax_accuracy", {})), device=CPU)
    assert "compile_cache" not in session.run_sweep(tsession.SweepGrid()).meta
    report = session.run_sweep(tsession.SweepGrid(), compile_cache=str(path))
    assert report.meta["compile_cache"] == compile_cache.enable_compile_cache(path)
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(path))
    assert compile_cache.default_cache_dir() == str(path)
    report = session.run_sweep(tsession.SweepGrid(), mode="online")
    assert report.meta["compile_cache"]["dir"] == str(path)
    assert tsession.SweepReport.from_json(json.dumps(report.to_json())).meta == json.loads(
        json.dumps(report.meta))
    assert not path.exists()
