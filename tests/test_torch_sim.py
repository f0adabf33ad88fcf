"""The port's audited simulators against the reference's.

``simulate``, ``simulate_multi`` and ``Session.run_online`` are plain-Python
transcriptions, and the ``jax_*`` planners round as the reference's do, so
every comparison here is exact: integer stats equal, ``accuracy_sum`` and
the fleet and online meta bit-equal (``==``, never approx).  The port runs
on ``device="cpu"``; ``chip_smoke.py`` runs the same cases on the card
against ``SIM_GOLDENS``, which is held against the reference here.
"""
from __future__ import annotations

import sys

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

sys.path.insert(0, str(test_torch_ref.REPO))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402
from chip_smoke import POLICY_PARAMS, SIM_GOLDENS, TRACK_POLICIES  # noqa: E402

from repro import scenariogen as jscenariogen  # noqa: E402
from repro import session as jsession  # noqa: E402
from repro.core import edge_server as jedge  # noqa: E402
from repro.core import profiles as jprofiles  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import tracking as jtracking  # noqa: E402
from repro_torch import scenariogen as tscenariogen  # noqa: E402
from repro_torch import session as tsession  # noqa: E402
from repro_torch.core import edge_server as tedge  # noqa: E402
from repro_torch.core import profiles as tprofiles  # noqa: E402
from repro_torch.core import registry as tregistry  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import tracking as ttracking  # noqa: E402

CPU = "cpu"


def _stats(s):
    return (
        s.frames_total,
        s.frames_processed,
        s.frames_missed_deadline,
        s.frames_offloaded,
        s.schedule_calls,
        s.accuracy_sum,
        s.elapsed,
        s.npu_busy_s,
    )


def _workload(name: str) -> str:
    return "track" if name in TRACK_POLICIES else "classify"


@pytest.mark.parametrize("name", sorted(POLICY_PARAMS))
def test_run_sim_equals_reference_simulate(name):
    """The reference's golden setting (tests/test_session.py:218-244): the
    port's front door against the reference's ``simulate``."""
    params = POLICY_PARAMS[name]
    legacy = jsim.simulate(
        jregistry.PolicySpec(name, params).build(),
        list(jprofiles.PAPER_MODELS),
        jprofiles.PAPER_STREAM,
        jsim.Trace.constant(2.5),
        24,
        workload=jtracking.WorkloadSpec(_workload(name)),
    )
    report = tsession.Session(
        tsession.ScenarioSpec(
            policy=tregistry.PolicySpec(name, params), n_frames=24,
            trace=tsession.TraceSpec(mbps=2.5), workload=_workload(name),
        ),
        device=CPU,
    ).run_sim()
    assert report.mode == "sim" and report.meta == {"policy": name}
    assert _stats(report.stats) == _stats(legacy)


@pytest.mark.parametrize("name", sorted(POLICY_PARAMS))
def test_simulate_equals_reference_on_piecewise_trace(name):
    """Every policy over 60 frames of a varying trace at 15 fps and a 300 ms
    deadline, the plan re-audited non-strictly on one side of the grid."""
    params = POLICY_PARAMS[name]
    for strict in (True, False):
        out = []
        for prof, sim, trk, kw in (
            (jprofiles, jsim, jtracking, {}),
            (tprofiles, tsim, ttracking, {"device": CPU}),
        ):
            mod_registry = jregistry if sim is jsim else tregistry
            stats = sim.simulate(
                mod_registry.PolicySpec(name, params).build(**kw),
                list(prof.PAPER_MODELS),
                prof.StreamSpec(fps=15.0, deadline=0.3),
                sim.Trace.piecewise([(0.0, 4.0), (1.2, 1.0), (2.5, 6.0)], rtt_ms=80.0),
                60,
                strict=strict,
                workload=trk.WorkloadSpec(_workload(name), decay=0.1, density=2.0),
            )
            out.append(_stats(stats))
        assert out[1] == out[0], strict


def test_registered_policies_equal_reference():
    assert tregistry.available_policies() == jregistry.available_policies()
    assert set(tregistry.available_policies()) == set(POLICY_PARAMS)
    for name in tregistry.available_policies():
        t, j = tregistry.get_policy(name), jregistry.get_policy(name)
        assert t.workloads == j.workloads, name
        schema = [
            [(p.name, p.types, p.required, None if p.required else p.default, p.nullable, p.lo, p.hi)
             for p in e.params]
            for e in (t, j)
        ]
        assert schema[0] == schema[1], name
        assert t.takes_device == name.startswith("jax_"), name


# 3 clients at capacity 4 (tests/test_session.py:256-275) under each
# allocation policy, with weights, priorities and a backlog gate, and fleets
# of the other planners (DeepDecision offloads non-head frames; the track
# fleets carry detections over the shared link).
FLEETS = [
    ("weighted_fair", "max_accuracy", 12.0, {}),
    ("priority", "max_accuracy", 12.0, {"priorities": (0, 1, 2)}),
    ("fifo", "max_accuracy", 12.0, {}),
    ("weighted_fair", "offload", 8.0, {"weights": (1.0, 2.0, 1.0)}),
    ("priority", "max_utility", 6.0, {"priorities": (2, 0, 1), "backlog_limit": 0.1}),
    ("weighted_fair", "deepdecision", 20.0, {}),
    ("weighted_fair", "jax_utility", 12.0, {}),
    ("weighted_fair", "track_accuracy", 30.0, {}),
    ("fifo", "track_fixed", 60.0, {}),
    ("priority", "track_accuracy", 45.0, {"priorities": (1, 0, 1)}),
]


@pytest.mark.parametrize("alloc,name,mbps,opts", FLEETS, ids=lambda v: str(v))
def test_simulate_multi_equals_reference(alloc, name, mbps, opts):
    runs = []
    for edge, sim, trk, prof, kw in (
        (jedge, jsim, jtracking, jprofiles, {}),
        (tedge, tsim, ttracking, tprofiles, {"device": CPU}),
    ):
        registry = jregistry if sim is jsim else tregistry
        clients = edge.make_fleet(
            3,
            policy=registry.PolicySpec(name, POLICY_PARAMS[name]),
            weights=opts.get("weights"),
            priorities=opts.get("priorities"),
            **kw,
        )
        sched = edge.EdgeServerScheduler(
            clients, policy=alloc, capacity=4, backlog_limit=opts.get("backlog_limit", 0.0)
        )
        ms = sim.simulate_multi(
            sched, sim.Trace.constant(mbps), 24, workload=trk.WorkloadSpec(_workload(name))
        )
        a = sched.audit
        runs.append((
            [_stats(s) for s in ms.per_client],
            ms.server_jobs, ms.server_busy_s, ms.elapsed, ms.server_utilization,
            ms.aggregate_accuracy, ms.miss_rates,
            a.grants, a.denials, a.max_concurrent_bps, a.max_concurrent_jobs,
            sched.leases, sched.server_busy_until,
        ))
    assert runs[1] == runs[0]


ONLINE = [
    ("max_accuracy", {"n_frames": 90, "trace": {"kind": "piecewise", "points": [[0.0, 3.5], [1.0, 0.8]]}}),
    ("max_utility", {"n_frames": 120, "trace": {"kind": "piecewise", "points": [[0.0, 1.0], [2.0, 6.0]]}}),
    ("offload", {"n_frames": 60, "trace": {"kind": "constant", "mbps": 5.0, "rtt_ms": 60.0}}),
    ("deepdecision", {"n_frames": 90, "trace": {"kind": "constant", "mbps": 20.0}}),
    ("jax_accuracy", {"n_frames": 48, "trace": {"kind": "constant", "mbps": 2.5}}),
    ("brute_force", {"n_frames": 30, "trace": {"kind": "piecewise", "points": [[0.0, 6.0], [0.5, 1.5]]}}),
]


@pytest.mark.parametrize("name,spec", ONLINE, ids=[n for n, _ in ONLINE])
def test_run_online_equals_reference(name, spec):
    """Stats, rounds, and the estimator's belief bit for bit."""
    payload = {"policy": {"name": name, "params": POLICY_PARAMS[name]}, **spec}
    j = jsession.Session(jsession.ScenarioSpec.from_json(payload)).run_online()
    t = tsession.Session(tsession.ScenarioSpec.from_json(payload), device=CPU).run_online()
    assert _stats(t.stats) == _stats(j.stats)
    assert t.meta == j.meta
    assert t.meta["rounds"] == t.stats.schedule_calls > 0


@pytest.mark.parametrize("kind", jscenariogen.trace_kinds())
def test_run_online_on_generated_traces_equals_reference(kind):
    j = jsession.Session(jscenariogen.make_scenario(kind, policy="max_accuracy", n_frames=150)).run_online()
    t = tsession.Session(
        tscenariogen.make_scenario(kind, policy="max_accuracy", n_frames=150), device=CPU
    ).run_online()
    assert _stats(t.stats) == _stats(j.stats)
    assert t.meta["estimated_bps"] == j.meta["estimated_bps"]
    assert t.meta == j.meta


def test_run_online_refuses_tracking_like_reference():
    payload = {"policy": {"name": "track_accuracy", "params": {}}, "workload": {"kind": "track"}}
    with pytest.raises(ValueError, match="tracking workload"):
        jsession.Session(jsession.ScenarioSpec.from_json(payload)).run_online()
    with pytest.raises(ValueError, match="tracking workload"):
        tsession.Session(tsession.ScenarioSpec.from_json(payload), device=CPU).run_online()


def test_run_multi_meta_equals_reference():
    payload = {
        "policy": {"name": "max_utility", "params": {"alpha": 200.0}},
        "n_frames": 36,
        "trace": {"kind": "piecewise", "points": [[0.0, 12.0], [0.6, 3.0]]},
        "fleet": {"n_clients": 4, "allocation": "priority", "capacity": 2, "priorities": [0, 1, 1, 2]},
    }
    j = jsession.Session(jsession.ScenarioSpec.from_json(payload)).run_multi()
    t = tsession.Session(tsession.ScenarioSpec.from_json(payload), device=CPU).run_multi()
    assert [_stats(s) for s in t.streams] == [_stats(s) for s in j.streams]
    assert t.meta == j.meta
    assert t.to_json()["aggregate_accuracy"] == j.to_json()["aggregate_accuracy"]


def test_sim_goldens_equal_reference():
    """chip_smoke.py holds the card against SIM_GOLDENS: the table must be
    what the reference computes now."""
    table, _ = chip_smoke.sim_table(
        jsession, jscenariogen, lambda spec, mode: jsession.Session(spec).run(mode)
    )
    assert table == SIM_GOLDENS


def test_sim_goldens_equal_port_on_cpu():
    table, reports = chip_smoke.sim_table(
        tsession, tscenariogen, lambda spec, mode: tsession.Session(spec, device=CPU).run(mode)
    )
    assert table == SIM_GOLDENS
    assert "sim/jax_utility" in chip_smoke.planning_ms(reports)


def test_make_policy_shim_warns_and_builds():
    with pytest.warns(DeprecationWarning):
        pol = tsim.make_policy("jax_utility", alpha=200.0, device=CPU)
    assert pol.spec == tregistry.PolicySpec("jax_utility", {"alpha": 200.0})
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        tsim.make_policy("max_utility")  # alpha is required
