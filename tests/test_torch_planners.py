"""The port's planners, controller and scenario specs against the reference.

Both sides are the same float64 Python/numpy arithmetic in the same order,
so every comparison here is exact: RoundPlans equal field for field, the
controller's ``estimated_bps`` bit-identical, JSON payloads equal.
"""
from __future__ import annotations

import itertools

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro import session as jsession
from repro.core import controller as jcontroller
from repro.core import profiles as jprofiles
from repro.core import registry as jregistry
from repro_torch import session as tsession
from repro_torch.core import controller as tcontroller
from repro_torch.core import profiles as tprofiles
from repro_torch.core import registry as tregistry

GRID = list(itertools.product(
    (0.5, 1.5, 2.5, 4.0, 8.0),  # Mbps
    (10.0, 30.0),  # fps
    (0.1, 0.2, 0.3),  # deadline, s
    (0.0, 0.05),  # npu_free, s
))

POLICIES = [
    ("max_accuracy", {}),
    ("max_utility", {"alpha": 200.0}),
    ("offload", {}),
    ("offload", {"alpha": 50.0}),
    ("local", {}),
    ("local", {"alpha": 50.0}),
]


def _plan_key(plan):
    return (
        tuple(
            (d.frame, d.where.value, d.model, d.resolution, d.start, d.finish)
            for d in plan.decisions
        ),
        plan.horizon,
        plan.expected_accuracy_sum,
        plan.expected_utility,
        plan.npu_busy_until,
        plan.net_busy_until,
    )


@pytest.mark.parametrize("name,params", POLICIES, ids=lambda v: str(v))
def test_round_plans_equal_reference(name, params):
    jpol = jregistry.PolicySpec(name, params).build()
    tpol = tregistry.PolicySpec(name, params).build()
    for mbps, fps, deadline, npu_free in GRID:
        jstream = jprofiles.StreamSpec(fps=fps, deadline=deadline)
        tstream = tprofiles.StreamSpec(fps=fps, deadline=deadline)
        jplan = jpol(jprofiles.PAPER_MODELS, jstream, jprofiles.network_mbps(mbps), npu_free=npu_free)
        tplan = tpol(tprofiles.PAPER_MODELS, tstream, tprofiles.network_mbps(mbps), npu_free=npu_free)
        assert _plan_key(tplan) == _plan_key(jplan), (mbps, fps, deadline, npu_free)


@pytest.mark.parametrize("policy", ["max_accuracy", "offload"])
def test_online_controller_equals_reference(policy):
    """The same upload/RTT samples give the same plans and a bit-identical
    belief (EWMA over the samples, shaded by the pessimism factor)."""
    ctrls = [
        mod.OnlineController(
            models=prof.PAPER_MODELS,
            stream=prof.StreamSpec(),
            policy=policy,
            estimator=mod.BandwidthEstimator(init_bps=3e6),
        )
        for mod, prof in ((jcontroller, jprofiles), (tcontroller, tprofiles))
    ]
    samples = [(9408.0, 0.031), (24000.0, 0.12), (0.0, 0.1), (4800.0, 0.0071), (75264.0, 0.5)]
    head = 0
    for i in range(40):
        plans = [c.next_plan(head) for c in ctrls]
        assert _plan_key(plans[1]) == _plan_key(plans[0])
        nbytes, secs = samples[i % len(samples)]
        for c in ctrls:
            c.report_upload(nbytes, secs)
            c.report_rtt(0.08 + 0.01 * (i % 3))
        jstate, tstate = ctrls[0].estimator.state(), ctrls[1].estimator.state()
        assert (tstate.bandwidth_bps, tstate.rtt) == (jstate.bandwidth_bps, jstate.rtt)
        head += max(plans[0].horizon, 1)
    assert ctrls[1].rounds == ctrls[0].rounds


SPECS = [
    {"policy": {"name": "max_accuracy", "params": {}}},
    {
        "policy": {"name": "max_utility", "params": {"alpha": 120.0}},
        "n_frames": 33,
        "stream": {"fps": 15.0, "deadline_ms": 250.0, "resolutions": [90, 224], "png_ratio": 0.4},
        "models": [
            "resnet-50",
            {"name": "tiny", "t_npu_ms": 4.0, "t_server_ms": None,
             "acc_server": {}, "acc_npu": {"224": 0.3}},
        ],
        "trace": {"kind": "piecewise", "rtt_ms": 80.0, "points": [[0.0, 2.0], [1.5, 0.5]]},
        "fleet": {"n_clients": 3, "allocation": "priority", "capacity": 2,
                  "backlog_limit": 0.5, "priorities": [0, 1, 2]},
        "workload": {"kind": "track", "decay": 0.2, "density": 2.0},
        "strict": False,
        "seed": 4,
        "label": "roundtrip",
    },
]


@pytest.mark.parametrize("payload", SPECS, ids=["minimal", "everything"])
def test_scenario_spec_json_round_trips_through_both(payload):
    if payload.get("workload", {}).get("kind") == "track":
        # A tracking workload needs a tracking policy: both packages refuse
        # it under max_utility and take it under track_accuracy.
        with pytest.raises(ValueError):
            tsession.ScenarioSpec.from_json(payload)
        with pytest.raises(ValueError):
            jsession.ScenarioSpec.from_json(payload)
        payload = {**payload, "policy": {"name": "track_accuracy", "params": {"k_max": 4}}}
    t = tsession.ScenarioSpec.from_json(payload)
    j = jsession.ScenarioSpec.from_json(payload)
    assert t.to_json() == j.to_json()
    assert jsession.ScenarioSpec.from_json(t.to_json()).to_json() == j.to_json()
    assert tsession.ScenarioSpec.from_json(j.to_json()) == t


def test_workload_and_fleet_specs_round_trip():
    for data in ({"kind": "classify"}, {"kind": "track", "decay": 0.3, "density": 0.5}):
        assert tsession.WorkloadSpec.from_json(data).to_json() == jsession.WorkloadSpec.from_json(data).to_json()
    fleet = {"n_clients": 2, "allocation": "fifo", "capacity": 1, "backlog_limit": 0.0, "weights": [1.0, 3.0]}
    assert tsession.FleetSpec.from_json(fleet).to_json() == jsession.FleetSpec.from_json(fleet).to_json()
    with pytest.raises(ValueError):
        tsession.FleetSpec(allocation="round_robin")


def test_registry_validation_matches_reference():
    for mod in (jregistry, tregistry):
        with pytest.raises(ValueError):
            mod.PolicySpec("max_utility")  # alpha required
        with pytest.raises(ValueError):
            mod.PolicySpec("max_accuracy", {"alpha": 1.0})  # no such param
        with pytest.raises(ValueError):
            mod.PolicySpec("local", {"window_frames": 2.5})  # wrong type
    assert tregistry.available_policies() == jregistry.available_policies()


# run_sweep per mode: with the compile cache (item 8), a fleet grid (item 6,
# still refused) and an online grid (item 7), and the engine each runs on.
_SWEEP_REFUSALS = {
    "sim": ({}, {"compile_cache": "cache"}, "sim_batch"),
    "multi": ({"n_clients": (1, 2)}, {}, "item 6"),
    "online": ({"deadline_ms": (150.0,)}, {"mode": "online"}, "sim_online_batch"),
}


@pytest.mark.parametrize("mode", ["sim", "multi", "online"])
def test_unported_session_modes_name_the_roadmap(mode):
    """Every mode runs; ``run_sweep`` runs single-stream and online grids
    lane-batched (the compile cache accepted), and refuses the reference's
    fleet sweep engine, naming the ROADMAP.md item that ports it."""
    spec = tsession.ScenarioSpec(policy="max_accuracy", n_frames=12)
    report = tsession.Session(spec, device="cpu").run(mode)
    assert report.mode == mode and report.stats.frames_total == 12
    axes, kw, want = _SWEEP_REFUSALS[mode]
    if want.startswith("item"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{want}"):
            tsession.Session(spec, device="cpu").run_sweep(tsession.SweepGrid(**axes), **kw)
        return
    sweep = tsession.Session(spec, device="cpu").run_sweep(tsession.SweepGrid(**axes), **kw)
    assert sweep.backend == "batched" and sweep.meta["engine"] == want and len(sweep) == 1
