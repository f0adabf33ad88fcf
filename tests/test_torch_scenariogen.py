"""The port's scenario generators and fault-tolerance pieces against the
reference's: every trace kind's TraceSpec JSON for the same parameters and
seed, the edge-failure OutageReport, ``degrade``, ``dead_edge_models``, and
the heartbeat / straggler / remesh logic.  Plain Python on both sides.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro import scenariogen as jgen
from repro.core import profiles as jprofiles
from repro.runtime import fault_tolerance as jft
from repro_torch import scenariogen as tgen
from repro_torch.core import profiles as tprofiles
from repro_torch.runtime import fault_tolerance as tft

KIND_PARAMS = {
    "mobility_square": [{}, {"high_mbps": 6.0, "low_mbps": 0.2, "period_s": 1.3, "duty": 0.3, "duration_s": 9.0}],
    "mobility_ramp": [{}, {"low_mbps": 0.5, "high_mbps": 7.0, "ramp_s": 3.0, "steps": 6, "dip_s": 0.25}],
    "diurnal": [{}, {"base_mbps": 4.0, "amplitude_mbps": 4.0, "period_s": 10.0, "steps": 7, "duration_s": 25.0}],
    "flash_crowd": [{}, {"seed": 3}, {"seed": 11, "n_events": 6, "event_s": 2.5, "duration_s": 20.0}],
    "edge_failure": [{}, {"fail_at_s": 1.0, "recover_at_s": 6.5, "interval_s": 0.1, "dead_after": 3.0}],
}


def test_trace_kinds_equal_reference():
    assert tgen.trace_kinds() == jgen.trace_kinds()
    assert set(KIND_PARAMS) == set(jgen.trace_kinds())


@pytest.mark.parametrize("kind", sorted(KIND_PARAMS))
def test_generated_traces_equal_reference(kind):
    for params in KIND_PARAMS[kind]:
        t, j = tgen.make_trace(kind, **params), jgen.make_trace(kind, **params)
        assert t.to_json() == j.to_json(), params
        assert t.build().at(3.7).bandwidth_bps == j.build().at(3.7).bandwidth_bps


@pytest.mark.parametrize("kind", sorted(KIND_PARAMS))
def test_make_scenario_equals_reference(kind):
    kw = dict(policy={"name": "max_utility", "params": {"alpha": 80.0}}, n_frames=45, fps=15.0,
              deadline_ms=250.0, resolutions=(90, 224), label="gen")
    assert tgen.make_scenario(kind, **kw).to_json() == jgen.make_scenario(kind, **kw).to_json()


@pytest.mark.parametrize("kind,params", [
    ("mobility_square", {"duty": 1.0}),
    ("mobility_ramp", {"steps": 1}),
    ("mobility_ramp", {"dip_s": 5.0}),
    ("diurnal", {"amplitude_mbps": 9.0}),
    ("flash_crowd", {"event_s": 20.0}),
    ("edge_failure", {"fail_at_s": 5.0, "recover_at_s": 4.0}),
    ("edge_failure", {"fail_at_s": 4.0, "recover_at_s": 4.3}),
    ("teleport", {}),
])
def test_generator_errors_equal_reference(kind, params):
    msgs = []
    for gen in (jgen, tgen):
        with pytest.raises(ValueError) as exc:
            gen.make_trace(kind, **params)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


def test_edge_failure_report_equals_reference():
    for params in KIND_PARAMS["edge_failure"]:
        t, j = tgen.edge_failure(**params), jgen.edge_failure(**params)
        assert (t.fail_at_s, t.detected_at_s, t.recovered_at_s, t.events) == \
            (j.fail_at_s, j.detected_at_s, j.recovered_at_s, j.events)
        assert t.trace.to_json() == j.trace.to_json()


def test_degrade_and_dead_edge_models_equal_reference():
    for base in ({"kind": "constant", "mbps": 3.0}, {"kind": "piecewise", "points": [[0.0, 2.0], [1.0, 5.0]]}):
        jt = jgen.degrade(jgen.traces.TraceSpec.from_json(base), [(0.5, 1.5), (2.0, 3.0)], to_mbps=0.1)
        tt = tgen.degrade(tgen.traces.TraceSpec.from_json(base), [(0.5, 1.5), (2.0, 3.0)], to_mbps=0.1)
        assert tt.to_json() == jt.to_json()
    with pytest.raises(ValueError, match="overlap"):
        tgen.degrade(tgen.make_trace("diurnal"), [(0.0, 2.0), (1.0, 3.0)])
    jm, tm = jgen.dead_edge_models(jprofiles.PAPER_MODELS), tgen.dead_edge_models(tprofiles.PAPER_MODELS)
    assert [(m.name, m.t_npu, m.t_server, m.runs_server) for m in tm] == \
        [(m.name, m.t_npu, m.t_server, m.runs_server) for m in jm]


def test_heartbeat_and_stragglers_equal_reference():
    logs = []
    for ft in (jft, tft):
        now = [0.0]
        mon = ft.HeartbeatMonitor(interval_s=1.0, suspect_after=2.0, dead_after=4.0, clock=lambda: now[0])
        mit = ft.StragglerMitigator(beta=0.4, threshold=1.4, min_samples=2)
        log = []
        for step in range(14):
            now[0] = float(step)
            for wid in ("a", "b", "c"):
                alive = not (wid == "b" and 3 <= step < 10) and not (wid == "c" and step >= 6)
                if alive:
                    mon.beat(wid)
                mit.observe(wid, 1.0 + (2.5 if wid == "c" else 0.1 * (step % 3)))
            mon.register("a")
            log.append((sorted((k, v.value) for k, v in mon.sweep().items()), mon.dead(), mit.stragglers(),
                        [mit.mitigation(w) for w in ("a", "b", "c", "z")], mit.fleet_median()))
        logs.append(log)
    assert logs[1] == logs[0]


@pytest.mark.parametrize("chips", [16, 100, 256, 511, 512, 700])
def test_elastic_remesh_equals_reference(chips):
    for kw in ({}, {"model_axis": 8, "pod_size": 64, "prior_chips": 256}):
        t, j = tft.plan_elastic_remesh(chips, **kw), jft.plan_elastic_remesh(chips, **kw)
        assert (t.mesh_shape, t.axis_names, t.dropped_chips, t.data_parallel_scale) == \
            (j.mesh_shape, j.axis_names, j.dropped_chips, j.data_parallel_scale)
    with pytest.raises(ValueError, match="cannot form a mesh"):
        tft.plan_elastic_remesh(4)
