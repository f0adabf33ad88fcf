"""The port's lane-batched online engine (``core/sim_online_batch``) against
the reference, on the CPU.

The reference's contract (``src/repro/core/sim_online_batch.py:14-17``,
``tests/test_online_batch.py:42-75``): integer stats (processed / missed /
offloaded / total / planner calls) and ``rounds`` exact, ``accuracy_sum``
within ``AUDIT_TOL``, and the final believed bandwidth ``estimated_bps``
bit for bit (``==``).  Each grid runs four ways: the port's
``simulate_online_batch`` on ``device="cpu"``, the reference's
``simulate_online_batch``, and the Python ``run_online`` of both packages,
one point at a time.  The port is held to all three.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro import scenariogen as jscenariogen
from repro import session as jsession
from repro.core import controller as jcontroller
from repro.core import sim_online_batch as jonline
from repro_torch import scenariogen as tscenariogen
from repro_torch import session as tsession
from repro_torch.core import controller as tcontroller
from repro_torch.core import registry as tregistry
from repro_torch.core import sim_batch as tsim_batch
from repro_torch.core import sim_online_batch as tonline
from repro_torch.core.audit import AUDIT_TOL

CPU = "cpu"
INT_FIELDS = ("frames_total", "frames_processed", "frames_missed_deadline", "frames_offloaded",
              "schedule_calls")
# tests/test_online_batch.py:36-39: base params and the lattice's param axis
ONLINE_PARAMS = {
    "max_accuracy": ({"grid": 0.01}, {"grid": [0.01, 0.02]}),
    "max_utility": ({"alpha": 200.0}, {"alpha": [50.0, 200.0]}),
}
SQUARE = {"kind": "piecewise", "points": [[0.0, 3.5], [1.0, 0.8]], "rtt_ms": 100.0}
RTTS = {"rtt_ms": [60.0, 100.0]}


def spec_of(name: str, trace: dict, n_frames: int, params: dict | None = None) -> dict:
    return {"policy": {"name": name, "params": ONLINE_PARAMS[name][0] if params is None else params},
            "n_frames": n_frames, "trace": trace}


def scenarios(pkg, online, spec: dict, grid: dict, **kw):
    """(base spec, the engine's scenarios for every grid point) in ``pkg``."""
    base = pkg.ScenarioSpec.from_json(spec)
    specs = [pkg._apply_point(base, p) for p in pkg.SweepGrid.from_json(grid).points()]
    return base, [online.OnlineScenario(stream=s.stream, n_frames=s.n_frames, params=dict(s.policy.params),
                                        rtt=s.trace.rtt_s, bw_segments=s.trace.segments(), **kw) for s in specs]


def port_engine(name, spec, grid, groups=None, **kw):
    base, scens = scenarios(tsession, tonline, spec, grid, **kw)
    return tonline.simulate_online_batch(name, list(base.models), scens, device=CPU, groups=groups)


def reference_engine(name, spec, grid, **kw):
    base, scens = scenarios(jsession, jonline, spec, grid, **kw)
    return jonline.simulate_online_batch(name, list(base.models), scens)


def loop(pkg, spec: dict, grid: dict, **kw):
    """``run_online`` of ``pkg`` at every grid point, as (stats, meta)."""
    base = pkg.ScenarioSpec.from_json(spec)
    out = []
    for p in pkg.SweepGrid.from_json(grid).points():
        rep = pkg.Session(pkg._apply_point(base, p), **kw).run_online()
        out.append((rep.stats, rep.meta))
    return out


def assert_contract(got, want):
    assert len(got) == len(want)
    for (sg, mg), (sw, mw) in zip(got, want):
        assert [getattr(sg, f) for f in INT_FIELDS] == [getattr(sw, f) for f in INT_FIELDS]
        assert abs(sg.accuracy_sum - sw.accuracy_sum) <= AUDIT_TOL
        assert mg["rounds"] == mw["rounds"] == sg.schedule_calls
        assert mg["estimated_bps"] == mw["estimated_bps"]


def held_to_all(name, spec, grid, groups=None):
    """The port's engine against the reference's engine and both loops;
    returns the port's results."""
    got = port_engine(name, spec, grid, groups)
    assert_contract(got, reference_engine(name, spec, grid))
    assert_contract(got, loop(jsession, spec, grid))
    assert_contract(got, loop(tsession, spec, grid, device=CPU))
    return got


def fault_trace(pkg) -> dict:
    """tests/test_online_batch.py:100-108: the outage the monitor detects."""
    outage = pkg.edge_failure(fail_at_s=2.0, recover_at_s=5.0, duration_s=8.0, base_mbps=3.5)
    assert outage.detected_at_s > outage.fail_at_s
    return outage.trace.to_json()


def test_registry_flag_matches_online_backend_table():
    flagged = {n for n in tregistry.available_policies() if tregistry.get_policy(n).batched_online}
    assert set(tonline.batched_online_policies()) == flagged == set(ONLINE_PARAMS)
    assert tonline.batched_online_policies() == jonline.batched_online_policies()


@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_square_wave_equals_reference(name):
    """One shape group, the square wave, both RTTs."""
    held_to_all(name, spec_of(name, SQUARE, 45), RTTS)


@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_fault_injection_equals_reference(name):
    """A mid-run edge failure: the controller discovers the outage and the
    recovery from its own uploads."""
    assert fault_trace(tscenariogen) == fault_trace(jscenariogen)
    held_to_all(name, spec_of(name, fault_trace(tscenariogen), 180), RTTS)


@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_dead_link_from_start(name):
    """A link dead from t=0 seeds the belief at 0 bps: every round plans
    local, the belief stays 0 and never turns inf or nan."""
    got = held_to_all(name, spec_of(name, {"kind": "constant", "mbps": 0.0, "rtt_ms": 100.0}, 45), {})
    (st, meta), = got
    assert st.frames_offloaded == 0 and st.frames_missed_deadline == 0 and meta["estimated_bps"] == 0.0


def test_dead_link_mid_run_decays_the_belief():
    """A link that dies while offloads are planned observes samples of 0.0:
    the belief decays, finite, as the reference's does."""
    trace = {"kind": "piecewise", "points": [[0.0, 3.5], [0.3, 0.0]], "rtt_ms": 60.0}
    got = held_to_all("max_accuracy", spec_of("max_accuracy", trace, 60), {})
    (st, meta), = got
    assert st.frames_missed_deadline > 0 and 0.0 < meta["estimated_bps"] < 3.5e6 * 0.9


@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_golden_lattice_equals_reference(name):
    """tests/test_online_batch.py:129-143: deadlines x RTTs x a param axis
    over the square wave, several shape groups, 12 points."""
    _, axis = ONLINE_PARAMS[name]
    grid = {"deadline_ms": [150.0, 200.0, 250.0], **RTTS, "params": axis}
    groups = []
    held_to_all(name, spec_of(name, SQUARE, 90), grid, groups)
    assert len({tuple(g["key"]) for g in groups}) >= 2
    assert all(g["host_reads"] == g["rounds"] + 1 for g in groups)


def test_cap_rerun_reruns_the_whole_online_loop(monkeypatch):
    """A fast width of 2 overflows on every lane: each lane reruns its whole
    online loop at the prune cap (its estimator state diverged from the
    first round on), and the results still meet the contract."""
    monkeypatch.setattr(tsim_batch, "_UTIL_FAST_WIDTH", 2)
    groups = []
    grid = {"deadline_ms": [200.0, 350.0], **RTTS}
    got = port_engine("max_utility", spec_of("max_utility", SQUARE, 45), grid, groups)
    assert_contract(got, loop(jsession, spec_of("max_utility", SQUARE, 45), grid))
    assert [g["statics"][0] for g in groups] == [2, tsim_batch._UTIL_CAP] * 2  # each group, then its rerun
    assert [g["reruns"] for g in groups] == [2, 2, 2, 2]
    assert any(st.frames_offloaded > 0 for st, _ in got)


def test_init_bps_override_models_a_stale_belief():
    """OnlineScenario.init_bps decouples the seed from the trace: an
    optimistic stale belief over a slow link costs misses an honest seed
    avoids, identically in both packages."""
    spec, trace = spec_of("max_accuracy", {"kind": "constant", "mbps": 0.05, "rtt_ms": 100.0}, 60), {}
    stale = port_engine("max_accuracy", spec, trace, init_bps=3.5e6)
    assert_contract(stale, reference_engine("max_accuracy", spec, trace, init_bps=3.5e6))
    honest = port_engine("max_accuracy", spec, trace)
    assert stale[0][0].frames_missed_deadline > honest[0][0].frames_missed_deadline == 0
    assert stale[0][1]["estimated_bps"] < 3.5e6 * 0.9  # the misses taught it


def test_estimator_converges_on_the_square_wave():
    """After the 1 s collapse the belief leaves the 3.5 Mbps seed and
    settles in the trace's band, on the engine as in the loop."""
    (st, meta), = held_to_all("max_accuracy", spec_of("max_accuracy", SQUARE, 240), {})
    assert 0.8e6 * 0.5 < meta["estimated_bps"] < 3.5e6 * 0.9


def test_lanes_are_independent():
    """A scenario alone equals the same scenario inside a mixed group."""
    grid = {"deadline_ms": [200.0, 210.0, 220.0], **RTTS}
    spec = spec_of("max_accuracy", SQUARE, 45)
    together = port_engine("max_accuracy", spec, grid)
    base, scens = scenarios(tsession, tonline, spec, grid)
    for scen, (st, meta) in zip(scens, together):
        (alone, meta1), = tonline.simulate_online_batch("max_accuracy", list(base.models), [scen], device=CPU)
        fields = (*INT_FIELDS, "accuracy_sum", "npu_busy_s")
        assert [getattr(alone, f) for f in fields] == [getattr(st, f) for f in fields] and meta1 == meta


def test_rejects_unregistered_policy():
    models = list(tsession.ScenarioSpec(policy=tsession.PolicySpec("max_accuracy")).models)
    with pytest.raises(ValueError, match="batched online"):
        tonline.simulate_online_batch("jax_accuracy", models, [], device=CPU)
    for mod in (tonline, jonline):  # an unknown name is refused the same way
        with pytest.raises(ValueError, match="no batched online backend"):
            mod.simulate_online_batch("nope", models, [])
    assert tonline.simulate_online_batch("max_accuracy", models, [], device=CPU) == []


def test_bw_at0_follows_piecewise_semantics():
    for segs in (((0.0, 2e6),), ((0.5, 1e6), (1.0, 3e6)), ((1.0, 3e6), (0.0, 4e6)), ((-1.0, 5e6), (0.0, 6e6))):
        assert tonline._bw_at0(segs) == jonline._bw_at0(segs)


@pytest.mark.parametrize("mod", [jcontroller, tcontroller], ids=["reference", "port"])
def test_first_rtt_sample_seeds_the_belief(mod):
    """The 0.1 s default is a stub prior: the first real RTT observation
    replaces it (the engine seeds its believed RTT from the true RTT)."""
    est = mod.BandwidthEstimator()
    assert est.state().rtt == 0.1 and est.rtt_samples == 0
    est.observe_rtt(0.27)
    assert est.state().rtt == 0.27 and est.rtt_samples == 1


@pytest.mark.parametrize("mod", [jcontroller, tcontroller], ids=["reference", "port"])
def test_later_rtt_samples_blend_by_ewma(mod):
    est = mod.BandwidthEstimator(beta=0.3)
    est.observe_rtt(0.2)
    est.observe_rtt(0.1)
    assert est.state().rtt == pytest.approx(0.7 * 0.2 + 0.3 * 0.1) and est.rtt_samples == 2
