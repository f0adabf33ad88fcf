"""Property tests for the port's fleet engine, mirroring
tests/test_sim_multi_batch_properties.py on random inputs:

  * for arbitrary model profiles (server-only models and empty NPU accuracy
    tables included), fleet shapes (size, allocation, capacity, backlog
    limit, weights, priorities) and constant or piecewise shared links,
    every fleet planner through the port's ``simulate_multi_batch`` on the
    CPU reproduces the reference's ``simulate_multi`` event loop: integer
    stats exact, accuracy and server busy time within ``MULTI_TOL``,
    server jobs, grants and denials exact;
  * the fixed-point water-filling never reserves more than the link
    offers: rates are non-negative, caps are respected, and the total
    reservation stays within B.
"""
from __future__ import annotations

from types import SimpleNamespace

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import hypothesis.strategies as st
import numpy as np
import torch
from hypothesis import given, settings

from repro.core import EdgeServerScheduler, PolicySpec, Trace, make_fleet, simulate_multi
from repro.core import profiles as jprofiles
from repro.core.tracking import WorkloadSpec as JWorkload
from repro_torch.core import profiles as tprofiles
from repro_torch.core.registry import PolicySpec as TPolicySpec
from repro_torch.core.sim_multi_batch import (
    EQUIV_INT_FIELDS,
    MULTI_TOL,
    FleetScenario,
    _Physics,
    multi_batched_policies,
    simulate_multi_batch,
)
from repro_torch.core.tracking import WorkloadSpec as TWorkload

# Example counts come from the shared profiles in conftest.py
# (HYPOTHESIS_PROFILE=ci: 15, nightly: 150); settings() snapshots the active one.
SETTINGS = settings()
PARAMS = {
    "offload": lambda draw: {"alpha": draw(st.floats(1.0, 400.0))} if draw(st.booleans()) else {},
    "max_accuracy": lambda draw: {"grid": draw(st.sampled_from((1e-3, 2e-3)))},
    "max_utility": lambda draw: {"alpha": draw(st.floats(1.0, 400.0))},
    "jax_accuracy": lambda draw: {"grid": draw(st.sampled_from((1e-3, 2e-3)))},
    "jax_utility": lambda draw: {"alpha": draw(st.floats(1.0, 400.0))},
    "track_accuracy": lambda draw: {"k_max": draw(st.integers(1, 6))},
    "track_fixed": lambda draw: {"k": draw(st.integers(1, 4))},
}


@st.composite
def fleet_cases(draw):
    n_models = draw(st.integers(1, 3))
    models = []
    for i in range(n_models):
        runs_local = draw(st.booleans()) if n_models > 1 else True
        has_acc = draw(st.booleans())
        models.append(dict(
            name=f"m{i}",
            t_npu_ms=draw(st.floats(5, 250)) if runs_local else float("inf"),
            t_server_ms=draw(st.floats(5, 120)),
            acc_server={45: 0.2, 224: draw(st.floats(0.3, 0.95))},
            acc_npu={224: draw(st.floats(0.1, 0.9))} if has_acc else {},
        ))
    policy = draw(st.sampled_from(sorted(multi_batched_policies())))
    params = PARAMS[policy](draw)
    n = draw(st.integers(1, 3))
    fleet = dict(
        n_clients=n,
        allocation=draw(st.sampled_from(("weighted_fair", "priority", "fifo"))),
        capacity=draw(st.sampled_from((0, 1, 2))),
        backlog_limit=draw(st.sampled_from((0.0, 0.05))),
        weights=tuple(draw(st.floats(0.25, 4.0)) for _ in range(n)),
        priorities=tuple(draw(st.integers(0, 2)) for _ in range(n)),
    )
    stream = dict(fps=draw(st.sampled_from((10.0, 30.0))),
                  deadline=draw(st.sampled_from((100.0, 200.0, 350.0))) / 1e3)
    rtt_ms = draw(st.floats(20.0, 150.0))
    if draw(st.booleans()):
        points = ((0.0, draw(st.floats(0.2, 12.0))),)
    else:
        starts = sorted(draw(st.sets(st.sampled_from((0.0, 0.1, 0.25, 0.4, 0.8)), min_size=1, max_size=3)))
        points = tuple((t, draw(st.floats(0.2, 12.0))) for t in starts)
    return models, policy, params, stream, draw(st.sampled_from((4, 8, 12))), fleet, rtt_ms, points


@SETTINGS
@given(fleet_cases())
def test_fleet_batched_stats_equal_simulate_multi(case):
    models, policy, params, stream, n_frames, fleet, rtt_ms, points = case
    track = policy.startswith("track")
    jmodels = [jprofiles.profile_ms(**m) for m in models]
    clients = make_fleet(fleet["n_clients"], stream=jprofiles.StreamSpec(**stream), models=jmodels,
                         policy=PolicySpec(policy, params), weights=fleet["weights"],
                         priorities=fleet["priorities"])
    sched = EdgeServerScheduler(clients, policy=fleet["allocation"], capacity=fleet["capacity"],
                                backlog_limit=fleet["backlog_limit"])
    ms_ref = simulate_multi(sched, Trace.piecewise(list(points), rtt_ms=rtt_ms), n_frames,
                            workload=JWorkload(kind="track") if track else JWorkload())
    (ms, meta), = simulate_multi_batch(
        policy, [tprofiles.profile_ms(**m) for m in models],
        [FleetScenario(stream=tprofiles.StreamSpec(**stream), n_frames=n_frames,
                       bw_segments=tuple((t, v * 1e6) for t, v in points), rtt=rtt_ms / 1e3,
                       params=TPolicySpec(policy, params).params,
                       workload=TWorkload(kind="track") if track else TWorkload(), **fleet)],
        device="cpu")
    for sr, sb in zip(ms_ref.per_client, ms.per_client, strict=True):
        for f in EQUIV_INT_FIELDS:
            assert getattr(sr, f) == getattr(sb, f), (policy, fleet, points, f)
        assert abs(sr.accuracy_sum - sb.accuracy_sum) <= MULTI_TOL, (policy, fleet, points)
    assert ms.server_jobs == ms_ref.server_jobs
    assert abs(ms.server_busy_s - ms_ref.server_busy_s) <= MULTI_TOL
    assert meta == {"grants": sched.audit.grants, "denials": sched.audit.denials}


@SETTINGS
@given(n=st.integers(1, 6), data=st.data(), bandwidth=st.floats(0.0, 2e7))
def test_waterfill_reservation_never_exceeds_link(n, data, bandwidth):
    weights = np.array(data.draw(st.lists(st.floats(0.0, 5.0), min_size=n, max_size=n)), np.float64)
    active = np.array(data.draw(st.lists(st.booleans(), min_size=n, max_size=n)), bool)
    caps = np.array(data.draw(st.lists(st.floats(1e3, 1e8) | st.just(float("inf")), min_size=n, max_size=n)),
                    np.float64)
    t = lambda a: torch.as_tensor(a)[None]  # noqa: E731  (one lane)
    b = SimpleNamespace(B=1, device=torch.device("cpu"), w_fluid=t(np.maximum(weights, 1e-9)),
                        bw_t=torch.zeros(1, 1, dtype=torch.float64), bw_v=torch.full((1, 1), bandwidth),
                        nbits8=None, acc_sv=None, t_srv=None)
    rates = _Physics(b, "weighted_fair", n, 2, 4).waterfill(
        torch.tensor([bandwidth], dtype=torch.float64), t(active), t(caps))[0].numpy()
    tol = 1e-9 * max(bandwidth, 1.0)
    assert (rates >= 0.0).all()
    assert (rates[~active] == 0.0).all()
    assert (rates <= caps + tol).all()
    assert rates.sum() <= bandwidth + tol
