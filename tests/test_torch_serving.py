"""The port's serving runtime against the reference, on the CPU.

Tolerances and why:
  * ``degrade_frame``: atol 1e-5 — both resize bilinearly with antialiasing
    on the way down, in f32, with the same triangle-kernel weights; only the
    summation order differs;
  * ``make_synthetic_video``: bit-equal (the same numpy code and seeds);
  * VideoServer on carried-across weights: frame counts, ``deadline_met_frac``
    and ``estimated_bps`` exact (the same float64 planner and estimator);
    accuracy within 2 frames, because bf16 logits can flip a near-tied top-1.
"""
from __future__ import annotations

import dataclasses
import importlib
import json

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro import serving as jserving
from repro import session as jsession
from repro.arch import classifier_forward as jforward
from repro.core import BandwidthEstimator as JEstimator
from repro.core import OnlineController as JController
from repro.core import PAPER_MODELS as J_MODELS
from repro.core.profiles import NetworkState as JNet
from repro_torch import arch as A
from repro_torch import configs, interop, quant, serving, session
from repro_torch.core import PAPER_MODELS, BandwidthEstimator, OnlineController, PolicySpec, profile_ms
from repro_torch.core.profiles import NetworkState, StreamSpec
from repro_torch.kernels.npu_matmul import ops
from repro_torch.launch import serve


@pytest.mark.parametrize("r", [45, 64, 90, 100, 134, 150, 179, 200])
def test_degrade_frame_matches_reference(r):
    f = np.random.default_rng(r).standard_normal((32, 32, 3)).astype(np.float32)
    out = serving.degrade_frame(f, r, r_ref=224, device=CPU)
    expect = jserving.degrade_frame(f, r, r_ref=224)
    assert out.shape == f.shape and out.dtype == f.dtype
    np.testing.assert_allclose(out, expect, atol=1e-5, rtol=0)


def test_degrade_frame_identity_at_full_resolution():
    f = np.random.default_rng(1).standard_normal((16, 16, 3)).astype(np.float32)
    assert serving.degrade_frame(f, 224, r_ref=224, device=CPU) is f
    assert serving.degrade_frame(f, 500, r_ref=224, device=CPU) is f


@pytest.mark.parametrize("seed,res", [(0, 32), (3, 8), (99, 16)])
def test_synthetic_video_bit_equal(seed, res):
    a = serving.make_synthetic_video(50, n_classes=7, res=res, seed=seed)
    b = jserving.make_synthetic_video(50, n_classes=7, res=res, seed=seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Toy serving stack: real VideoServer/controller, a one-matrix "model"
# ---------------------------------------------------------------------------

_RES = 8
_W = np.random.default_rng(0).standard_normal((_RES * _RES * 3, 10)).astype(np.float32)


def _toy_forward(x):
    return torch.tanh(x).reshape(x.shape[0], -1) @ torch.from_numpy(_W)


def _toy_stack(*, policy="offload", true_mbps=4.0, init_bps=None, fps=10.0, use_edge_server=False):
    prof = profile_ms(
        "toy", t_npu_ms=5.0, t_server_ms=5.0,
        acc_server={45: 0.30, 134: 0.55, 224: 0.80}, acc_npu={224: 0.60},
    )
    stream = StreamSpec(fps=fps)
    true_net = NetworkState(bandwidth_bps=true_mbps * 1e6, rtt=0.02)
    controller = OnlineController(
        models=[prof], stream=stream, policy=PolicySpec.coerce(policy),
        estimator=BandwidthEstimator(init_bps=init_bps if init_bps is not None else true_net.bandwidth_bps),
    )
    npu = serving.ModelEndpoint("toy-npu", _toy_forward, profile_latency_s=prof.t_npu, device=CPU)
    kwargs = {}
    if use_edge_server:
        ep = serving.BatchedEndpoint("toy-edge", _toy_forward, max_batch=8, device=CPU)
        ep.warmup(np.zeros((_RES, _RES, 3), np.float32))
        kwargs["edge_server"] = serving.EdgeBatchServer({0: ep})
    else:
        kwargs["edge_endpoints"] = {
            0: serving.ModelEndpoint("toy-edge", _toy_forward, profile_latency_s=prof.t_server, device=CPU)
        }
    server = serving.VideoServer(
        controller=controller, npu_endpoints={0: npu}, stream=stream, trace=true_net, device=CPU, **kwargs
    )
    frames, labels = serving.make_synthetic_video(60, n_classes=10, res=_RES, seed=3)
    return server, controller, frames, labels, true_net


@pytest.mark.parametrize("init_bps,fps", [(40e6, 10.0), (1e6, 4.0)], ids=["optimistic", "pessimistic"])
def test_estimator_converges_to_true_link(init_bps, fps):
    """The loop reports measured transfer times, so a wrong prior (10x high,
    or 4x low with a generous frame gap) converges onto the true link."""
    server, controller, frames, labels, true_net = _toy_stack(init_bps=init_bps, fps=fps)
    server.run(frames, labels)
    est = controller.estimator
    assert est.samples >= 20
    assert abs(est._bps - true_net.bandwidth_bps) / true_net.bandwidth_bps < 0.1


def test_dead_link_misses_frames_without_poisoning_the_clock():
    server, controller, frames, labels, _ = _toy_stack(init_bps=4e6)
    server._net_at = lambda t: NetworkState(bandwidth_bps=0.0, rtt=0.02)
    summary = server.run(frames, labels)
    dead = [r for r in server.results if r.where == "server"]
    assert dead and all(not r.deadline_met and not r.correct for r in dead)
    assert np.isfinite(server._net_free_abs)
    assert summary["deadline_met_frac"] < 1.0
    assert 0.0 <= controller.estimator._bps < 4e6


def test_measured_latency_includes_uplink_queueing():
    server, _, frames, labels, true_net = _toy_stack()
    server.run(frames[:10], labels[:10])
    lats = [r.latency_s for r in server.results if r.where == "server"]
    floor = min(true_net.upload_time(server.stream.frame_bytes(r)) for r in (45, 224))
    assert lats and all(lat >= floor for lat in lats)
    s = server.summary()
    assert np.isfinite(s["fps_sustained"]) and np.isfinite(s["mean_latency_s"])


def test_edge_server_batches_and_matches_endpoints():
    s1, _, frames, labels, _ = _toy_stack(use_edge_server=False)
    s2, _, _, _, _ = _toy_stack(use_edge_server=True)
    sum1, sum2 = s1.run(frames, labels), s2.run(frames, labels)
    assert sum1["accuracy"] == sum2["accuracy"]
    assert sum1["edge_frames"] == sum2["edge_frames"] > 0
    assert sum2["batch"]["flushes"] > 0 and sum2["batch"]["mean_batch"] >= 1.0


def test_batched_endpoint_padding_and_flushes_match_reference():
    w = jnp.asarray(_W)
    ref_ep = jserving.BatchedEndpoint("ref", lambda x: jnp.tanh(x).reshape(x.shape[0], -1) @ w, max_batch=6)
    ep = serving.BatchedEndpoint("port", _toy_forward, max_batch=6, device=CPU)
    assert ep.buckets == ref_ep.buckets == (1, 2, 4, 6)
    frames, _ = serving.make_synthetic_video(20, res=_RES, seed=1)
    for n in (1, 3, 5, 6, 7, 13):
        out = ep(frames[:n])
        expect = ref_ep(frames[:n])
        assert out.shape == expect.shape == (n, 10)
        np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)
    assert dataclasses.astuple(ep.stats)[:3] == dataclasses.astuple(ref_ep.stats)[:3]
    assert ep.stats.flushes == 9 and ep.stats.padded == 2  # 3 -> 4 and 5 -> 6 pad one row each
    with pytest.raises(ValueError):
        ep(frames[:0])


# ---------------------------------------------------------------------------
# The real serving loop on carried-across weights
# ---------------------------------------------------------------------------


def test_video_server_matches_reference_on_carried_weights():
    names = ("resnet-50", "squeezenet")
    stream_j, stream_t = jserving.engine.StreamSpec(), StreamSpec()
    frames, labels = serving.make_synthetic_video(30, res=32, seed=8)
    npu_j, edge_j, npu_t, edge_t = {}, {}, {}, {}
    for j, name in enumerate(names):
        arch_j, params_j, state_j = reference_params(name, seed=20 + j)
        arch_t = configs.get(name, smoke=True)
        params_t, state_t = interop.from_jax(arch_t, params_j, state_j, device=CPU)
        p_j = jax.tree.map(jnp.asarray, params_j)

        def fj(p, x, a=arch_j, s=state_j):
            return jforward(a, p, s, x, train=False)[0]

        def ft(p, x, a=arch_t, s=state_t):
            return A.classifier_forward(a, p, s, x, train=False)[0]

        nf_j = jquant.npu_forward(fj, interpret=True)
        npu_j[j] = jserving.ModelEndpoint(f"{name}-npu", lambda x, p=p_j, f=nf_j: f(p, x), profile_latency_s=0)
        edge_j[j] = jserving.ModelEndpoint(f"{name}-edge", lambda x, p=p_j, f=fj: f(p, x), profile_latency_s=0)
        nf_t = quant.npu_forward(ft)
        npu_t[j] = serving.ModelEndpoint(f"{name}-npu", lambda x, p=params_t, f=nf_t: f(p, x),
                                         profile_latency_s=0, device=CPU)
        edge_t[j] = serving.ModelEndpoint(f"{name}-edge", lambda x, p=params_t, f=ft: f(p, x),
                                          profile_latency_s=0, device=CPU)

    def controller(mod_ctrl, mod_est, models, stream):
        c = mod_ctrl(models=models, stream=stream, policy="max_accuracy", estimator=mod_est(init_bps=3e6))
        c.estimator.observe_rtt(0.1)
        return c

    sj = jserving.VideoServer(
        controller=controller(JController, JEstimator, J_MODELS, stream_j), npu_endpoints=npu_j,
        edge_endpoints=edge_j, stream=stream_j, trace=JNet(3e6, 0.1),
    ).run(frames, labels)
    launches0 = ops.int8_matmul.launches
    st = serving.VideoServer(
        controller=controller(OnlineController, BandwidthEstimator, PAPER_MODELS, stream_t),
        npu_endpoints=npu_t, edge_endpoints=edge_t, stream=stream_t, trace=NetworkState(3e6, 0.1), device=CPU,
    ).run(frames, labels)
    assert ops.int8_matmul.launches == launches0  # CPU tensors take the plain version
    for key in ("frames", "npu_frames", "edge_frames", "deadline_met_frac", "estimated_bps"):
        assert st[key] == sj[key], key
    assert st["npu_frames"] > 0 and st["edge_frames"] > 0
    assert abs(st["accuracy"] - sj["accuracy"]) * st["frames"] <= 2


# ---------------------------------------------------------------------------
# Calibration artifacts and the front door
# ---------------------------------------------------------------------------


def _tiny_calibration(seed: int = 0) -> serving.CalibrationConfig:
    return serving.CalibrationConfig(
        seed=seed,
        train_steps={"resnet-50": 2, "squeezenet": 2},
        batch_sizes=(1,),
        warmup=1,
        repeats=1,
        holdout_frames=16,
        res=16,
    )


def test_calibration_artifact_loads_in_both_packages(tmp_path):
    cfg = dataclasses.replace(_tiny_calibration(), model_names=("resnet-50",))
    cal = serving.calibrate(cfg, device=CPU)
    path = serving.save_calibration(cal.artifact, tmp_path / "port.json")
    art = jserving.load_calibration(path)
    (m,) = art["models"]
    assert art["schema"] == "repro/calibration@1" and art["backend"] == "cpu"
    assert m["provenance"]["kernel"].startswith("kernels/npu_matmul")
    assert set(m["acc_server"]) == {"45", "90", "134", "179", "224"}
    assert m["t_npu_ms"] >= 1.0 and m["t_server_ms"] >= 1.0
    pj = jsession.ScenarioSpec(policy="max_accuracy", models=art["models"], n_frames=4)
    pt = session.ScenarioSpec(policy="max_accuracy", models=serving.load_calibration(path)["models"], n_frames=4)
    assert pt.to_json() == pj.to_json()
    logits = cal.models[0].npu_endpoint(np.zeros((1, cfg.res, cfg.res, 3), np.float32))
    assert logits.shape == (1, cfg.n_classes)

    # ... and the other way: an artifact written by the reference package.
    payload = jsession._model_to_json(
        jsession.ModelProfile("edge-only", float("inf"), 0.004, {45: 0.2, 224: 0.6}, {})
    )
    ref_art = {"schema": "repro/calibration@1", "models": [payload]}
    ref_path = jserving.save_calibration(ref_art, tmp_path / "ref.json")
    loaded = serving.load_calibration(ref_path)
    spec = session.ScenarioSpec(policy="offload", models=loaded["models"], n_frames=4)
    assert spec.models[0].t_npu == float("inf") and spec.models[0].t_server == pytest.approx(0.004)
    assert json.loads(json.dumps(spec.to_json())) == jsession.ScenarioSpec.from_json(spec.to_json()).to_json()
    (tmp_path / "bad.json").write_text(json.dumps({"schema": "other", "models": [payload]}))
    with pytest.raises(ValueError):
        serving.load_calibration(tmp_path / "bad.json")


def test_run_serving_main_path_on_cpu(monkeypatch):
    """The launch CLI -> Session.run_serving -> calibrate -> VideoServer +
    EdgeBatchServer path, end to end at tiny budgets on an explicit CPU.
    Each timed call runs once and reads as 2 ms, so the plan does not hang
    on how busy the test machine's CPU is."""
    monkeypatch.setattr(serving.CalibrationConfig, "smoke", staticmethod(_tiny_calibration))
    # (the module, not the same-named function that the package re-exports)
    calibrate_module = importlib.import_module("repro_torch.serving.calibrate")
    monkeypatch.setattr(calibrate_module, "_median_s", lambda call, **kw: (call(), 0.002)[1])
    spec, device = serve.build_spec(["--frames", "20", "--bandwidth", "3.0", "--device", "cpu"])
    assert device == "cpu"
    report = session.Session(spec, device=device).run_serving()
    meta = report.meta
    assert meta["frames"] == 20 and meta["deadline_met_frac"] == 1.0
    assert meta["calibration"]["schema"] == "repro/calibration@1"
    assert all(m["t_npu_ms"] == 2.0 for m in meta["calibration"]["models"])
    assert report.stats.frames_processed == 20
    assert "batch" in meta


@pytest.mark.parametrize("entry", [
    "Session", "ModelEndpoint", "BatchedEndpoint", "VideoServer", "calibrate", "degrade_frame", "serve_main",
])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch):
    """No entry point quietly runs on the CPU: the default device is the card,
    and asking for it where there is none raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = session.ScenarioSpec(policy="max_accuracy", n_frames=4)
    calls = {
        "Session": lambda: session.Session(spec),
        "ModelEndpoint": lambda: serving.ModelEndpoint("m", _toy_forward, profile_latency_s=0.0),
        "BatchedEndpoint": lambda: serving.BatchedEndpoint("m", _toy_forward),
        "VideoServer": lambda: serving.VideoServer(
            controller=OnlineController(models=PAPER_MODELS, stream=StreamSpec()),
            npu_endpoints={}, edge_endpoints={0: None}, stream=StreamSpec(), trace=NetworkState(1e6),
        ),
        "calibrate": lambda: serving.calibrate(_tiny_calibration()),
        "degrade_frame": lambda: serving.degrade_frame(np.zeros((8, 8, 3), np.float32), 45),
        "serve_main": lambda: serve.main(["--frames", "4"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
