"""Serving entry point: stand up NPU (int8 CUDA kernel) + edge (bf16) variants of a
classifier pair, calibrate measured profiles, and run the FastVA controller
over a synthetic video.  Any classifier of ``repro_torch.configs`` serves by
name (EfficientNet-B7's int8 variant runs 219 GEMMs of the int8 kernel a
full-width forward).  A ViT's variants both run their attention in the
flash CUDA kernel; a Swin's run no kernel, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy max_accuracy \
        --frames 200 --fps 30 --bandwidth 2.0

The CLI builds a declarative ``ScenarioSpec`` and routes it through
``Session.run_serving``; ``run_scenario`` is the engine the Session calls.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import TYPE_CHECKING

import torch

from ..device import resolve_device

if TYPE_CHECKING:
    from ..session import ScenarioSpec


def run_scenario(spec: "ScenarioSpec", *, device: torch.device | str = "cuda") -> dict:
    """Build the real-model serving stack for ``spec`` on ``device`` and run it.

    The model *names* in ``spec.models`` select architectures from
    ``repro_torch.configs``; their profiles are re-measured live (latency of
    both executed variants, accuracy per offload resolution on held-out
    frames), because serving schedules against reality, not against Table II.
    """
    from ..core import BandwidthEstimator, OnlineController
    from ..serving import (
        BatchedEndpoint,
        CalibrationConfig,
        EdgeBatchServer,
        VideoServer,
        calibrate,
        make_synthetic_video,
    )
    from ..session import _model_from_json

    device = resolve_device(device)
    n_classes = 10
    res = 32
    seed = spec.seed
    trace = spec.trace.build()
    net0 = trace.at(0.0)

    smoke = spec.n_frames <= 64
    cfg = CalibrationConfig.smoke(seed=seed) if smoke else CalibrationConfig(seed=seed)
    cfg = dataclasses.replace(
        cfg,
        model_names=tuple(m.name for m in spec.models),
        n_classes=n_classes,
        res=res,
        resolutions=spec.stream.resolutions,
    )
    cal = calibrate(cfg, device=device)
    models = [_model_from_json(m.payload) for m in cal.models]
    for m in cal.artifact["models"]:
        prov = m["provenance"]
        print(
            f"{m['name']}: t_npu={m['t_npu_ms']:.1f}ms t_server={m['t_server_ms']:.1f}ms "
            f"acc_npu={max(m['acc_npu'].values()):.3f} "
            f"agreement={prov['fp32_int8_agreement']:.3f} "
            f"quant_err={prov['quant_mean_rel_err']:.4f}",
            flush=True,
        )

    frames, labels = make_synthetic_video(spec.n_frames, n_classes=n_classes, res=res, seed=seed)

    npu_eps = {j: cm.npu_endpoint for j, cm in enumerate(cal.models)}
    # Edge inference goes through the batch server: one bucket-padded forward
    # per model per round, as a shared edge GPU would take it.
    batched = {
        j: BatchedEndpoint(
            f"{cm.payload['name']}-edge-batch",
            lambda x, p=cm.params, f=cm.forward: f(p, x),
            max_batch=16,
            device=device,
        )
        for j, cm in enumerate(cal.models)
    }
    for ep in batched.values():
        ep.warmup(frames[0])
    edge_server = EdgeBatchServer(batched)

    controller = OnlineController(
        models=models,
        stream=spec.stream,
        policy=spec.policy,
        estimator=BandwidthEstimator(init_bps=net0.bandwidth_bps),
        device=device,
    )
    controller.estimator.observe_rtt(net0.rtt)
    server = VideoServer(
        controller=controller,
        npu_endpoints=npu_eps,
        stream=spec.stream,
        trace=trace,
        edge_server=edge_server,
        device=device,
    )
    summary = server.run(frames, labels)
    summary["policy"] = spec.policy.name
    summary["scheduler_rounds"] = controller.rounds
    summary["calibration"] = cal.artifact
    print(f"serve summary: { {k: v for k, v in summary.items() if k != 'calibration'} }", flush=True)
    return summary


def build_spec(argv: list[str] | None = None) -> tuple["ScenarioSpec", str]:
    """Parse the CLI into (ScenarioSpec, device)."""
    from ..core import StreamSpec
    from ..core.registry import PolicySpec, available_policies, get_policy
    from ..session import ScenarioSpec, TraceSpec

    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="max_accuracy", choices=available_policies())
    ap.add_argument("--alpha", type=float, default=200.0,
                    help="utility weight (only passed to policies that take alpha)")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--bandwidth", type=float, default=2.0, help="Mbps")
    ap.add_argument("--rtt-ms", type=float, default=100.0)
    ap.add_argument("--deadline-ms", type=float, default=200.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    needs_alpha = any(p.name == "alpha" and p.required for p in get_policy(args.policy).params)
    spec = ScenarioSpec(
        policy=PolicySpec(args.policy, {"alpha": args.alpha} if needs_alpha else {}),
        n_frames=args.frames,
        stream=StreamSpec(fps=args.fps, deadline=args.deadline_ms / 1e3),
        trace=TraceSpec(mbps=args.bandwidth, rtt_ms=args.rtt_ms),
        seed=args.seed,
        label="launch.serve",
    )
    return spec, args.device


def main(argv: list[str] | None = None) -> dict:
    from ..session import Session

    spec, device = build_spec(argv)
    return Session(spec, device=device).run_serving().meta


if __name__ == "__main__":
    main()
