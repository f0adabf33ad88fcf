"""Measured-profile calibration: ModelProfiles from executing the real paths.

The paper's Table II numbers (t_npu = 52 ms for ResNet-50, etc.) were
measured on a phone NPU.  ``core.profiles.PAPER_MODELS`` keeps them as the
paper-faithful fallback; this module measures the device the port runs on:

  t_npu      median wall time of the int8 variant whose matmuls execute in
             ``kernels/npu_matmul``'s w8a8 CUDA kernel (its plain version on
             a CPU device) — real quantized arithmetic, not a constant.  A
             ViT's matmuls are plain, as in the reference; its attention
             runs ``kernels/flash_attention``'s CUDA kernel in both variants.
             A Swin's matmuls and window attention are plain too, so its
             variants differ only in their weights and launch no kernel.
  t_server   median wall time of the full-precision "edge" variant.
  acc_*      top-1 accuracy on held-out ``make_synthetic_video`` frames;
             ``acc_server[r]`` is scored on frames degraded to offload
             resolution ``r`` (``engine.degrade_frame``).

``calibrate()`` returns both the live endpoints and a JSON artifact
(``schema: "repro/calibration@1"``, the reference's schema) whose
``"models"`` entries are exactly the payload dicts ``ScenarioSpec`` accepts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .. import configs, quant
from ..arch import abstract_params as arch_params
from ..arch import classifier_forward
from ..core.profiles import PAPER_RESOLUTIONS
from ..device import resolve_device
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.npu_matmul import ops as npu_ops
from ..models.common import init_tree, tree_leaves, tree_map
from ..train import optim
from .engine import ModelEndpoint, degrade_frame, make_synthetic_video

# Default training budget per known classifier: enough to separate the
# fp32/int8 accuracy profiles on the synthetic video distribution.
TRAIN_STEPS = {"resnet-50": 150, "squeezenet": 400}

SCHEMA = "repro/calibration@1"


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Protocol knobs.  ``smoke()`` is the CI-sized variant — same code path,
    smaller training/holdout/repeat budgets."""

    model_names: tuple[str, ...] = ("resnet-50", "squeezenet")
    n_classes: int = 10
    res: int = 32  # synthetic frame H=W (smoke archs take any spatial size)
    seed: int = 0
    train_steps: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: dict(TRAIN_STEPS)
    )
    batch_sizes: tuple[int, ...] = (1, 2, 4, 8)  # serving bucket sizes to time
    warmup: int = 2  # per-shape calls before the clock starts
    repeats: int = 5  # timed calls; median reported
    holdout_frames: int = 256  # accuracy-scoring stream length
    resolutions: tuple[int, ...] | None = None  # None -> stream defaults
    r_ref: int = 224  # the paper's full offload resolution (degrade anchor)

    @staticmethod
    def smoke(seed: int = 0) -> "CalibrationConfig":
        return CalibrationConfig(
            seed=seed,
            train_steps={"resnet-50": 40, "squeezenet": 120},
            batch_sizes=(1, 2),
            warmup=1,
            repeats=2,
            holdout_frames=64,
        )


@dataclasses.dataclass
class CalibratedModel:
    """One calibrated classifier: the ScenarioSpec-loadable payload plus the
    live endpoints a serving run can deploy without retraining."""

    payload: dict[str, Any]
    npu_endpoint: ModelEndpoint  # int8 weights, kernel matmuls
    edge_endpoint: ModelEndpoint  # full precision
    forward: Callable[..., Any]  # (params, x) -> logits
    params: Any
    qparams: Any


@dataclasses.dataclass
class Calibration:
    models: list[CalibratedModel]
    artifact: dict[str, Any]  # the JSON-able result


def train_classifier(
    name: str,
    *,
    n_classes: int = 10,
    res: int = 32,
    seed: int = 0,
    steps: int | None = None,
    device: torch.device | str = "cuda",
):
    """Fit a smoke-config classifier to the synthetic video distribution so
    accuracy profiles (and the int8 drop) are real.  Returns
    ``(arch, params, state, forward, final_loss)`` with
    ``forward(params, x) -> logits`` closed over the trained state.
    Initial weights come from CPU ``torch.Generator``s seeded with ``seed``
    and ``seed + 1``, so they are the same on every device."""
    device = resolve_device(device)
    steps = steps if steps is not None else TRAIN_STEPS.get(name, 150)
    arch = configs.get(name, smoke=True)
    specs, state_specs = arch_params(arch)
    params = init_tree(torch.Generator().manual_seed(seed), specs, device=device)
    state = init_tree(torch.Generator().manual_seed(seed + 1), state_specs, device=device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    cfgopt = optim.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps, weight_decay=0.0)
    opt = optim.init_opt_state(params)
    tr_frames, tr_labels = make_synthetic_video(2048, n_classes=n_classes, res=res, seed=seed)
    tr_frames = torch.as_tensor(tr_frames, device=device)
    tr_labels = torch.as_tensor(tr_labels, dtype=torch.int64, device=device)

    rng = np.random.default_rng(7)
    loss = None
    bs = 32
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, len(tr_frames), bs), device=device)
        logits, state = classifier_forward(arch, params, state, tr_frames[idx], train=True)
        logp = F.log_softmax(logits.to(torch.float32), -1)
        loss = -torch.mean(torch.gather(logp, -1, tr_labels[idx][:, None]))
        grads = torch.autograd.grad(loss, leaves)
        optim.adamw_update(cfgopt, params, _unflatten_like(params, grads), opt)
    params = tree_map(lambda t: t.detach(), params)

    def forward(p, x, *, _arch=arch, _state=state):
        return classifier_forward(_arch, p, _state, x, train=False)[0]

    return arch, params, state, forward, float(loss.detach()) if loss is not None else float("nan")


def _unflatten_like(tree: Any, leaves) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _median_s(call: Callable[[], Any], *, warmup: int, repeats: int) -> float:
    """Median wall seconds of ``call()`` (which must wait for its result)."""
    for _ in range(max(warmup, 1)):
        call()
    ts = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _top1_acc(endpoint, frames, labels, *, chunk: int = 64) -> float:
    hits = 0
    for lo in range(0, len(frames), chunk):
        logits = endpoint(frames[lo : lo + chunk])
        hits += int(np.sum(np.argmax(logits, -1) == labels[lo : lo + chunk]))
    return hits / len(frames)


def _launches() -> dict[str, int]:
    """Launch counts of the port's CUDA kernels, by kernel."""
    return {"int8_matmul": npu_ops.int8_matmul.launches, "flash_attention": flash_ops.flash_attention.launches}


def kernel_label(device: torch.device, launches: Mapping[str, int]) -> str:
    """The kernels behind a model's timed forwards (recorded in provenance):
    on the card, the CUDA source of each kernel that ``launches`` shows
    launched; on a CPU device nothing launches and every kernel runs its
    plain version, so all of those are named."""
    root = Path(__file__).resolve().parents[1]
    sources = {"int8_matmul": npu_ops.SOURCE, "flash_attention": flash_ops.SOURCE}
    if device.type == "cuda":
        ran = [str(sources[k].relative_to(root)) for k, n in launches.items() if n > 0]
        return f"{', '.join(ran)} (cuda)"
    plain = [str((src.parents[1] / "ref.py").relative_to(root)) for src in sources.values()]
    return f"{', '.join(plain)} (plain torch, cpu)"


def calibrate_model(
    name: str, cfg: CalibrationConfig, *, device: torch.device | str = "cuda"
) -> CalibratedModel:
    """Train one classifier, build both deployment variants, measure both."""
    device = resolve_device(device)
    steps = cfg.train_steps.get(name, 150)
    arch, params, state, forward, final_loss = train_classifier(
        name, n_classes=cfg.n_classes, res=cfg.res, seed=cfg.seed, steps=steps, device=device
    )
    qparams, qstats = quant.npu_variant(params, arch_params(arch)[0])

    # The two deployment variants.  The NPU endpoint's forward is wrapped so
    # every matmul (heads, and convs via im2col) runs in the int8 kernel; the
    # weights it multiplies are the int8 fake-quant values.
    npu_fwd = quant.npu_forward(forward)
    edge = ModelEndpoint(f"{name}-edge", lambda x, p=params: forward(p, x),
                         profile_latency_s=0, device=device)
    npu = ModelEndpoint(f"{name}-npu", lambda x, p=qparams, f=npu_fwd: f(p, x),
                        profile_latency_s=0, device=device)

    # -- latency: per serving bucket size, warmup then median ---------------
    probe, _ = make_synthetic_video(
        max(cfg.batch_sizes), n_classes=cfg.n_classes, res=cfg.res, seed=cfg.seed + 17
    )
    t_npu_by_b: dict[str, float] = {}
    t_edge_by_b: dict[str, float] = {}
    launches0 = _launches()
    for b in cfg.batch_sizes:
        x = torch.as_tensor(probe[:b], device=device)
        t_npu_by_b[str(b)] = _median_s(
            lambda: npu.forward(x).cpu(), warmup=cfg.warmup, repeats=cfg.repeats
        )
        t_edge_by_b[str(b)] = _median_s(
            lambda: edge.forward(x).cpu(), warmup=cfg.warmup, repeats=cfg.repeats
        )
    timed_launches = {k: n - launches0[k] for k, n in _launches().items()}
    # The profile's scalar is the per-frame (bucket 1) time; 1 ms floor keeps
    # degenerate sub-ms smoke models from planning as free.
    t_npu_s = max(t_npu_by_b[str(min(cfg.batch_sizes))], 1e-3)
    t_server_s = max(t_edge_by_b[str(min(cfg.batch_sizes))], 1e-3)

    # -- accuracy: held-out stream, per offload resolution ------------------
    hold, hold_labels = make_synthetic_video(
        cfg.holdout_frames, n_classes=cfg.n_classes, res=cfg.res, seed=99
    )
    resolutions = cfg.resolutions or PAPER_RESOLUTIONS
    acc_npu = {str(cfg.r_ref): _top1_acc(npu, hold, hold_labels)}
    acc_server: dict[str, float] = {}
    for r in resolutions:
        deg = np.stack([degrade_frame(f, r, r_ref=cfg.r_ref, device=device) for f in hold])
        acc_server[str(r)] = _top1_acc(edge, deg, hold_labels)
    agree = quant.agreement(forward, params, qparams, torch.as_tensor(hold[:64], device=device))

    payload = {
        "name": name,
        "t_npu_ms": t_npu_s * 1e3,
        "t_server_ms": t_server_s * 1e3,
        "acc_server": acc_server,
        "acc_npu": acc_npu,
        "provenance": {
            "source": "measured",
            "backend": device.type,
            "kernel": kernel_label(device, timed_launches),
            "kernel_launches_timed": timed_launches,
            "train_steps": steps,
            "final_loss": final_loss,
            "t_npu_ms_by_batch": {b: t * 1e3 for b, t in t_npu_by_b.items()},
            "t_server_ms_by_batch": {b: t * 1e3 for b, t in t_edge_by_b.items()},
            "fp32_int8_agreement": agree,
            "quant_mean_rel_err": qstats.mean_rel_err,
            "quant_max_rel_err": qstats.max_rel_err,
            "quant_leaves": qstats.leaves_quantized,
        },
    }
    return CalibratedModel(
        payload=payload,
        npu_endpoint=npu,
        edge_endpoint=edge,
        forward=forward,
        params=params,
        qparams=qparams,
    )


def calibrate(
    cfg: CalibrationConfig | None = None, *, device: torch.device | str = "cuda"
) -> Calibration:
    """Run the full pipeline over ``cfg.model_names``."""
    device = resolve_device(device)
    cfg = cfg or CalibrationConfig()
    models = [calibrate_model(name, cfg, device=device) for name in cfg.model_names]
    artifact = {
        "schema": SCHEMA,
        "config": {
            "model_names": list(cfg.model_names),
            "n_classes": cfg.n_classes,
            "res": cfg.res,
            "seed": cfg.seed,
            "batch_sizes": list(cfg.batch_sizes),
            "warmup": cfg.warmup,
            "repeats": cfg.repeats,
            "holdout_frames": cfg.holdout_frames,
            "r_ref": cfg.r_ref,
        },
        "backend": device.type,
        "models": [m.payload for m in models],
    }
    return Calibration(models=models, artifact=artifact)


def save_calibration(artifact: dict[str, Any], path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=2, sort_keys=True))
    return path


def load_calibration(path: str | Path) -> dict[str, Any]:
    """Load + sanity-check an artifact; ``["models"]`` feeds ScenarioSpec."""
    data = json.loads(Path(path).read_text())
    if data.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a calibration artifact (schema={data.get('schema')!r})")
    if not data.get("models"):
        raise ValueError(f"{path}: calibration artifact has no models")
    return data


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="CI-sized budgets")
    ap.add_argument("--out", default="calibration.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--models", nargs="*", default=None,
                    help="classifiers of repro_torch.configs (default: resnet-50 squeezenet)")
    args = ap.parse_args(argv)

    cfg = CalibrationConfig.smoke(seed=args.seed) if args.smoke else CalibrationConfig(seed=args.seed)
    if args.models:
        cfg = dataclasses.replace(cfg, model_names=tuple(args.models))
    cal = calibrate(cfg, device=args.device)
    out = save_calibration(cal.artifact, args.out)
    for m in cal.artifact["models"]:
        print(
            f"{m['name']}: t_npu={m['t_npu_ms']:.1f}ms t_server={m['t_server_ms']:.1f}ms "
            f"acc_npu={max(m['acc_npu'].values()):.3f} acc_server@224={m['acc_server'].get('224', 0):.3f} "
            f"agreement={m['provenance']['fp32_int8_agreement']:.3f}",
            flush=True,
        )
    print(f"wrote {out}", flush=True)
    return cal.artifact


if __name__ == "__main__":
    main()
