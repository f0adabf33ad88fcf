"""FastVA serving runtime: real models behind the paper's scheduler.

Pieces:
  ModelEndpoint        a classifier forward (full-precision "edge" variant or
                       int8 "NPU" variant) on one device, with measured latency.
  BatchedEndpoint      the multi-tenant variant: pads request batches to a
                       small set of power-of-two bucket sizes.
  EdgeBatchServer      coalesces offloaded frames from many clients into ONE
                       forward per model per tick.
  VideoServer          consumes a frame stream; every round it asks the
                       OnlineController (Max-Accuracy / Max-Utility) where to
                       run each frame, executes the decisions on the REAL
                       models, advances a virtual clock with the profile's
                       network costs, and audits deadlines.
  make_synthetic_video labeled synthetic frames (class-prototype + noise) so
                       accuracy differences between variants are real.

Time model: inference latency and network transfer advance a virtual clock
(deterministic, testable); the numerics come from executing the models on the
device.  Endpoints return numpy logits: the copy to the host waits for the
device, so an endpoint's measured time covers the whole forward.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..core import OnlineController, StreamSpec
from ..core.profiles import ModelProfile, NetworkState
from ..core.schedule import Where
from ..device import resolve_device


@dataclasses.dataclass
class EndpointStats:
    calls: int = 0
    total_s: float = 0.0


class ModelEndpoint:
    """A deployed model variant; forward: (images [B,H,W,3] tensor) -> logits."""

    def __init__(self, name: str, forward: Callable[[torch.Tensor], torch.Tensor], *,
                 profile_latency_s: float, device: torch.device | str = "cuda"):
        self.name = name
        self.forward = torch.no_grad()(forward)
        self.profile_latency_s = profile_latency_s
        self.device = resolve_device(device)
        self.stats = EndpointStats()

    def __call__(self, images) -> np.ndarray:
        t0 = time.perf_counter()
        x = torch.as_tensor(images, device=self.device)
        out = self.forward(x).cpu().numpy()
        self.stats.calls += 1
        self.stats.total_s += time.perf_counter() - t0
        return out


@dataclasses.dataclass
class BatchStats:
    flushes: int = 0
    frames: int = 0
    padded: int = 0  # wasted rows added to reach a bucket size
    total_s: float = 0.0

    @property
    def mean_batch(self) -> float:
        return self.frames / self.flushes if self.flushes else 0.0

    @property
    def pad_fraction(self) -> float:
        submitted = self.frames + self.padded
        return self.padded / submitted if submitted else 0.0


class BatchedEndpoint:
    """A deployed model variant serving MANY clients per forward call.

    Batches are padded up to the next bucket size (powers of two up to
    ``max_batch``) so the device sees a small, fixed set of batch shapes;
    the pad rows are sliced off the output.  Oversized batches are split into
    ``max_batch`` chunks.
    """

    def __init__(
        self,
        name: str,
        forward: Callable[[torch.Tensor], torch.Tensor],
        *,
        profile_latency_s: float = 0.0,
        max_batch: int = 32,
        device: torch.device | str = "cuda",
    ):
        self.name = name
        self.forward = torch.no_grad()(forward)
        self.profile_latency_s = profile_latency_s
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        # max_batch itself is always a bucket: __call__ chunks by max_batch.
        self.buckets = tuple(
            b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256) if b < self.max_batch
        ) + (self.max_batch,)
        self.stats = BatchStats()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """forward over [B, H, W, C]; any B >= 1, bucket-padded internally."""
        if len(images) == 0:
            raise ValueError(f"{self.name}: empty batch (need B >= 1)")
        t0 = time.perf_counter()
        outs = []
        for lo in range(0, len(images), self.max_batch):
            chunk = images[lo : lo + self.max_batch]
            b = self._bucket(len(chunk))
            pad = b - len(chunk)
            x = torch.as_tensor(
                np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
                if pad
                else chunk,
                device=self.device,
            )
            out = self.forward(x).cpu().numpy()
            outs.append(out[: len(chunk)])
            self.stats.padded += pad
            # One flush per FORWARD, not per __call__.
            self.stats.flushes += 1
        self.stats.frames += len(images)
        self.stats.total_s += time.perf_counter() - t0
        return np.concatenate(outs)

    def warmup(self, sample: np.ndarray) -> None:
        """Run every bucket shape once so serving never pays first-call setup."""
        for b in self.buckets:
            x = np.broadcast_to(sample[None], (b, *sample.shape)).copy()
            self.forward(torch.as_tensor(x, device=self.device)).cpu()


@dataclasses.dataclass(frozen=True)
class OffloadRequest:
    """One frame a client ships to the edge (what the uplink carried)."""

    client_id: int
    frame_id: int
    model: int  # index into the shared model/profile list
    image: np.ndarray


class EdgeBatchServer:
    """Coalesces offloaded frames from N clients into one forward per model.

    ``submit`` enqueues requests as they arrive during a tick; ``flush``
    groups the queue by model, runs each group through its
    :class:`BatchedEndpoint` as a single padded batch, and returns
    ``{(client_id, frame_id): logits_row}``.
    """

    def __init__(self, endpoints: dict[int, BatchedEndpoint]):
        self.endpoints = endpoints
        self.queue: list[OffloadRequest] = []

    def submit(self, req: OffloadRequest) -> None:
        if req.model not in self.endpoints:
            raise KeyError(f"no endpoint deployed for model index {req.model}")
        self.queue.append(req)

    def flush(self) -> dict[tuple[int, int], np.ndarray]:
        by_model: dict[int, list[OffloadRequest]] = {}
        for req in self.queue:
            by_model.setdefault(req.model, []).append(req)
        results: dict[tuple[int, int], np.ndarray] = {}
        for model, reqs in by_model.items():
            batch = np.stack([r.image for r in reqs])
            logits = self.endpoints[model](batch)
            for r, row in zip(reqs, logits):
                results[(r.client_id, r.frame_id)] = row
        # Clear only after every forward succeeded, so a mid-flush failure
        # leaves the queue intact for retry instead of dropping requests.
        self.queue = []
        return results


@dataclasses.dataclass
class FrameResult:
    frame: int
    where: str
    model: str
    correct: bool
    latency_s: float
    deadline_met: bool


def make_synthetic_video(
    n_frames: int,
    *,
    n_classes: int = 10,
    res: int = 32,
    seed: int = 0,
    drift: float = 0.05,
    proto_seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """Labeled frames: class prototypes + noise, with slow scene drift.

    ``proto_seed`` fixes the class prototypes (the "world"); ``seed`` varies
    the trajectory — so train/eval/serve streams share one label space."""
    rng = np.random.default_rng(proto_seed)
    protos = rng.standard_normal((n_classes, res, res, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = np.zeros(n_frames, np.int32)
    frames = np.zeros((n_frames, res, res, 3), np.float32)
    label = int(rng.integers(n_classes))
    for i in range(n_frames):
        if rng.uniform() < drift:
            label = int(rng.integers(n_classes))
        labels[i] = label
        frames[i] = protos[label] + 0.9 * rng.standard_normal((res, res, 3)).astype(np.float32)
    return frames, labels


def degrade_frame(
    frame: np.ndarray, resolution: int, *, r_ref: int = 224, device: torch.device | str = "cuda"
) -> np.ndarray:
    """Emulate offloading at resolution ``r``: resize H×W down by the
    fraction ``r / r_ref`` and back up (bilinear, antialiased when shrinking,
    like ``jax.image.resize(..., "linear")``), so the edge model sees the
    information loss of the paper's offload resize at its native input size.
    ``r >= r_ref`` (and the NPU path, which never resizes) is the identity."""
    if resolution < 0 or resolution >= r_ref:
        return frame
    h, w = frame.shape[:2]
    frac = max(int(resolution), 1) / float(r_ref)
    hh, ww = max(1, round(h * frac)), max(1, round(w * frac))
    if (hh, ww) == (h, w):
        return frame
    x = torch.as_tensor(frame, device=resolve_device(device)).to(torch.float32).permute(2, 0, 1)[None]
    small = F.interpolate(x, size=(hh, ww), mode="bilinear", antialias=True, align_corners=False)
    big = F.interpolate(small, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    return big[0].permute(1, 2, 0).cpu().numpy().astype(frame.dtype)


class VideoServer:
    """Drives the FastVA policy over a frame stream with real model calls.

    The controller plans against its *belief* (the EWMA estimator); this
    loop executes against the TRUE link (``trace``): upload times come from
    the trace's bandwidth at the virtual send time, the uplink is serial
    (this round's uploads queue behind the previous round's tail), and the
    measured transfer time — never the plan's own estimate — is what gets
    reported back to the estimator.  Offloaded frames are degraded to the
    decision's resolution (on ``device``) before edge inference.  With
    ``edge_server`` set, edge inference coalesces into one
    :class:`BatchedEndpoint` forward per model per round.
    """

    def __init__(
        self,
        *,
        controller: OnlineController,
        npu_endpoints: dict[int, ModelEndpoint],  # model index -> NPU variant
        edge_endpoints: dict[int, ModelEndpoint] | None = None,  # -> edge variant
        stream: StreamSpec,
        trace,  # core.simulator.Trace, or a constant NetworkState
        edge_server: "EdgeBatchServer | None" = None,
        device: torch.device | str = "cuda",
    ):
        self.controller = controller
        self.npu = npu_endpoints
        self.edge = edge_endpoints or {}
        self.edge_server = edge_server
        if not self.edge and edge_server is None:
            raise ValueError("VideoServer needs edge_endpoints or an edge_server")
        self.stream = stream
        self.device = resolve_device(device)
        if isinstance(trace, NetworkState):
            self._net_at = lambda t, net=trace: net
        else:
            self._net_at = trace.at
        self.results: list[FrameResult] = []
        self.wall_s = 0.0
        self._net_free_abs = 0.0  # serial true-link occupancy (virtual clock)

    def run(self, frames: np.ndarray, labels: np.ndarray) -> dict:
        gamma, T = self.stream.gamma, self.stream.deadline
        models = self.controller.models
        r_max = self.stream.r_max
        n = len(frames)
        head = 0
        wall0 = time.perf_counter()
        while head < n:
            t0 = head * gamma
            plan = self.controller.next_plan(head)
            horizon = max(plan.horizon, 1)
            deferred: list[tuple[int, str, float, bool]] = []
            for d in plan.decisions:
                fi = head + d.frame
                if fi >= n:
                    continue
                if not d.is_processed():
                    continue
                prof: ModelProfile = models[d.model]
                arrival_abs = t0 + d.frame * gamma
                if d.where is Where.NPU:
                    logits = self.npu[d.model](frames[fi][None])
                    pred = int(np.argmax(logits[0]))
                    # NPU frames never touch the network; planned times are
                    # profile-measured, so the plan's window is the audit.
                    met = d.finish <= d.frame * gamma + T + 1e-9
                    self.results.append(
                        FrameResult(
                            frame=fi,
                            where="npu",
                            model=prof.name,
                            correct=pred == int(labels[fi]),
                            latency_s=prof.t_npu,
                            deadline_met=met,
                        )
                    )
                    continue
                # Edge path: measure the transfer on the true link.
                true_net = self._net_at(arrival_abs)
                nbytes = self.stream.frame_bytes(d.resolution)
                t_up = true_net.upload_time(nbytes)
                # The estimator observes the MEASURED upload time.
                self.controller.report_upload(nbytes, t_up)
                self.controller.report_rtt(true_net.rtt)
                if not np.isfinite(t_up):  # dead link: the frame never arrives
                    # (and must not occupy the uplink forever — leave
                    # _net_free_abs alone so a recovered trace can send)
                    self.results.append(
                        FrameResult(fi, "server", prof.name, False, float("inf"), False)
                    )
                    continue
                start = max(self._net_free_abs, t0 + max(d.start, 0.0))
                finish_abs = start + t_up + true_net.rtt + prof.t_server
                self._net_free_abs = start + t_up
                met = finish_abs <= arrival_abs + T + 1e-9
                latency = max(finish_abs - arrival_abs, 0.0)
                img = degrade_frame(frames[fi], d.resolution, r_ref=r_max, device=self.device)
                if self.edge_server is not None:
                    self.edge_server.submit(OffloadRequest(0, fi, d.model, img))
                    deferred.append((fi, prof.name, latency, met))
                else:
                    logits = self.edge[d.model](img[None])
                    pred = int(np.argmax(logits[0]))
                    self.results.append(
                        FrameResult(fi, "server", prof.name, pred == int(labels[fi]), latency, met)
                    )
            if deferred:
                out = self.edge_server.flush()
                for fi, model_name, latency, met in deferred:
                    pred = int(np.argmax(out[(0, fi)]))
                    self.results.append(
                        FrameResult(fi, "server", model_name, pred == int(labels[fi]), latency, met)
                    )
            head += horizon
        self.wall_s = time.perf_counter() - wall0
        return self.summary()

    def summary(self) -> dict:
        rs = self.results
        spec = getattr(self.controller, "policy", None)
        policy = spec.to_json() if spec is not None else None
        if not rs:
            return {"frames": 0, "policy_spec": policy}
        finite = [r.latency_s for r in rs if np.isfinite(r.latency_s)]
        out = {
            "policy_spec": policy,
            "frames": len(rs),
            "accuracy": sum(r.correct for r in rs) / len(rs),
            "npu_frames": sum(r.where == "npu" for r in rs),
            "edge_frames": sum(r.where == "server" for r in rs),
            "deadline_met_frac": sum(r.deadline_met for r in rs) / len(rs),
            "mean_latency_s": sum(finite) / len(finite) if finite else 0.0,
            "wall_s": self.wall_s,
            "fps_sustained": len(rs) / self.wall_s if self.wall_s > 0 else 0.0,
            "estimated_bps": self.controller.estimator.state().bandwidth_bps,
        }
        if self.edge_server is not None:
            bs = BatchStats()
            for ep in self.edge_server.endpoints.values():
                bs.flushes += ep.stats.flushes
                bs.frames += ep.stats.frames
                bs.padded += ep.stats.padded
                bs.total_s += ep.stats.total_s
            out["batch"] = {
                "flushes": bs.flushes,
                "mean_batch": bs.mean_batch,
                "pad_fraction": bs.pad_fraction,
            }
        return out
