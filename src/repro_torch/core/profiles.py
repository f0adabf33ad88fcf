"""Model/stream/network profiles — the scheduler's world model.

All the quantities in the paper's Table I live here:

  T_j^npu   ModelProfile.t_npu           (seconds; local quantized path)
  T_j^o     ModelProfile.t_server        (seconds; edge full-precision path)
  a(j, r)   ModelProfile.accuracy(r)     (piecewise-linear in resolution)
  S(I, r)   StreamSpec.frame_bytes(r)    (PNG-calibrated byte model)
  B, T_c    NetworkState.bandwidth_bps / .rtt
  f, gamma  StreamSpec.fps / .gamma
  T         StreamSpec.deadline

Times are SECONDS everywhere in core/.  Profile constructors accept ms for
readability (`*_ms` kwargs) because the paper speaks in ms.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

# Paper §VI: 5 candidate offload resolutions, deadline 200 ms.
PAPER_RESOLUTIONS: tuple[int, ...] = (45, 90, 134, 179, 224)
PAPER_DEADLINE_S: float = 0.200

# Byte model calibration: PNG ≈ 0.5 × raw RGB.  At B = 2.5 Mbps this gives
# 224px → 241 ms and 90px → 38.9 ms, matching Table II's "39 - 242 ms".
PNG_RATIO: float = 0.5


def frame_bytes(resolution: int, png_ratio: float = PNG_RATIO) -> float:
    """S(I, r): bytes of one video frame resized to ``resolution``²."""
    return float(resolution) * float(resolution) * 3.0 * png_ratio


@dataclass(frozen=True)
class ModelProfile:
    """One CNN model the scheduler can pick (paper's index j).

    ``acc_server``/``acc_npu`` map resolution -> accuracy; the NPU path always
    runs at the maximum resolution (paper §V.B: local frames are not resized)
    so only ``acc_npu[r_max]`` is consulted for local decisions.
    """

    name: str
    t_npu: float  # T_j^npu, seconds; inf if the model cannot run locally
    t_server: float  # T_j^o, seconds; inf if not deployed on the edge
    acc_server: Mapping[int, float] = field(default_factory=dict)
    acc_npu: Mapping[int, float] = field(default_factory=dict)

    @property
    def runs_local(self) -> bool:
        return self.t_npu != float("inf")

    @property
    def runs_server(self) -> bool:
        return self.t_server != float("inf")

    def accuracy(self, resolution: int, *, where: str) -> float:
        """a(j, r) with piecewise-linear interpolation between profiled points."""
        table = self.acc_server if where == "server" else self.acc_npu
        if not table:
            return 0.0
        keys = sorted(table)
        if resolution in table:
            return float(table[resolution])
        if resolution <= keys[0]:
            return float(table[keys[0]])
        if resolution >= keys[-1]:
            return float(table[keys[-1]])
        hi = bisect.bisect_left(keys, resolution)
        r0, r1 = keys[hi - 1], keys[hi]
        a0, a1 = table[r0], table[r1]
        w = (resolution - r0) / (r1 - r0)
        return float(a0 + w * (a1 - a0))


def profile_ms(
    name: str,
    *,
    t_npu_ms: float = float("inf"),
    t_server_ms: float = float("inf"),
    acc_server: Mapping[int, float] | None = None,
    acc_npu: Mapping[int, float] | None = None,
) -> ModelProfile:
    return ModelProfile(
        name=name,
        t_npu=t_npu_ms / 1e3,
        t_server=t_server_ms / 1e3,
        acc_server=dict(acc_server or {}),
        acc_npu=dict(acc_npu or {}),
    )


@dataclass(frozen=True)
class StreamSpec:
    """The video stream the application hands us (paper's f, gamma, T, r set)."""

    fps: float = 30.0
    deadline: float = PAPER_DEADLINE_S  # T, seconds
    resolutions: tuple[int, ...] = PAPER_RESOLUTIONS
    png_ratio: float = PNG_RATIO

    @property
    def gamma(self) -> float:
        return 1.0 / self.fps

    @property
    def r_max(self) -> int:
        return max(self.resolutions)

    def frame_bytes(self, resolution: int) -> float:
        return frame_bytes(resolution, self.png_ratio)


@dataclass(frozen=True)
class NetworkState:
    """Link between serving tier and edge pool (paper's B and T_c)."""

    bandwidth_bps: float  # B, payload bits per second
    rtt: float = 0.100  # T_c, seconds

    @property
    def bandwidth_mbps(self) -> float:
        return self.bandwidth_bps / 1e6

    def upload_time(self, nbytes: float) -> float:
        if self.bandwidth_bps <= 0:
            return float("inf")
        return nbytes * 8.0 / self.bandwidth_bps


def network_mbps(mbps: float, rtt_ms: float = 100.0) -> NetworkState:
    return NetworkState(bandwidth_bps=mbps * 1e6, rtt=rtt_ms / 1e3)


# ---------------------------------------------------------------------------
# Paper-faithful profiles (Table II + Fig. 4 shape).  Fig. 4 is not published
# numerically; the curves below are monotone, concave, anchored at Table II's
# 224px values, and reproduce its qualitative shape ("accuracy does not scale
# linearly with the resolution").
#
# These are the FALLBACK when no measured profile exists: they are typed-in
# constants from the paper's hardware, not this host's.  For profiles measured
# by executing the int8 CUDA-kernel path vs the full-precision edge path on
# the card, run ``repro_torch.serving.calibrate`` and load its JSON artifact
# through ``ScenarioSpec``.
# ---------------------------------------------------------------------------

RESNET50 = profile_ms(
    "resnet-50",
    t_npu_ms=52.0,
    t_server_ms=69.0,
    acc_server={45: 0.20, 90: 0.42, 134: 0.56, 179: 0.63, 224: 0.67},
    acc_npu={224: 0.52},
)

SQUEEZENET = profile_ms(
    "squeezenet",
    t_npu_ms=17.0,
    t_server_ms=9.0,
    acc_server={45: 0.12, 90: 0.29, 134: 0.40, 179: 0.47, 224: 0.51},
    acc_npu={224: 0.41},
)

PAPER_MODELS: tuple[ModelProfile, ...] = (RESNET50, SQUEEZENET)
PAPER_STREAM = StreamSpec()


def scale_profile(p: ModelProfile, *, npu_speedup: float = 1.0, acc_delta: float = 0.0) -> ModelProfile:
    """Utility for ablations: perturb a profile without rebuilding tables."""
    acc_npu = {r: max(0.0, min(1.0, a + acc_delta)) for r, a in p.acc_npu.items()}
    return replace(p, t_npu=p.t_npu / npu_speedup, acc_npu=acc_npu)


def best_server_model(
    models: Sequence[ModelProfile], resolution: int, budget: float
) -> tuple[int, float] | None:
    """Paper §IV.B.1: highest-accuracy server model with T_j^o <= budget.

    Returns (model_index, accuracy) or None if no model fits the budget.
    """
    best: tuple[int, float] | None = None
    for j, m in enumerate(models):
        if not m.runs_server or m.t_server > budget:
            continue
        a = m.accuracy(resolution, where="server")
        if best is None or a > best[1]:
            best = (j, a)
    return best
