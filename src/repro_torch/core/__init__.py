"""FastVA core: deadline-constrained scheduling of video-analytics requests
across a fast/low-precision local path ("NPU") and an accurate/network-bound
edge path.  Plain Python and numpy; no tensors.

Public surface:
  profiles    ModelProfile / StreamSpec / NetworkState / paper Table II presets
  registry    PolicySpec / register_policy — every policy, by name
  max_accuracy.plan_round     — §IV Algorithm 1
  max_utility.plan_round      — §V Algorithm 2
  baselines                   — Offload / Local (§VI.C)
  simulator                   — Policy protocol and network Trace
  controller.OnlineController — streaming controller w/ bandwidth estimation
"""
from . import (  # noqa: F401
    baselines,
    controller,
    max_accuracy,
    max_utility,
    profiles,
    registry,
    schedule,
    simulator,
)
from .controller import BandwidthEstimator, OnlineController  # noqa: F401
from .profiles import (  # noqa: F401
    PAPER_MODELS,
    PAPER_STREAM,
    RESNET50,
    SQUEEZENET,
    ModelProfile,
    NetworkState,
    StreamSpec,
    network_mbps,
    profile_ms,
)
from .registry import (  # noqa: F401
    Param,
    PolicySpec,
    available_policies,
    get_policy,
    register_policy,
)
from .schedule import Decision, RoundPlan, StreamStats, Where  # noqa: F401
from .simulator import Trace  # noqa: F401
from .tracking import WorkloadSpec  # noqa: F401
