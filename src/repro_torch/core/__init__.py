"""FastVA core: deadline-constrained scheduling of video-analytics requests
across a fast/low-precision local path ("NPU") and an accurate/network-bound
edge path.  Plain Python and numpy, but for the ``jax_sched`` planners, which
plan with torch tensor ops on a device.

Public surface:
  profiles    ModelProfile / StreamSpec / NetworkState / paper Table II presets
  registry    PolicySpec / register_policy — every policy, by name
  max_accuracy.plan_round     — §IV Algorithm 1
  max_utility.plan_round      — §V Algorithm 2
  baselines                   — Offload / Local / DeepDecision (§VI.C)
  brute_force                 — Optimal oracle (exhaustive + grid DP + policy)
  audit                       — the plan-audit contract shared by every loop
  tracking                    — detect+track workload class (WorkloadSpec,
                                track_accuracy / track_fixed planners, oracle)
  simulator.simulate          — audited stream replay
  simulator.simulate_multi    — N streams, shared fluid uplink + server queue
  edge_server                 — multi-tenant admission/bandwidth scheduler
  jax_sched                   — both local DPs as float32 tensor programs on
                                a device (policies jax_accuracy/jax_utility),
                                their lane-batched forms and float64 twins
  sim_batch.simulate_batch    — scenario grids lane-batched on a device
  sim_multi_batch             — fleet grids (shared uplink + edge server), the same way
  sim_online_batch            — online (estimated-bandwidth) grids, the same way
  sweep_shard                 — the sweep engines' per-shape cache of lane
                                programs (captured CUDA graphs on the card)
  compile_cache               — CompileCounter over that cache
  bucketing                   — the sweep engine's shape groups
  controller.OnlineController — streaming controller w/ bandwidth estimation

Declarative scenario running (ScenarioSpec/Session) lives one level up in
``repro_torch.session``.
"""
from . import (  # noqa: F401
    audit,
    baselines,
    brute_force,
    bucketing,
    compile_cache,
    controller,
    edge_server,
    jax_sched,
    max_accuracy,
    max_utility,
    profiles,
    registry,
    schedule,
    sim_batch,
    sim_multi_batch,
    sim_online_batch,
    simulator,
    sweep_shard,
    tracking,
)
from .controller import BandwidthEstimator, OnlineController  # noqa: F401
from .edge_server import EdgeClient, EdgeServerScheduler, make_fleet  # noqa: F401
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
from .simulator import (  # noqa: F401
    MultiStreamStats,
    Trace,
    make_policy,
    simulate,
    simulate_multi,
)
from .tracking import WorkloadSpec, exhaustive_track_best  # noqa: F401
