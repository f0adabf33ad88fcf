"""Fault tolerance & elasticity for multi-host runs (plain Python, no tensors).

Pieces (each independently unit-tested; the training loop wires them up):

  HeartbeatMonitor    workers report liveness; missed-deadline detection with
                      a configurable grace window.  On a real cluster the
                      transport is the coordination service; here it is a
                      clock-injected in-process registry so failure scenarios
                      are simulated deterministically in tests.

  StragglerMitigator  per-step worker timing EWMAs; flags workers slower than
                      ``threshold x`` the fleet median.  Mitigation in a
                      lockstep SPMD job = redistribute input shards / replace the host
                      (not work-stealing, since SPMD steps are collective) —
                      the mitigator emits those decisions.

  plan_elastic_remesh Given surviving chips, pick the largest (pod, data,
                      model) mesh <= survivors that preserves the model axis
                      (TP degree is fixed by weight shardings), shrinking the
                      data axis — then the restart path is: restore the last
                      checkpoint with restore_resharded + skip-ahead the data
                      pipeline (both deterministic).

The FastVA tie-in: the serving tier treats an edge-pool failure exactly like
the paper treats a network outage — the controller's profile for the edge
path degrades (t_server -> inf) and Max-Accuracy/Max-Utility route frames to
the NPU path until the pool re-forms.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import defaultdict
from typing import Callable


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class _Worker:
    last_beat: float
    state: WorkerState = WorkerState.HEALTHY


class HeartbeatMonitor:
    def __init__(
        self,
        *,
        interval_s: float = 10.0,
        suspect_after: float = 2.0,  # multiples of interval
        dead_after: float = 6.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.interval = interval_s
        self.suspect_after = suspect_after * interval_s
        self.dead_after = dead_after * interval_s
        self.clock = clock
        self.workers: dict[str, _Worker] = {}

    def register(self, worker_id: str) -> None:
        """Idempotent membership: a re-registration of a known worker must not
        resurrect it — only a real heartbeat (:meth:`beat`) proves liveness."""
        if worker_id not in self.workers:
            self.workers[worker_id] = _Worker(last_beat=self.clock())

    def beat(self, worker_id: str) -> None:
        w = self.workers.setdefault(worker_id, _Worker(last_beat=self.clock()))
        w.last_beat = self.clock()
        w.state = WorkerState.HEALTHY

    def sweep(self) -> dict[str, WorkerState]:
        """Re-evaluate every worker; returns ids whose state CHANGED."""
        now = self.clock()
        changed = {}
        for wid, w in self.workers.items():
            age = now - w.last_beat
            new = (
                WorkerState.DEAD
                if age > self.dead_after
                else WorkerState.SUSPECT
                if age > self.suspect_after
                else WorkerState.HEALTHY
            )
            if new is not w.state:
                w.state = new
                changed[wid] = new
        return changed

    def dead(self) -> list[str]:
        return [w for w, s in self.workers.items() if s.state is WorkerState.DEAD]


class StragglerMitigator:
    """EWMA step-time tracking; flags persistent stragglers."""

    def __init__(self, *, beta: float = 0.3, threshold: float = 1.5, min_samples: int = 3):
        self.beta = beta
        self.threshold = threshold
        self.min_samples = min_samples
        self.ewma: dict[str, float] = {}
        self.samples: dict[str, int] = defaultdict(int)

    def observe(self, worker_id: str, step_seconds: float) -> None:
        prev = self.ewma.get(worker_id, step_seconds)
        self.ewma[worker_id] = (1 - self.beta) * prev + self.beta * step_seconds
        self.samples[worker_id] += 1

    def fleet_median(self) -> float:
        vals = sorted(self.ewma.values())
        return vals[len(vals) // 2] if vals else 0.0

    def stragglers(self) -> list[str]:
        med = self.fleet_median()
        if med <= 0:
            return []
        return [
            w
            for w, v in self.ewma.items()
            if self.samples[w] >= self.min_samples and v > self.threshold * med
        ]

    def mitigation(self, worker_id: str) -> str:
        """Decision for a flagged worker (SPMD: collective lockstep, so the
        options are input-side or replacement, never work stealing)."""
        ewma = self.ewma.get(worker_id)
        if ewma is None:
            return "observe"  # no timing data yet: gather samples first
        ratio = ewma / max(self.fleet_median(), 1e-9)
        if ratio > 3.0:
            return "replace"  # cordon host, trigger elastic remesh
        return "rebalance_input"  # shift data-loader shards away from it


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_chips: int
    data_parallel_scale: float  # new DP degree / old DP degree


def _dp_degree(chips: int, model_axis: int, pod_size: int) -> int:
    """Total data-parallel degree of the largest coherent mesh on ``chips``:
    full pods when >= 2 pods fit, otherwise whole multiples of the model axis."""
    pods = chips // pod_size
    if pods >= 2:
        return pods * (pod_size // model_axis)
    return chips // model_axis


def plan_elastic_remesh(
    surviving_chips: int,
    *,
    model_axis: int = 16,
    pod_size: int = 256,
    prior_chips: int | None = None,
) -> ElasticPlan:
    """Largest coherent mesh from the survivors.

    TP (model axis) is pinned — weight shards assume it.  We keep whole
    multiples of the model axis, preferring full pods, and shrink data
    parallelism; global batch is preserved by raising grad-accumulation in
    the training loop (batch semantics stay bit-identical).
    ``data_parallel_scale`` is measured against the mesh the cluster ran
    *before* the failure: ``prior_chips`` (default: the historical two-pod
    cluster, ``2 * pod_size``).
    """
    if surviving_chips < model_axis:
        raise ValueError(f"cannot form a mesh: {surviving_chips} chips < model axis {model_axis}")
    if prior_chips is None:
        prior_chips = 2 * pod_size
    if prior_chips < model_axis:
        raise ValueError(f"prior cluster invalid: {prior_chips} chips < model axis {model_axis}")
    old_dp = _dp_degree(prior_chips, model_axis, pod_size)
    pods = surviving_chips // pod_size
    if pods >= 2:
        data = pod_size // model_axis
        return ElasticPlan(
            (pods, data, model_axis), ("pod", "data", "model"),
            surviving_chips - pods * pod_size, pods * data / old_dp,
        )
    data = surviving_chips // model_axis
    return ElasticPlan(
        (data, model_axis), ("data", "model"), surviving_chips - data * model_axis,
        data / old_dp,
    )
