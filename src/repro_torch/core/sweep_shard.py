"""Per-shape cache of the batched sweep engines' lane programs.

The reference wraps every planner program in ``LaneProgram`` (``jit(vmap(
one))``, once per shape bucket) and runs it through ``run_sharded``, which
on one device is the plain jitted program; jax then keeps each compiled
executable for the life of the process.  Here a :class:`LaneProgram` is
one shape group's round, the step function of :mod:`.sim_batch` or
:mod:`.sim_online_batch`, together with every device tensor the step
reads.  On the card the round is captured once as a CUDA graph and
replayed; on the CPU the program holds its buffers and runs the step
eagerly.

:data:`PROGRAMS` keeps programs, least recently used out past
:data:`MAX_PROGRAMS`, keyed by everything that shapes a captured graph:
the planner and its group key, every value its step reads as a Python
number (``strict``, bin counts, front widths), the function that builds
the step, the lane count rounded up to a bucket, the device, and the shape
and dtype of every buffer.  A new group with the same key copies its
inputs into the cached buffers and replays the cached graph: nothing is
captured again.  So a step reads group data only from its buffers; a
Python number it reads is baked into the captured graph, and belongs in
the key.

Lanes pad up to the bucket by repeating the last real lane, the
reference's own inert padding (lanes never interact), and the padded
lanes' results are sliced off.  A lane of zeros would not be inert: its
``n_frames = 0`` would meet ``gamma = 1 / fps`` of zero.

Only the reference's single-device path is ported (:func:`run_sharded`);
its multi-device path over a sweep mesh waits for the port's meshes.
"""
from __future__ import annotations

from collections import OrderedDict
from types import SimpleNamespace
from typing import Any, Callable, Mapping

import numpy as np
import torch

from .bucketing import quant_pow2
from .compile_cache import note

__all__ = ["LaneCache", "LaneProgram", "MAX_PROGRAMS", "PROGRAMS", "lane_bucket", "run_sharded"]

MAX_PROGRAMS = 128  # a sweep's distinct shape keys: 4-40 a policy at full width


def lane_bucket(n: int) -> int:
    """The lane count a group of ``n`` scenarios is padded to."""
    return quant_pow2(n)


def _host(a) -> np.ndarray:
    """A host array as a buffer holds it: integers widen to int64 (the
    index dtype of gather), floats and bools keep their dtype."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return np.ascontiguousarray(a)


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with its last lane repeated up to ``n`` lanes."""
    extra = n - a.shape[0]
    return a if extra == 0 else np.concatenate([a, np.repeat(a[-1:], extra, axis=0)])


class LaneProgram:
    """One shape group's round program and the device buffers it reads.

    ``build(b)`` runs once, when the program is made.  ``b`` holds the
    buffers by name, ``b.B`` (the padded lane count) and ``b.device``.  It
    returns ``(step, init)``: ``step(state)`` runs one round for every lane
    and returns the new state; ``init()`` makes a fresh round-loop state
    from the buffers, whose first entry is ``head`` (a lane is done when
    ``head >= b.n_frames``).  Neither may read a buffer's values on the
    host: a captured round never waits for the device.

    A round whose data-dependent inner loop runs a fixed number of masked
    iterations returns ``(step, init, drain)`` instead: the state's last
    entry is then a [B] bool, set where a lane's loop has iterations left,
    and ``drain(state)`` runs only that loop's next fixed number of
    iterations.  Both are captured, as two graphs on one state."""

    def __init__(self, key: tuple, device: torch.device, B: int, buffers: Mapping[str, np.ndarray],
                 build: Callable[[SimpleNamespace], tuple[Callable, ...]]):
        self.key = key
        self.device = device
        self.buffers = {k: torch.from_numpy(a).to(device) for k, a in buffers.items()}
        built = build(SimpleNamespace(B=B, device=device, **self.buffers))
        self.step, self.init = built[:2]
        self.drain_step: Callable | None = built[2] if len(built) > 2 else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.drain_graph: torch.cuda.CUDAGraph | None = None
        self.static: tuple | None = None  # the state a captured round updates in place

    def load(self, buffers: Mapping[str, np.ndarray]) -> None:
        """Copy a new group's inputs into the buffers."""
        for k, a in buffers.items():
            self.buffers[k].copy_(torch.from_numpy(a))

    def start(self) -> tuple:
        """The round-loop state for the loaded group.  On the card the first
        start captures the round as a CUDA graph."""
        state = self.init()
        if self.device.type != "cuda":
            return state
        if self.graph is None:
            self._capture(state)
        else:
            for dst, src in zip(self.static, state):
                dst.copy_(src)
        return self.static

    def round(self, state: tuple) -> tuple:
        """One round for every lane."""
        if self.graph is None:
            return self._issue(state)
        self.graph.replay()
        return state

    def drain(self, state: tuple) -> tuple:
        """The inner loop's next iterations for every lane."""
        if self.drain_graph is None:
            return self.drain_step(state)
        self.drain_graph.replay()
        return state

    def _issue(self, state: tuple) -> tuple:
        return self.step(state)

    def _capture(self, state: tuple) -> None:
        """Capture one round as a CUDA graph that updates ``self.static``
        in place.  A round is a few hundred to a few thousand small ops;
        issued eagerly each costs its host issue, ~10x its time on the card,
        and a replay issues them all at once.  Every shape in a round is
        fixed by the key, and a round never reads from the device, so the
        captured round is the round."""
        static = tuple(t.clone() for t in state)
        steps = [self._issue] + ([self.drain_step] if self.drain_step is not None else [])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture (library handles, allocator)
            for step in steps:
                step(static)
        torch.cuda.current_stream().wait_stream(side)
        graphs = []
        for step in steps:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for dst, src in zip(static, step(static)):
                    dst.copy_(src)
            graphs.append(graph)
        self.graph, self.static = graphs[0], static
        self.drain_graph = graphs[1] if len(graphs) > 1 else None
        note("captures")


class LaneCache:
    """Lane programs by key, least recently used out past ``max_entries``
    (0 keeps none: every group builds, and on the card captures, its own)."""

    def __init__(self, max_entries: int = MAX_PROGRAMS):
        self.max_entries = int(max_entries)
        self._programs: OrderedDict[tuple, LaneProgram] = OrderedDict()

    def __len__(self) -> int:
        return len(self._programs)

    def clear(self) -> None:
        self._programs.clear()

    def program(self, key: tuple, device: torch.device, lanes: Mapping[str, Any], shared: Mapping[str, Any],
                build: Callable) -> tuple[LaneProgram, bool]:
        """The program for ``key`` with this group's inputs loaded, and
        whether it came from the cache.  ``lanes`` are per-scenario arrays
        (lane axis first, every one the same length), ``shared`` the
        group's tables without a lane axis."""
        lanes = {k: _host(a) for k, a in lanes.items()}
        shared = {k: _host(a) for k, a in shared.items()}
        (n,) = {a.shape[0] for a in lanes.values()}
        B = lane_bucket(n)
        lanes = {k: _pad(a, B) for k, a in lanes.items()}
        full_key = (key, build.__module__, build.__qualname__, str(device), B,
                    tuple((k, a.shape[1:], a.dtype.str) for k, a in sorted(lanes.items())),
                    tuple((k, a.shape, a.dtype.str) for k, a in sorted(shared.items())))
        buffers = {**lanes, **shared}
        prog = self._programs.pop(full_key, None)
        hit = prog is not None
        if hit:
            note("hits")
            prog.load(buffers)
        else:
            note("misses")
            prog = LaneProgram(full_key, device, B, buffers, build)
        if self.max_entries > 0:
            self._programs[full_key] = prog
            while len(self._programs) > self.max_entries:
                self._programs.popitem(last=False)
        return prog, hit


PROGRAMS = LaneCache()  # the process's programs, as jax keeps its executables


def run_sharded(prog: LaneProgram, record: dict) -> tuple:
    """Run ``prog``'s rounds on its one device until no lane is active, and
    return the final state (padded lanes included).  The test after each
    round is that round's one read from the device; ``record`` counts the
    rounds and the reads.  A program with a drain step reads its lanes'
    "iterations left" flag in the same copy, and replays the drain while
    any lane has some: each replay, and its read of the flag, is counted
    in ``record["drain_replays"]``."""
    state = prog.start()
    n_frames = prog.buffers["n_frames"]
    if prog.drain_step is not None:
        record.setdefault("drain_replays", 0)
    while True:
        state = prog.round(state)
        record["rounds"] += 1
        record["host_reads"] += 1
        if prog.drain_step is None:
            active, left = bool((state[0] < n_frames).any()), False
        else:
            active, left = torch.stack([(state[0] < n_frames).any(), state[-1].any()]).tolist()
        while left:
            state = prog.drain(state)
            record["drain_replays"] += 1
            left = bool(state[-1].any())
        if not active:
            return state
