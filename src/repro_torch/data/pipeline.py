"""Deterministic synthetic data pipeline with restart skip-ahead.

Batches are a pure function of (seed, step) — counter-mode generation — so:
  * restart at step N reproduces the exact stream without replaying N steps;
  * elastic restarts re-slice the same global batch;
  * prefetch is a bounded background thread (host-side), overlapping batch
    synthesis with device compute.

``SyntheticStream.batch_at`` makes the same numpy calls in the same order
as the reference's, so its batches are bitwise the reference's.  Batches
are numpy arrays: the caller turns them into tensors on its device, on its
own thread.  A storage-backed reader would keep the same (seed, step) ->
batch contract.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from ..arch import Arch, ShapeSpec, input_specs


@dataclasses.dataclass(frozen=True)
class DataSpec:
    arch: Arch
    shape: ShapeSpec
    seed: int = 0


class SyntheticStream:
    """Counter-mode synthetic batches matching input_specs(arch, shape)."""

    def __init__(self, spec: DataSpec):
        self.spec = spec
        self._specs = input_specs(spec.arch, spec.shape)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.uint64(self.spec.seed) + np.uint64(step) * np.uint64(2654435761))
        out: dict[str, np.ndarray] = {}
        arch = self.spec.arch
        for name, s in sorted(self._specs.items()):
            if not s.dtype.is_floating_point:
                hi = arch.cfg.vocab if arch.family == "lm" else getattr(arch.cfg, "n_classes", 1000)
                out[name] = rng.integers(0, hi, size=s.shape, dtype=np.int32)
            elif name == "t":
                out[name] = rng.uniform(0.02, 0.98, size=s.shape).astype(np.float32)
            elif name == "dt":
                out[name] = np.full(s.shape, 0.02, np.float32)
            elif name == "guidance":
                out[name] = np.full(s.shape, 4.0, np.float32)
            else:
                out[name] = rng.standard_normal(size=s.shape).astype(np.float32)
        return out


def make_batch_iterator(
    stream: SyntheticStream, *, start_step: int = 0, prefetch: int = 2
) -> Iterator[dict[str, np.ndarray]]:
    """Prefetching iterator starting at ``start_step`` (restart skip-ahead).
    Its worker thread ("batch-prefetch") has stopped once the generator is
    closed (``close()``, or garbage collection)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker() -> None:
        step = start_step
        while not stop.is_set():
            try:
                q.put(stream.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, name="batch-prefetch", daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        t.join()
