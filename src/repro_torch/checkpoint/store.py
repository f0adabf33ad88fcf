"""Checkpointing: a tree of tensors <-> a directory of .npy files + a JSON
manifest, in the reference's on-disk format.

  * **atomicity** — writes go to ``step_N.tmp/`` then os.rename, so a dead
    writer never leaves a half checkpoint that restore would trust;
  * **async** — ``AsyncCheckpointer`` copies the tree to host memory on the
    caller's thread and writes on a background thread, so the train loop
    never blocks on disk;
  * **manifest-checked** — structure and shapes verified on restore.

One ``.npy`` a leaf, named by its dotted path in sorted-key order
(``params.blocks.attn.wq``), beside ``manifest.json`` (step, timestamp,
leaf_paths, shapes, dtypes, extra): the files the reference writes.  A tree
without convolutions (an LM's or a diffusion model's train state) is
therefore readable by either package from the other's checkpoint.
Convolution weights are stored in the port's OIHW layout, not the
reference's HWIO, so a classifier's checkpoint is the port's own.  Leaves
are f32 or integer (a train state's); numpy has no bf16.

``restore_resharded`` restores onto a new mesh (an elastic restart): each
rank reads the same files and keeps its own shards, so placing a leaf
needs no collective.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.common import tree_leaves, tree_map


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    timestamp: float
    leaf_paths: list[str]
    shapes: list[list[int]]
    dtypes: list[str]
    extra: dict


def _paths(tree: Any, prefix: str = "") -> list[str]:
    """Dotted path of every leaf, in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}.")]
    return [prefix.rstrip(".")]


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array that owns its memory: a tensor is copied off
    its device (or, on the CPU, copied), so a later in-place update of the
    tensor cannot reach the array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(directory: str | os.PathLike, step: int, tree: Any, extra: dict | None = None) -> Path:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    keys = _paths(tree)
    arrays = [leaf if isinstance(leaf, np.ndarray) else _host(leaf) for leaf in tree_leaves(tree)]
    meta = CheckpointMeta(
        step=step,
        timestamp=time.time(),
        leaf_paths=keys,
        shapes=[list(a.shape) for a in arrays],
        dtypes=[str(a.dtype) for a in arrays],
        extra=extra or {},
    )
    for key, arr in zip(keys, arrays):
        np.save(tmp / f"{key}.npy", arr)
    (tmp / "manifest.json").write_text(json.dumps(dataclasses.asdict(meta)))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    base = Path(directory)
    if not base.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in base.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def restore(directory: str | os.PathLike, step: int, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (every leaf present, shapes
    verified); each leaf comes back a tensor on its ``like`` leaf's device
    and in its dtype.  Returns (tree, the manifest's ``extra``)."""
    path = Path(directory) / f"step_{step:08d}"
    meta = json.loads((path / "manifest.json").read_text())
    stored = dict(zip(meta["leaf_paths"], meta["shapes"]))
    keys = iter(_paths(like))

    def load(leaf):
        key = next(keys)
        if key not in stored:
            raise ValueError(f"checkpoint missing leaf {key!r}")
        want = list(leaf.shape)
        if stored[key] != want:
            raise ValueError(f"leaf {key!r}: checkpoint shape {stored[key]} != expected {want}")
        arr = np.load(path / f"{key}.npy")
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)

    return tree_map(load, like), meta["extra"]


def restore_resharded(directory: str | os.PathLike, step: int, like: Any, shardings: Any) -> tuple[Any, dict]:
    """Restore and place with the NEW mesh's shardings (elastic restart).
    ``shardings`` is a tree over ``like``'s leaves: ``None`` keeps a leaf a
    plain tensor on its ``like`` leaf's device; a ``sharding.rules.Sharding``
    on a mesh over the process group (``MeshRules.tree_shardings`` of the
    new mesh) makes it a DTensor, of which this rank holds its own shards."""
    tree, extra = restore(directory, step, like)

    def place(x: torch.Tensor, s: Any) -> Any:
        if s is None:
            return x
        device_mesh = s.mesh.device_mesh
        if device_mesh is None:
            raise ValueError(f"sharding {s} is on a mesh without devices {s.mesh.shape}: "
                             "restore onto a mesh over the process group")
        from torch.distributed.tensor import distribute_tensor

        from ..sharding.rules import placements

        return distribute_tensor(x, device_mesh, placements(s.mesh, s), src_data_rank=None)

    return tree_map(place, tree, shardings), extra


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread checkpointing.

    ``save(step, tree)`` copies every leaf to host memory (the only blocking
    part: a synchronous copy, so the snapshot is the tree as it stands when
    ``save`` returns, whatever the train step writes into it in place
    afterwards), enqueues, and returns; a daemon thread persists in order.
    A bounded queue applies back-pressure if disk cannot keep up with the
    checkpoint cadence.  ``wait()`` drains and re-raises the first error of
    the worker (used at shutdown and in tests).
    """

    def __init__(self, directory: str | os.PathLike, max_pending: int = 2):
        self.directory = Path(directory)
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, extra = item
            try:
                save(self.directory, step, host_tree, extra)
            except Exception as e:  # noqa: BLE001  (re-raised by wait())
                self._errors.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self._q.put((step, tree_map(_host, tree), extra))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
