"""The port's checkpoint store (``checkpoint/store``) on the CPU, and its
on-disk format against the reference's.

Tolerances: none.  Leaves are written as ``.npy`` and read back bit for bit;
across packages an LM's train state (no convolution, so no layout change)
is read by each package from the other's checkpoint, bitwise.
"""
from __future__ import annotations

import dataclasses
import json

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import configs as jconfigs
from repro.arch import ShapeSpec as JShapeSpec
from repro.launch import steps as jsteps
from repro_torch import arch as A
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import common


def _tiny_state():
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b):
    la, lb = common.tree_leaves(a), common.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    path = ck.save(tmp_path, 3, state, {"loss": 1.5})
    assert ck.latest_step(tmp_path) == 3
    meta = json.loads((path / "manifest.json").read_text())
    assert meta["leaf_paths"] == ["opt.step", "params.b", "params.w"]
    assert meta["shapes"] == [[], [3], [2, 3]] and meta["dtypes"] == ["int32", "float32", "float32"]
    restored, extra = ck.restore(tmp_path, 3, common.tree_map(torch.zeros_like, state))
    assert extra["loss"] == 1.5
    _equal(restored, state)


def test_restore_follows_like_device_and_dtype(tmp_path):
    ck.save(tmp_path, 1, _tiny_state())
    like = common.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float64), _tiny_state())
    restored, _ = ck.restore(tmp_path, 1, like)
    for t in common.tree_leaves(restored):
        assert t.dtype == torch.float64 and t.device.type == "cpu"


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck.save(tmp_path, 1, _tiny_state())
    bad = _tiny_state()
    bad["params"]["w"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tmp_path, 1, bad)


def test_checkpoint_missing_leaf_rejected(tmp_path):
    ck.save(tmp_path, 1, _tiny_state())
    more = _tiny_state()
    more["params"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="missing leaf 'params.extra'"):
        ck.restore(tmp_path, 1, more)


def test_tmp_directory_is_ignored(tmp_path):
    ck.save(tmp_path, 2, _tiny_state())
    (tmp_path / "step_00000009.tmp").mkdir()  # a writer that died mid-save
    (tmp_path / "step_00000009.tmp" / "manifest.json").write_text("{}")
    (tmp_path / "step_00000005").mkdir()  # no manifest: never trusted
    assert ck.latest_step(tmp_path) == 2
    assert ck.latest_step(tmp_path / "absent") is None


def test_async_checkpointer(tmp_path):
    acp = ck.AsyncCheckpointer(tmp_path)
    state = _tiny_state()
    for s in (1, 2, 3):
        acp.save(s, state, {"s": s})
    acp.close()
    assert ck.latest_step(tmp_path) == 3
    assert not acp._thread.is_alive()


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The train step writes into its state in place: what ``save`` stores is
    the tree as it stood when ``save`` returned."""
    acp = ck.AsyncCheckpointer(tmp_path)
    state = _tiny_state()
    want = common.tree_map(torch.clone, state)
    acp.save(1, state)
    state["params"]["w"].add_(100.0)
    state["opt"]["step"].add_(1)
    acp.close()
    restored, _ = ck.restore(tmp_path, 1, common.tree_map(torch.zeros_like, state))
    _equal(restored, want)


def test_async_worker_errors_reraise_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    acp = ck.AsyncCheckpointer(blocker)  # save() must mkdir under a file: fails on the worker
    acp.save(1, _tiny_state())
    with pytest.raises(OSError):
        acp.wait()


def _lm_cells(tmp_path):
    arch_j = dataclasses.replace(jconfigs.get("qwen3-0.6b", smoke=True),
                                 shapes=(JShapeSpec("t", "train", 2, seq=8),))
    arch = dataclasses.replace(configs.get("qwen3-0.6b", smoke=True), shapes=(A.ShapeSpec("t", "train", 2, seq=8),))
    return jsteps.build_cell(arch_j, "t"), steps.build_cell(arch, "t")


def test_reference_reads_a_port_lm_train_state(tmp_path):
    prog_j, prog = _lm_cells(tmp_path)
    ts = prog.init_arg(0, 4, "cpu")
    ts["opt"]["step"].fill_(5)
    ck.save(tmp_path, 5, ts, {"loss": 2.0})
    like = prog_j.init_args(jax.random.key(0))[0]
    got, extra = jck.restore(tmp_path, jck.latest_step(tmp_path), like)
    assert extra == {"loss": 2.0}
    want = common.tree_leaves(ts)
    leaves = jax.tree.leaves(got)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert np.asarray(g).dtype == w.numpy().dtype
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_port_reads_a_reference_lm_train_state(tmp_path):
    prog_j, prog = _lm_cells(tmp_path)
    ts_j = prog_j.init_args(jax.random.key(3))[0]
    ts_j["opt"]["step"] = jnp.asarray(9, jnp.int32)
    jck.save(tmp_path, 9, ts_j, {"loss": 1.25})
    like = prog.init_arg(0, 0, "cpu")
    got, extra = ck.restore(tmp_path, ck.latest_step(tmp_path), like)
    assert extra == {"loss": 1.25}
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 9
    for g, w in zip(common.tree_leaves(got), jax.tree.leaves(ts_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
