"""The port's training driver (``launch/train``) and the restart path, on the
CPU at smoke size.

  * restart determinism through the CLI (the reference's
    ``tests/test_substrate.py::test_train_restart_determinism``, there marked
    slow; here tiny): 8 steps straight against 4 steps, an async checkpoint,
    ``--resume`` and 4 more; the last loss within the reference's rel 1e-4;
  * fail, re-plan, restore, continue (``tests/test_elastic.py::
    test_fail_replan_restore_continue``): a checkpoint after step 4, a
    re-plan of the mesh for the survivors, ``restore`` and two more steps on
    the skipped-ahead batches; the loss within the reference's rel 1e-5;
  * the CLI asks for the card by default and raises where there is none.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

from test_torch_ref import REPO

import pytest
import torch

from repro_torch import arch as A
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.data import DataSpec, SyntheticStream
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.runtime import plan_elastic_remesh
from repro_torch.train.optim import AdamWConfig

COMMON = ["--arch", "resnet-50", "--smoke", "--batch", "2", "--img", "32", "--seed", "3", "--total-steps", "8",
          "--device", "cpu"]


def test_train_restart_determinism(tmp_path):
    full = T.main(COMMON + ["--steps", "8"])
    part = T.main(COMMON + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert part["steps"] == 4 and ck.latest_step(tmp_path) == 4
    resumed = T.main(COMMON + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "100", "--resume"])
    assert resumed["steps"] == 4
    assert resumed["last_loss"] == pytest.approx(full["last_loss"], rel=1e-4)
    assert ck.latest_step(tmp_path) == 8


def test_cli_accumulation_and_lm(capsys):
    out = T.main(["--arch", "qwen3-0.6b", "--smoke", "--batch", "4", "--seq", "16", "--steps", "3",
                  "--accum-steps", "2", "--device", "cpu", "--log-every", "1"])
    assert out["steps"] == 3 and out["last_loss"] == out["last_loss"]  # finite
    assert capsys.readouterr().out.count("step ") == 3


def test_cli_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "dit-xl2", "--smoke",
                          "--batch", "2", "--img", "64", "--steps", "1", "--device", "cpu"],
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")}, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "done: {'first_loss'" in out.stdout


def test_cli_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a machine without a card
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.main(["--arch", "resnet-50", "--smoke", "--steps", "1"])


def test_fail_replan_restore_continue(tmp_path):
    a = dataclasses.replace(configs.get("resnet-50", smoke=True),
                            shapes=(A.ShapeSpec("t", "classify_train", 4, img=32),))
    prog = steps.build_cell(a, "t", adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20))
    stream = SyntheticStream(DataSpec(a, a.shape("t"), seed=0))

    def batch(i):
        return {k: torch.as_tensor(v) for k, v in stream.batch_at(i).items()}

    ts = prog.init_arg(0, 0, "cpu")
    losses = []
    for i in range(6):
        ts, m = prog(ts, batch(i))
        losses.append(float(m["loss"]))
        if i == 3:
            ck.save(tmp_path, 4, ts)  # checkpoint after step index 3

    # --- pod failure: 512 -> 300 surviving chips ---
    plan = plan_elastic_remesh(300)
    assert plan.mesh_shape == (18, 16)  # model axis preserved
    assert plan.data_parallel_scale < 1.0  # driver raises grad-accum by 1/scale

    # --- restart path: restore and continue ---
    last = ck.latest_step(tmp_path)
    assert last == 4
    ts2, _ = ck.restore(tmp_path, last, prog.init_arg(0, 0, "cpu"))
    assert int(ts2["opt"]["step"]) == 4
    for i in range(4, 6):  # deterministic skip-ahead re-runs the same batches
        ts2, m = prog(ts2, batch(i))
    # same trajectory as the uninterrupted run
    assert float(m["loss"]) == pytest.approx(losses[-1], rel=1e-5)
