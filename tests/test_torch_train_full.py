"""``chip_smoke.py``'s train_full phase rehearsed on the CPU at the smoke
configs' size.

train_full trains five configurations on the card (TRAIN_CASES); here the
same code runs their SMOKE configs at small shapes named as the published
ones, with small batches, and its host-CPU check (b) compares the CPU with
itself.  The phase must pass the port as it is, with each of its wrong
paths (a shifted label, an unscaled timestep, a dropped microbatch) beyond
its limit, and must fail a restart that does not restore its checkpoint.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import arch as A
from repro_torch import checkpoint, configs, data
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.npu_matmul import ops
from repro_torch.launch import steps, train
from repro_torch.models import common, convnets, diffusion, layers, lm, vision
from repro_torch.train import optim

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

SMALL_SHAPES = {  # the published shape names, at the smoke configs' size
    "lm": (A.ShapeSpec("train_4k", "train", 256, seq=32),),
    "dit": (A.ShapeSpec("train_256", "denoise_train", 256, img=64),),
    "flux": (A.ShapeSpec("train_1024", "denoise_train", 32, img=64),),
    "resnet": (A.ShapeSpec("cls_224", "classify_train", 256, img=32),),
}
SMALL_CASES = (
    ("resnet-50", "cls_224", None, 4, 1, 1e-3),
    ("dit-xl2", "train_256", None, 4, 1, 1e-3),
    ("qwen3-0.6b", "train_4k", None, 2, 2, 1e-3),
    ("deepseek-moe-16b", "train_4k", 2, 2, 2, 1e-3),
    ("flux-dev", "train_1024", (1, 1), 2, 2, 1e-3),
)


@pytest.fixture
def smoke_train_full(monkeypatch, tmp_path):
    real_get = configs.get

    def get(name, smoke=False):
        arch = real_get(name, smoke=True)
        return dataclasses.replace(arch, shapes=SMALL_SHAPES[arch.family])

    monkeypatch.setattr(configs, "get", get)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN_CASES", SMALL_CASES)
    monkeypatch.setattr(chip_smoke, "TRAIN_CHECK_SEQ", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_CHECK_IMG", 32)
    monkeypatch.setattr(chip_smoke, "TRAIN_CHECK_BLOCKS", {"q_block": 4, "kv_block": 8})  # 3 x 2 blocks of 12 tokens
    monkeypatch.setattr(chip_smoke, "TRAIN_CKPT", tmp_path / "ckpt")
    ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
    return lambda: chip_smoke.phase_train_full(torch, configs, common, steps, diffusion, layers, data, optim, train,
                                               (lm, diffusion, convnets, vision))


def test_train_full_passes_the_port(smoke_train_full):
    report = smoke_train_full()
    assert list(report) == [c[0] for c in SMALL_CASES] + ["restart"]
    for name, row in report.items():
        if name == "restart":
            assert row["rel"] <= 1e-4 and row["bitwise"]  # the CPU is deterministic
            continue
        assert len(row["losses"]) == chip_smoke.TRAIN_STEPS and row["losses"][-1] < row["losses"][0]
        a = row["agree"]
        assert a["loss_rel"] == a["grad_rel"] == a["bf16_loss_rel"] == a["bf16_grad_rel"] == 0.0  # CPU vs itself
        assert a["wrong_grad_rel"] > chip_smoke.grad_limit(configs.get(name))
        assert a["bf16_wrong_grad_rel"] > chip_smoke.TRAIN_BF16_GRAD_RTOL or not chip_smoke.bf16_held(configs.get(name))
        assert (a["blockwise_calls"].get("cpu", 0) > 0) == (name == "flux-dev")
    acc = report["dit-xl2"]["accum_check"]
    assert acc["wrong_loss_rel"] > chip_smoke.TRAIN_ACCUM_LOSS_RTOL >= acc["loss_rel"]
    assert (ops.int8_matmul.launches, flash_ops.flash_attention.launches) == (0, 0)


def test_train_full_fails_a_restart_that_does_not_restore(smoke_train_full, monkeypatch):
    monkeypatch.setattr(chip_smoke, "TRAIN_CASES", ())
    monkeypatch.setattr(checkpoint, "restore", lambda directory, step, like: (like, {}))
    with pytest.raises(RuntimeError, match="restart"):
        smoke_train_full()
