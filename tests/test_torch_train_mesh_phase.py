"""``chip_smoke.py``'s mesh phase part (g), the training kinds under
``train_rules`` on 4 ranks, rehearsed on the CPU: the SMOKE qwen3 on a
(2, 2) mesh and the SMOKE qwen2-moe on (1, 4) (16 tokens), DiT on (2, 2)
and Flux on (1, 4) at an 8 x 8 latent, ViT and ResNet-50 on (2, 2) at
32 x 32 images.  Leaves above 4096 elements are compared on every
``MESH_TRAIN_STRIDE``-th element, as the full-width run compares its large
ones.  The phase must pass the port as it is (every rank's loss within
``TRAIN_LOSS_RTOL`` of the parent's one-rank run, its gradients and stepped
state within the case's gradient limit), each control (a rank's gradient
left out of the sum over ``data`` on the (2, 2) cases, the sum over
``model`` of a column-parallel input's gradient on the (1, 4) ones) must lie
beyond its limit, no rank may launch a kernel, and
:func:`chip_smoke.check_train` must fail a run that a missing rank, a wrong
loss, a wrong shard or a control inside the limit would give.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs, core, scenariogen, session
from repro_torch.launch import steps

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

SETTINGS = {"DEVICE": "cpu", "MESH_PARTS": ("train",), "MESH_SMOKE": True, "MESH_TRAIN_WHOLE": 4096,
            "MESH_TRAIN": (("qwen3-0.6b", "train_4k", (2, 2), None, 4, 16, None),
                           ("qwen2-moe-a2.7b", "train_4k", (1, 4), None, 2, 16, None),
                           ("dit-xl2", "train_256", (2, 2), None, 4, None, 64),
                           ("flux-dev", "train_256", (1, 4), None, 2, None, 64),
                           ("vit-s16", "cls_224", (2, 2), None, 8, None, 32),
                           ("resnet-50", "cls_224", (2, 2), None, 8, None, 32))}


@pytest.fixture(scope="module")
def phase():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SETTINGS.items():
            mp.setattr(chip_smoke, name, value)
        mp.setattr(chip_smoke, "MESH_REPORT", {})
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks = chip_smoke.phase_mesh(torch, core, session, scenariogen, configs, steps, "CPU rehearsal")
        yield ranks, dict(chip_smoke.MESH_REPORT)


def _verdict(phase):
    _, report = phase
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SETTINGS.items():
            mp.setattr(chip_smoke, name, value)
        return chip_smoke.check_train(torch, report["ranks"], report["train_one"])


def test_train_steps_pass_on_cpu_ranks(phase):
    ranks, report = phase
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for case in SETTINGS["MESH_TRAIN"]:
        rows = [r["train"][case[0]] for r in ranks]
        assert all(m["launches"] == [0, 0] and m["collectives"]["forward"] > 0 and m["collectives"]["backward"] > 0
                   for m in rows), rows
        assert set(rows[0]["ts"]) == ({"params", "m", "v", "state"} if case[0] == "resnet-50"
                                      else {"params", "m", "v"})
    assert "sweep" not in ranks[0] and "models" not in ranks[0] and "serve" not in ranks[0]


def test_controls_lie_beyond_the_limits(phase):
    train = _verdict(phase)
    for name, m in train.items():
        assert m["grads"] <= m["limit"] and max(m["state"].values()) <= m["limit"], (name, m["grads"], m["state"])
        assert m["control"] > m["limit"], (name, m["control"])


def _drop_rank(report):
    report["ranks"][3]["train"]["vit-s16"]["coord"] = [0, 0]


def _wrong_loss(report):
    report["ranks"][1]["train"]["qwen3-0.6b"]["loss"] *= 1.001


def _wrong_grads(report):
    report["ranks"][2]["train"]["dit-xl2"]["grads"][0] += report["ranks"][2]["train"]["dit-xl2"]["grads"][1]


def _wrong_state(report):
    report["ranks"][0]["train"]["resnet-50"]["ts"]["state"][0] += report["ranks"][0]["train"]["resnet-50"]["ts"][
        "state"][1]


def _control_inside(report):
    for r in report["ranks"]:
        r["train"]["flux-dev"]["control"] = r["train"]["flux-dev"]["grads"]


def _launched(report):
    report["ranks"][1]["train"]["qwen2-moe-a2.7b"]["launches"] = [0, 1]


@pytest.mark.parametrize("tamper,message", [
    (_drop_rank, "do not cover"), (_wrong_loss, "qwen3-0.6b's loss on the ranks"),
    (_wrong_grads, "dit-xl2's gradients on the ranks"), (_wrong_state, "resnet-50's stepped state"),
    (_control_inside, "flux-dev's control"), (_launched, "launched a kernel")])
def test_check_train_fails_a_wrong_run(phase, tamper, message):
    ranks, report = phase
    bad = {**report, "ranks": copy.deepcopy(report["ranks"])}
    tamper(bad)
    with pytest.raises(RuntimeError, match=message):
        _verdict((ranks, bad))
