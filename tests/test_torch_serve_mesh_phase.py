"""``chip_smoke.py``'s mesh phase part (f), the diffusion and classifier
serving steps under ``serve_rules`` on 4 ranks, rehearsed on the CPU: the
SMOKE DiT on a (2, 2) mesh and the SMOKE Flux on (1, 4) at batch 2 on an
8 x 8 latent; the SMOKE ViT on (2, 2), Swin and ResNet-50 on (1, 4) at
batch 8 on 32 x 32 images; the SMOKE EfficientNet-B7 at batch 1 on (2, 2).
The phase must pass the port as it is (a diffusion step's implied
prediction within ``DIFF_RTOL`` of the parent's one-rank run, a
classifier's logits within ``CLASSIFY_RTOL``), each model's control (a
rank's attention partial left out of DiT's, Flux's, ViT's and Swin's sums,
a rank's stem channels lost before their gather in ResNet-50 and B7) must
lie beyond its limit, and :func:`chip_smoke.check_serve` must fail outputs that a missing
shard, a wrong shard, a lost flash launch or a control inside the limit
would give.  On the CPU the flash op takes its plain version, so a step
launches nothing.
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

SETTINGS = {"DEVICE": "cpu", "MESH_PARTS": ("serve",), "MESH_SMOKE": True,
            "MESH_SERVE": (("dit-xl2", "gen_fast", (2, 2), 2, 64, None),
                           ("flux-dev", "gen_fast", (1, 4), 2, 64, (2, 2)),
                           ("vit-s16", "serve_b128", (2, 2), 8, 32, None),
                           ("swin-b", "serve_b128", (1, 4), 8, 32, None),
                           ("resnet-50", "serve_b128", (1, 4), 8, 32, None),
                           ("efficientnet-b7", "serve_b1", (2, 2), 1, 32, None))}


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
        return chip_smoke.check_serve(torch, report["ranks"], report["serve_one"], report["serve_tensors"])


def test_serve_steps_pass_on_cpu_ranks(phase):
    ranks, report = phase
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for name, _, (_, model), *_ in SETTINGS["MESH_SERVE"]:
        rows = [r["serve"][name] for r in ranks]
        assert all(m["launches"] == 0 and (m["collectives"] > 0) == (model > 1) for m in rows), rows
        assert report["serve_one"][name]["flash_per_step"] == {"dit-xl2": 2, "flux-dev": 4, "vit-s16": 2}.get(name, 0)
    assert "sweep" not in ranks[0] and "models" not in ranks[0]


def test_controls_lie_beyond_the_limits(phase):
    serve = _verdict(phase)
    for name, m in serve.items():
        assert m["agree"]["rel"] <= m["limit"], (name, m["agree"])
        assert m["control"] > m["limit"], (name, m["control"])
        assert ("f32" in m) == (m["what"] == "logits")


def _drop_shard(report):
    report["serve_tensors"][1]["vit-s16"]["out"] = report["serve_tensors"][0]["vit-s16"]["out"]


def _wrong_copy(report):
    local, where = report["serve_tensors"][2]["flux-dev"]["out"]
    report["serve_tensors"][2]["flux-dev"]["out"] = (local * 1.001, where)


def _wrong_shard(report):
    local, where = report["serve_tensors"][3]["vit-s16"]["out"]
    report["serve_tensors"][3]["vit-s16"]["out"] = (local.roll(1, -1), where)


def _lost_launch(report):
    report["ranks"][2]["serve"]["vit-s16"]["launches"] = 1


def _control_inside(report, name="dit-xl2"):
    for t in report["serve_tensors"]:
        t[name]["control"] = t[name]["out"]


def _classifier_control_inside(report):
    _control_inside(report, "swin-b")


@pytest.mark.parametrize("tamper,message", [
    (_drop_shard, "do not cover"), (_wrong_copy, "copies of a"),
    (_wrong_shard, "vit-s16's logits on the ranks differ"),
    (_lost_launch, "flash launches a step"), (_control_inside, "cannot fail"),
    (_classifier_control_inside, "swin-b's control lies within")])
def test_check_serve_fails_a_wrong_run(phase, tamper, message):
    ranks, report = phase
    bad = {**report, "serve_tensors": copy.deepcopy(report["serve_tensors"]), "ranks": copy.deepcopy(report["ranks"])}
    tamper(bad)
    with pytest.raises(RuntimeError, match=message):
        _verdict((ranks, bad))
