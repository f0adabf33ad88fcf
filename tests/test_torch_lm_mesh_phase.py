"""``chip_smoke.py``'s mesh phase part (e), the LMs' serving steps under
``serve_rules`` on 4 ranks, rehearsed on the CPU: the SMOKE qwen3-0.6b on
a (2, 2) mesh and the SMOKE qwen2-moe-a2.7b (its 2 layers) on (1, 4), a
16-token prefill and decode steps against a 32-slot cache whose length
crosses the first split of its slots.  The phase must pass the port as it
is (logits put together from the ranks within ``LM_FULL_RTOL`` of the
parent's one-rank run with the top-1 rule, the MoE's picks replayed), its
controls (a rank's attention partial left out of the prefill's sum, a
rank's cache slots left out of a decode's merge) must lie beyond the
limit, and :func:`chip_smoke.check_models` must fail outputs that a
missing shard, a wrong shard, a lost flash launch or a control inside the
limit would give.  On the CPU the flash op takes its plain version, so a
prefill launches nothing.
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

SETTINGS = {"DEVICE": "cpu", "MESH_PARTS": ("models",), "MESH_SMOKE": True, "LM_PREFILL": 16, "LM_DECODE_LEN": 32,
            "MESH_TIMED": 2, "MESH_MODELS": (("qwen3-0.6b", None, (2, 2), 4, 14),
                                             ("qwen2-moe-a2.7b", 2, (1, 4), 4, 6))}


@pytest.fixture(scope="module")
def phase():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SETTINGS.items():
            mp.setattr(chip_smoke, name, value)
        mp.setattr(chip_smoke, "MESH_REPORT", {})
        mp.setenv("OMP_NUM_THREADS", "1")
        ranks = chip_smoke.phase_mesh(torch, core, session, scenariogen, configs, steps, "CPU rehearsal")
        yield ranks, dict(chip_smoke.MESH_REPORT)


def test_model_steps_pass_on_cpu_ranks(phase):
    ranks, report = phase
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for name, *_ in SETTINGS["MESH_MODELS"]:
        rows = [r["models"][name] for r in ranks]
        assert all(m["collectives"]["prefill"] > 0 and m["collectives"]["decode"] > 0 for m in rows)
        assert all(m["launches"] == 0 and m["layers"] == 2 for m in rows)
    assert "sweep" not in ranks[0]


def _verdict(phase):
    _, report = phase
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SETTINGS.items():
            mp.setattr(chip_smoke, name, value)
        return chip_smoke.check_models(torch, report["ranks"], report["one"], report["tensors"])


def test_control_lies_beyond_the_limit(phase):
    models = _verdict(phase)
    assert models["qwen3-0.6b"]["control"] > chip_smoke.LM_FULL_RTOL
    assert models["qwen3-0.6b"]["decode_control"] > chip_smoke.LM_FULL_RTOL
    assert models["qwen3-0.6b"]["prefill"]["rel"] <= chip_smoke.LM_FULL_RTOL
    assert models["qwen3-0.6b"]["decode"]["rel"] <= chip_smoke.LM_FULL_RTOL


def _drop_shard(report):
    report["tensors"][1]["qwen3-0.6b"]["prefill"] = report["tensors"][0]["qwen3-0.6b"]["prefill"]


def _wrong_shard(report):
    local, where = report["tensors"][3]["qwen2-moe-a2.7b"]["decode"][2]
    report["tensors"][3]["qwen2-moe-a2.7b"]["decode"][2] = (local.roll(1, -1), where)


def _lost_launch(report):
    report["ranks"][2]["models"]["qwen3-0.6b"]["launches"] = 1


def _control_inside(report):
    for t in report["tensors"]:
        t["qwen3-0.6b"]["control"] = t["qwen3-0.6b"]["prefill"]


def _decode_control_inside(report):
    for t in report["tensors"]:
        t["qwen3-0.6b"]["decode_control"] = t["qwen3-0.6b"]["decode"][:chip_smoke.MESH_CONTROL_STEPS]


@pytest.mark.parametrize("tamper,message", [
    (_drop_shard, "do not cover"), (_wrong_shard, "decode on the ranks differs"),
    (_lost_launch, "flash launches a prefill"), (_control_inside, "cannot fail"),
    (_decode_control_inside, "slots in the merge")])
def test_check_models_fails_a_wrong_run(phase, tamper, message):
    ranks, report = phase
    bad = {**report, "tensors": copy.deepcopy(report["tensors"]), "ranks": copy.deepcopy(report["ranks"])}
    tamper(bad)
    with pytest.raises(RuntimeError, match=message):
        _verdict((ranks, bad))
