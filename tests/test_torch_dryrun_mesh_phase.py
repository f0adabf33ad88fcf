"""``chip_smoke.py``'s part 13b, the dry run's rank held against the mesh
phase's ranks, rehearsed on the CPU with made-up readings: (e)'s, (f)'s
and (g)'s cases at SMOKE size (the mesh phase rehearsals' settings) traced
by :func:`chip_smoke.mesh_dryrun_main` in a spawned process, each the
``dryrun.record`` of its mesh (rank 0 of a fake process group on ``meta``);
then
:func:`chip_smoke.check_mesh_dryrun` against four ranks' readings made up
from the traces.  Readings that agree pass; a count one off, a kind missing,
a peak outside the band, a rank without memory readings on the card or a
case left untraced fail; a trace that fails fails the part; and the tracing
process counts no kernel launch of its own.
"""
from __future__ import annotations

import copy
import json
import multiprocessing
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

SETTINGS = {"DEVICE": "cpu", "MESH_PARTS": ("models", "serve", "train"), "MESH_SMOKE": True, "LM_PREFILL": 16,
            "LM_DECODE_LEN": 32, "MESH_MODELS": (("qwen3-0.6b", None, (2, 2), 4, 14),
                                                 ("qwen2-moe-a2.7b", 2, (1, 4), 4, 6)),
            "MESH_SERVE": (("dit-xl2", "gen_fast", (2, 2), 2, 64, None),
                           ("flux-dev", "gen_fast", (1, 4), 2, 64, (2, 2)),
                           ("vit-s16", "serve_b128", (2, 2), 8, 32, None),
                           ("swin-b", "serve_b128", (1, 4), 8, 32, None),
                           ("resnet-50", "serve_b128", (1, 4), 8, 32, None),
                           ("efficientnet-b7", "serve_b1", (2, 2), 1, 32, None)),
            "MESH_TRAIN": (("qwen3-0.6b", "train_4k", (2, 2), None, 4, 16, None),
                           ("qwen2-moe-a2.7b", "train_4k", (1, 4), None, 2, 16, None),
                           ("dit-xl2", "train_256", (2, 2), None, 4, None, 64),
                           ("flux-dev", "train_256", (1, 4), None, 2, None, 64),
                           ("vit-s16", "cls_224", (2, 2), None, 8, None, 32),
                           ("resnet-50", "cls_224", (2, 2), None, 8, None, 32))}
RESIDENT = 7 << 20  # what a made-up rank holds beside its step's arguments


def _settings() -> dict:
    return {k: v for k, v in vars(chip_smoke).items() if k.isupper() and k not in ("ONE_RANK", "MESH_REPORT")}


@pytest.fixture(scope="module")
def settings():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SETTINGS.items():
            mp.setattr(chip_smoke, name, value)
        yield _settings()


@pytest.fixture(scope="module")
def done(settings, tmp_path_factory):
    """What the tracing process wrote: the cases' readings and its own kernel launches."""
    workdir = tmp_path_factory.mktemp("mesh_dryrun")
    proc = multiprocessing.get_context("spawn").Process(target=chip_smoke.mesh_dryrun_main,
                                                        args=(str(workdir), settings))
    proc.start()
    proc.join(300)
    assert proc.exitcode == 0
    return json.loads((workdir / "dryrun.json").read_text())


@pytest.fixture(scope="module")
def traced(done):
    return done["cases"]


def made_up(traced: dict, extra: int = 0, scale: float = 1.0) -> list:
    """Four ranks' readings agreeing with ``traced``: its collectives by kind
    and, for each step, card memory whose step peak is the estimate over
    ``scale`` plus ``extra`` bytes."""
    def mem(t):
        args = t["argument_bytes"] + 4096  # the card's storages of the arguments, a little larger
        return {"resident_bytes": args + RESIDENT, "argument_bytes": args,
                "peak_bytes": int(t["peak_bytes"] / scale) + extra + RESIDENT, "earlier_peak_bytes": 0}

    rank: dict = {"models": {}, "serve": {}, "train": {}}
    for key, t in traced.items():
        part, name, *step = key.split("/")
        row = rank[part].setdefault(name, {"collective_kinds": {}, "memory": {}})
        if step:
            row["collective_kinds"][step[0]] = dict(t["kinds"])
            row["memory"][step[0]] = mem(t)
        else:
            row.update(collective_kinds=dict(t["kinds"]), memory=mem(t))
    return [copy.deepcopy(rank) for _ in range(4)]


@pytest.fixture
def on_card(settings):
    """``check_mesh_dryrun`` as it runs on the card (the ranks measured memory)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in {**settings, "DEVICE": "cuda"}.items():
            mp.setattr(chip_smoke, name, value)
        yield


def test_every_case_traced_with_collectives(traced):
    assert len(traced) == 2 * 2 + 6 + 6
    for key, t in traced.items():
        assert sum(t["kinds"].values()) > 0 and t["collective_s"] > 0 and t["fits"], key
        assert t["peak_bytes"] >= t["argument_bytes"] > 0, key
        assert t["trace"] == ("plain" if "decode" in key or "train/" in key or key.split("/")[1] in
                              ("swin-b", "resnet-50", "efficientnet-b7") else "flash"), key
    assert any("/backward" in k for k in traced["train/qwen3-0.6b"]["kinds"])


def test_agreeing_readings_pass(traced, on_card):
    report = chip_smoke.check_mesh_dryrun(made_up(traced), traced, "CPU rehearsal")
    assert set(report) == set(traced) and all(r == pytest.approx(0.0, abs=1e-12) for r in report.values())


@pytest.mark.parametrize("scale", [1.19, 0.84])
def test_a_peak_inside_the_band_passes(traced, on_card, scale):
    """Every estimate 19% above or 16% below each rank's step peak."""
    report = chip_smoke.check_mesh_dryrun(made_up(traced, scale=scale), traced, "CPU rehearsal")
    assert all(r == pytest.approx(scale - 1, abs=1e-4) for r in report.values())


@pytest.mark.parametrize("key,kind,delta", [("models/qwen3-0.6b/decode", "sum", 1),
                                            ("serve/resnet-50", "gather", -1),
                                            ("train/dit-xl2", "sum/backward", 1)])
def test_a_count_off_by_one_fails(traced, on_card, key, kind, delta):
    ranks = made_up(traced)
    part, name, *step = key.split("/")
    kinds = ranks[2][part][name]["collective_kinds"]
    kinds = kinds[step[0]] if step else kinds
    kinds[kind] += delta
    with pytest.raises(RuntimeError, match=f"mesh dryrun: {key}: the rank trace issues"):
        chip_smoke.check_mesh_dryrun(ranks, traced, "CPU rehearsal")


def test_a_kind_missing_fails(traced, on_card):
    ranks = made_up(traced)
    del ranks[0]["train"]["vit-s16"]["collective_kinds"]["max"]
    with pytest.raises(RuntimeError, match="train/vit-s16: the rank trace issues"):
        chip_smoke.check_mesh_dryrun(ranks, traced, "CPU rehearsal")


def test_a_peak_outside_the_band_fails(traced, on_card):
    """No absolute slack: a workspace of 30 MiB above a small estimate fails,
    and so does one case's estimate 30% above a rank's step peak."""
    with pytest.raises(RuntimeError, match="estimated peak .* outside 20%"):
        chip_smoke.check_mesh_dryrun(made_up(traced, 30 << 20), traced, "CPU rehearsal")
    ranks = made_up(traced)
    mem = ranks[1]["serve"]["flux-dev"]["memory"]
    step = mem["peak_bytes"] - RESIDENT
    mem["peak_bytes"] = RESIDENT + int(step / 1.19)  # the estimate 19% above the step: inside
    chip_smoke.check_mesh_dryrun(ranks, traced, "CPU rehearsal")
    mem["peak_bytes"] = RESIDENT + int(step / 1.3)
    with pytest.raises(RuntimeError, match="serve/flux-dev: estimated peak"):
        chip_smoke.check_mesh_dryrun(ranks, traced, "CPU rehearsal")


def test_no_memory_reading_on_the_card_fails(traced, on_card):
    ranks = made_up(traced)
    ranks[3]["models"]["qwen2-moe-a2.7b"]["memory"]["prefill"] = {}
    with pytest.raises(RuntimeError, match="qwen2-moe-a2.7b/prefill: a rank measured no step memory"):
        chip_smoke.check_mesh_dryrun(ranks, traced, "CPU rehearsal")


def test_a_case_left_untraced_fails(traced, on_card):
    fewer = {k: v for k, v in traced.items() if k != "serve/swin-b"}
    with pytest.raises(RuntimeError, match="mesh dryrun: traced"):
        chip_smoke.check_mesh_dryrun(made_up(traced), fewer, "CPU rehearsal")


def test_the_part_runs_and_launches_no_kernel(done, traced, settings, monkeypatch):
    """The whole part on the CPU: spawned traces, the readings (no memory
    off the card), no kernel launch counted by the tracing process; a trace
    that fails fails the part."""
    assert done["launches"] == [0, 0]
    for name, value in settings.items():
        monkeypatch.setattr(chip_smoke, name, value)
    ranks = made_up(traced)
    for rank in ranks:
        for part in rank.values():
            for row in part.values():
                row["memory"] = {k: {} for k in row["memory"]} if "prefill" in row["memory"] else {}
    report = chip_smoke.phase_mesh_dryrun(ranks, "CPU rehearsal")
    assert set(report) == set(traced) and all(r is None for r in report.values())
    monkeypatch.setattr(chip_smoke, "MESH_PARTS", ("serve",))
    monkeypatch.setattr(chip_smoke, "MESH_SERVE", (("no-such-model", "serve_b1", (2, 2), 1, 32, None),))
    with pytest.raises(RuntimeError, match="mesh dryrun: the tracing process exited 1"):
        chip_smoke.phase_mesh_dryrun(ranks, "CPU rehearsal")
