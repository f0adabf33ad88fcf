"""``chip_smoke.py``'s mesh phase rehearsed on the CPU at a cut size, and
its verdict's power to fail.

The phase spawns four ranks of the port (gloo, a FileStore) that take the
parent's settings: here the CPU, and ``MESH_LARGE``'s grid cut to 200
points over 60 frames, of which the ranks run the 100 under SWEEP_TRACE.  With no earlier phase run, the parent computes the
one-rank results itself.  Its (a)-(d) only: ``tests/test_torch_lm_mesh_phase.py``
rehearses (e).  The phase must pass the port as it is; then
:func:`chip_smoke.check_ranks` must fail rank results that a broken gather,
an unsharded group, a wrong shard, a replicated constrain or a kernel
launch would give.
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


@pytest.fixture(scope="module")
def ranks():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("DEVICE", "cpu"), ("SWEEP_FRAMES", 60), ("SWEEP_BW", [0.5, 2.0]),
                            ("SWEEP_RTT", [40.0, 120.0]), ("ONE_RANK", {}), ("MESH_PARTS", ("sweeps",))):
            mp.setattr(chip_smoke, name, value)
        mp.setenv("OMP_NUM_THREADS", "1")
        out = chip_smoke.phase_mesh(torch, core, session, scenariogen, configs, steps, "CPU rehearsal")
        yield out, dict(chip_smoke.ONE_RANK)


def test_mesh_phase_passes_on_cpu_ranks(ranks):
    out, one = ranks
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    assert all(r["large"] == one["large"][0] for r in out) and len(one["large"][0]) == 100
    assert all(g["world"] == 4 for r in out for g in r["groups"])


def _swap_lanes(r):
    """Two points' results exchanged, as a gather out of rank order would."""
    rows = r["large"]
    i = next(i for i, row in enumerate(rows) if row != rows[0])
    rows[0], rows[i] = rows[i], rows[0]


def _unshard(r):
    r["groups"][0]["world"] = None


def _wrong_shard(r):
    r["restore"]["equal"] -= 1


def _replicated(r):
    r["constrain"]["placements"][0] = "(Replicate(), Replicate())"


def _launch(r):
    r["launches"] = [0, 1]


def _golden(r):
    r["fleet"][0][0][1] += 1


@pytest.mark.parametrize("tamper,message", [
    (_swap_lanes, "full-width stats differ"), (_unshard, "unsharded"), (_wrong_shard, "saved slices"),
    (_replicated, "constrain round trip"), (_launch, "launched a model kernel"), (_golden, "fleet grid differs")])
def test_check_ranks_fails_a_wrong_rank(ranks, tamper, message, monkeypatch):
    out, one = ranks
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ONE_RANK", one)
    chip_smoke.check_ranks(torch, core, out)
    bad = copy.deepcopy(out)
    tamper(bad[2])
    with pytest.raises(RuntimeError, match=message):
        chip_smoke.check_ranks(torch, core, bad)
