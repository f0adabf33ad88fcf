"""``chip_smoke.py``'s lm_full phase rehearsed on the CPU at the smoke
configs' size, and the logit comparison it holds the card to.

lm_full runs on the card at full width; here the same code runs the four
LMs' SMOKE configs (prefill at 48 and 24 tokens, 6 decode steps into a
40-slot cache), where the flash op takes its plain version.  The phase must
pass the port as it is, and must fail a decode whose new token does not see
its own key and a prefill that attends to later tokens: its limit
(``LM_FULL_RTOL``) and top-1 rule have to be able to fail.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from repro_torch import arch as A
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import steps
from repro_torch.models import common, lm
from repro_torch.models import layers as L
from repro_torch.serving.calibrate import _median_s

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

SMOKE_CASES = (("qwen3-0.6b", (48, 24), 4, True), ("deepseek-moe-16b", (24,), 2, False),
               ("command-r-35b", (24,), 1, False), ("qwen2-moe-a2.7b", (24,), 2, False))


@pytest.fixture
def smoke_lm_full(monkeypatch):
    """lm_full on the CPU at smoke size; CPU calls of the flash op at a head
    dim the kernel is built for count as launches (command-r's smoke hd 8
    recurses once through the padding)."""
    real_get, real_flash = configs.get, flash_ops.flash_attention

    def counted(q, k, v, *, causal, sm_scale=None):
        out = real_flash(q, k, v, causal=causal, sm_scale=sm_scale)
        counted.launches += q.shape[-1] in flash_ops.HEAD_DIMS
        return out

    counted.launches = 0
    monkeypatch.setattr(configs, "get", lambda name, smoke=False: real_get(name, smoke=True))
    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    for name, value in (("DEVICE", "cpu"), ("LM_PREFILL", 24), ("LM_DECODE_LEN", 40), ("LM_DECODE_STEPS", 6),
                        ("LM_DECODE_REPEATS", 1), ("LM_CASES", SMOKE_CASES)):
        monkeypatch.setattr(chip_smoke, name, value)
    return lambda: chip_smoke.phase_lm_full(torch, A, configs, common, steps, lm, L, flash_ops, flash_ref, _median_s)


def test_lm_full_passes_the_port(smoke_lm_full):
    report = smoke_lm_full()
    assert list(report) == [name for name, *_ in SMOKE_CASES]
    for (name, lengths, batch, int8), rows in zip(SMOKE_CASES, report.values()):
        cfg = configs.get(name, smoke=True).cfg
        assert rows["layers"] == cfg.n_layers
        assert sorted(rows["prefill"]) == sorted(lengths)
        assert all(p["launches"] == cfg.n_layers for p in rows["prefill"].values())
        assert all(p["rel"] <= chip_smoke.LM_FULL_RTOL for p in rows["prefill"].values())
        assert rows["decode"]["batch"] == batch and rows["decode"]["rel"] <= chip_smoke.LM_FULL_RTOL
        assert ("decode_int8" in rows) == int8
        assert ("wrong" in rows) == (name == chip_smoke.LM_CONTROL)
    assert min(report[chip_smoke.LM_CONTROL]["wrong"].values()) > chip_smoke.LM_FULL_RTOL


def _noncausal(real):
    return lambda q, k, v, *, causal=True, **kw: real(q, k, v, causal=False, **kw)


@pytest.mark.parametrize("module,name,wrong,fails", [
    (L, "_sdpa", chip_smoke.blind_sdpa, "decode differs from prefill"),
    (flash_ops, "attention", _noncausal, "kernel prefill differs from plain"),
])
def test_lm_full_fails_a_wrong_path(smoke_lm_full, monkeypatch, module, name, wrong, fails):
    monkeypatch.setattr(module, name, wrong(getattr(module, name)))
    with pytest.raises(RuntimeError, match=fails):
        smoke_lm_full()


def _logits(*rows):
    return torch.tensor(rows, dtype=torch.float32)[:, None, :]


@pytest.mark.parametrize("got,want,noise,same,ok", [
    # equal picks
    (_logits([1.0, 3.0, 2.0]), _logits([1.0, 3.0, 2.0]), 0.0, 1, True),
    # another pick where the reference's top two lie 1.0 (64 bf16 ulps at 3.0) apart
    (_logits([1.0, 3.0, 3.05]), _logits([1.0, 3.0, 2.0]), 0.0, 0, False),
    # another pick where they lie one ulp (2^-6 at 3.0) apart: a tie
    (_logits([1.0, 2.98, 3.0]), _logits([1.0, 3.0, 3.0 - 2**-6]), 0.0, 0, True),
    # three ulps apart: not a tie, however small the error
    (_logits([1.0, 3.0 - 2**-6, 3.0]), _logits([1.0, 3.0, 3.0 - 3 * 2**-6]), 0.0, 0, False),
    # a tie beside a row decided wrongly: the wrong row fails the whole
    (_logits([1.0, 2.98, 3.0], [0.0, 1.0, 5.1]), _logits([1.0, 3.0, 3.0 - 2**-6], [0.0, 5.0, 1.0]), 0.0, 0, False),
    # three ulps apart, where two sound computations lie 0.05 apart: a tie (2 x 0.05 > 3 ulps)
    (_logits([1.0, 3.0 - 2**-6, 3.0]), _logits([1.0, 3.0, 3.0 - 3 * 2**-6]), 0.05, 0, True),
    # 1.0 apart: a tie only where the sound noise is at least half of it
    (_logits([1.0, 3.0, 3.05]), _logits([1.0, 3.0, 2.0]), 0.4, 0, False),
    (_logits([1.0, 3.0, 3.05]), _logits([1.0, 3.0, 2.0]), 0.5, 0, True),
    # a row whose top two tie, where the token picked lies far below them: not a tie
    (_logits([5.0, 3.0, 2.0]), _logits([1.0, 3.0, 3.0 - 2**-6]), 0.0, 0, False),
    (_logits([5.0, 3.0, 2.0]), _logits([1.0, 3.0, 2.9]), 0.1, 0, False),
    # within the noise band it is the token picked that counts, not the reference's second
    (_logits([1.0, 3.0, 2.0, 3.1]), _logits([1.0, 3.0, 2.95, 2.5]), 0.1, 0, False),
    (_logits([1.0, 3.0, 3.1, 2.0]), _logits([1.0, 3.0, 2.95, 2.5]), 0.1, 0, True),
])
def test_compare_logits_top1_rule(got, want, noise, same, ok):
    c = chip_smoke.compare_logits(got, want, noise=noise)
    assert (c["same"], c["rows"], c["top1_ok"]) == (same, got.shape[0], ok)
    assert c["err"] == pytest.approx(float((got - want).abs().max()))
    assert c["rel"] == pytest.approx(c["err"] / float(want.abs().max()))
    picked = want.gather(-1, got.argmax(-1, keepdim=True))[..., 0]
    assert c["short"] == pytest.approx(float((want.max(-1).values - picked).max()))
