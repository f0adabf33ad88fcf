"""``chip_smoke.py``'s diffusion_full phase rehearsed on the CPU at the smoke
configs' size, and the weight helpers it relies on.

diffusion_full runs DiT-XL/2 and Flux-dev whole on the card; here the same
code runs their SMOKE configs (2 attention layers for DiT, 2 double + 2
single for Flux) at two small denoise_step shapes named as the published
ones, where the flash op takes its plain version.  The phase must pass the
port as it is, and must fail each model's wrong path (DiT attending
causally, Flux's image tokens blind to its text tokens) and seed weights
whose adaLN-Zero leaves were left at zero (the prediction is then 0): its
limit (``DIFF_RTOL``) and checks have to be able to fail.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import arch as A
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import steps
from repro_torch.models import common, diffusion
from repro_torch.serving.calibrate import _median_s

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
SMALL_SHAPES = (A.ShapeSpec("gen_1024", "denoise_step", 2, img=64, steps=50),  # 8² latents
                A.ShapeSpec("gen_fast", "denoise_step", 3, img=32, steps=4))  # 4² latents


def _smoke(name: str, get=configs.get):
    return dataclasses.replace(get(name, smoke=True), shapes=SMALL_SHAPES)


@pytest.fixture
def smoke_diffusion_full(monkeypatch):
    """diffusion_full on the CPU at smoke size; CPU calls of the flash op
    count as launches (the smoke configs' head dim, 16, is a kernel width)."""
    real_get, real_flash = configs.get, flash_ops.flash_attention

    def counted(q, k, v, *, causal, sm_scale=None):
        out = real_flash(q, k, v, causal=causal, sm_scale=sm_scale)
        counted.launches += q.shape[-1] in flash_ops.HEAD_DIMS
        return out

    counted.launches = 0
    monkeypatch.setattr(configs, "get", lambda name, smoke=False: _smoke(name) if name in chip_smoke.DIFF_MODELS
                        else real_get(name, smoke=True))
    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    return lambda: chip_smoke.phase_diffusion_full(torch, A, configs, common, steps, diffusion, flash_ops, flash_ref,
                                                   _median_s)


def test_diffusion_full_passes_the_port(smoke_diffusion_full):
    report = smoke_diffusion_full()
    assert list(report) == list(chip_smoke.DIFF_MODELS)
    for name, rows in report.items():
        cfg = configs.get(name, smoke=True).cfg
        layers = cfg.n_layers if name == "dit-xl2" else cfg.n_double + cfg.n_single
        assert rows["layers"] == chip_smoke.attention_layers(cfg) == layers == (2 if name == "dit-xl2" else 4)
        assert list(rows["shapes"]) == list(chip_smoke.DIFF_SHAPES)
        for shape, p in zip(SMALL_SHAPES, rows["shapes"].values()):
            assert p["launches"] == layers and p["batch"] == shape.batch and p["steps"] == shape.steps
            assert p["rel"] <= chip_smoke.DIFF_RTOL and p["scale"] > 0
        assert rows["wrong"] > chip_smoke.DIFF_RTOL
        assert rows["request"]["steps"] == 4 and rows["request"]["launches"] == 4 * layers


def _causal(real):
    return lambda q, k, v, *, causal=True, **kw: real(q, k, v, causal=True, **kw)


def _blind_image(real):
    """Launches the op as the layer would, then answers with each stream
    attending alone."""
    blind = chip_smoke.streams_alone(torch, flash_ref, configs.get("flux-dev", smoke=True).cfg.txt_len)

    def attention(q, k, v, **kw):
        real(q, k, v, **kw)
        return blind(q, k, v).to(q.dtype)

    return attention


@pytest.mark.parametrize("name,wrong", [("dit-xl2", _causal), ("flux-dev", _blind_image)])
def test_diffusion_full_fails_a_wrong_path(smoke_diffusion_full, monkeypatch, name, wrong):
    monkeypatch.setattr(chip_smoke, "DIFF_MODELS", (name,))
    monkeypatch.setattr(flash_ops, "attention", wrong(flash_ops.attention))
    with pytest.raises(RuntimeError, match="kernel prediction differs from plain"):
        smoke_diffusion_full()


@pytest.mark.parametrize("name", chip_smoke.DIFF_MODELS)
def test_diffusion_full_fails_zero_init_modulation(smoke_diffusion_full, monkeypatch, name):
    """Seed weights as ``init_tree`` draws them: adaLN-Zero makes the
    prediction exactly 0 whatever the attention, which the phase refuses."""
    monkeypatch.setattr(chip_smoke, "DIFF_MODELS", (name,))
    monkeypatch.setattr(chip_smoke, "draw_zero_leaves", lambda common, params, specs, gen: params)
    with pytest.raises(RuntimeError, match="the prediction is 0"):
        smoke_diffusion_full()


def _params(name: str):
    cell = steps.build_cell(_smoke(name), "gen_fast")
    return cell.init_arg(0, 0, CPU), cell.arg_specs[0]


@pytest.mark.parametrize("name", chip_smoke.DIFF_MODELS)
def test_draw_zero_leaves_leaves_no_zero_leaf(name):
    params, specs = _params(name)
    before = common.tree_map(lambda t: t.clone(), params)
    zero_init = common.tree_leaves(common.tree_map(lambda s: s.init == "zeros", specs))
    assert sum(zero_init) >= 10
    assert all(not bool(t.any()) for t, z in zip(common.tree_leaves(params), zero_init) if z)
    out = chip_smoke.draw_zero_leaves(common, params, specs, torch.Generator().manual_seed(1))
    assert out is params
    for s, old, new, z in zip(common.tree_leaves(specs), common.tree_leaves(before), common.tree_leaves(params),
                              zero_init):
        assert new.shape == s.shape and new.dtype == s.dtype == torch.bfloat16
        if z:
            assert float(new.float().std()) > 0 and bool(new.any())
        else:
            assert torch.equal(new, old)


@pytest.mark.parametrize("name", chip_smoke.DIFF_MODELS)
def test_own_fan_in_scales_every_attention_stack(name):
    """DiT's one stack of blocks; Flux's three: the double blocks' image and
    text streams and the single blocks."""
    params, _ = _params(name)
    cfg = configs.get(name, smoke=True).cfg
    before = common.tree_map(lambda t: t.float(), params)
    chip_smoke.own_fan_in(params, cfg)
    paths = [("blocks",)] if name == "dit-xl2" else [("double", "img"), ("double", "txt"), ("single",)]

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree["attn"]

    d, H = cfg.d_model, cfg.n_heads
    for path in paths:
        got, was = at(params, path), at(before, path)
        for key, factor in (("wq", math.sqrt(H / d)), ("wk", math.sqrt(H / d)), ("wv", math.sqrt(H / d)),
                            ("wo", 1 / math.sqrt(H))):
            torch.testing.assert_close(got[key].float(), was[key] * factor, rtol=1e-2, atol=0)
        assert torch.equal(got["bq"].float(), was["bq"])
    if name == "flux-dev":
        assert torch.equal(params["double"]["img"]["mlp"]["w1"].float(), before["double"]["img"]["mlp"]["w1"])


def test_streams_alone_is_a_block_diagonal_mask():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 12, 4, 16, generator=g) for _ in range(3))
    mask = torch.zeros(12, 12, dtype=torch.bool)
    mask[:5, :5] = mask[5:, 5:] = True
    logits = torch.einsum("bshd,bthd->bhst", q, k) / 4.0
    want = torch.einsum("bhst,bthd->bshd", logits.masked_fill(~mask, -1e30).softmax(-1), v)
    got = chip_smoke.streams_alone(torch, flash_ref, 5)(q, k, v, causal=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_recording_sees_padded_head_dims():
    """DiT's hd 72 runs zero-padded to 128: the wrapper calls itself with
    ``sm_scale``, and main()'s recorder takes both calls (the padded one is
    what launches)."""
    seen = set()
    q, k, v = (torch.randn(2, 10, 4, 72) for _ in range(3))
    with chip_smoke.recording(flash_ops, "flash_attention", chip_smoke.flash_key, seen):
        out = flash_ops.attention(q, k, v, causal=False)
    assert out.shape == q.shape
    assert seen == {(2, 10, 10, 4, 4, 72, False, "float32"), (2, 10, 10, 4, 4, 128, False, "float32")}


def test_diffusion_shapes_are_checked_in_the_flash_phase():
    """DIFF_FLASH_SHAPES, which the flash phase times and the summary reads,
    are the published configs' attention at gen_1024 and gen_fast (their
    batches; the image tokens, and Flux's text tokens before them); 28 and
    57 launches a step."""
    want = {}
    for name in chip_smoke.DIFF_MODELS:
        arch = configs.get(name)
        cfg = arch.cfg
        for shape in map(arch.shape, chip_smoke.DIFF_SHAPES):
            S = (shape.img // 8 // cfg.patch) ** 2 + getattr(cfg, "txt_len", 0)
            want[(shape.batch, S, S, cfg.n_heads, cfg.n_heads, cfg.d_model // cfg.n_heads, False, "bfloat16")] = name
    assert chip_smoke.DIFF_FLASH_SHAPES == want
    assert set(want) <= set(chip_smoke.FLASH_SHAPES)
    assert [chip_smoke.attention_layers(configs.get(n).cfg) for n in chip_smoke.DIFF_MODELS] == [28, 57]
