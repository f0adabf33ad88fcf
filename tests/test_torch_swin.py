"""The port's Swin against the reference on the same weights
(``interop.from_jax``), on the CPU.

Tolerances and why:
  * ``_rel_bias_index``, the shift mask, patch merging, parameter counts:
    exact (the same integer arithmetic and data movement);
  * ``_window_attention`` in f32: ``test_torch_vit.py``'s ``F32`` (rtol 1e-4,
    atol 2e-5) — the same f32 arithmetic, summed in another order;
  * fake-quant and carried-across weights: bit-equal;
  * smoke forwards, on weights whose attention matrices have their own
    fan-in (``chip_smoke.own_fan_in``, as for ViT): both compute in bf16 and
    sum in different orders, so the logits must agree within ViT's 2% of the
    logit scale and top-1 on at least 63 of 64 frames, a frame changing its
    top-1 only where the reference's two classes lie within 2·max|Δ| (a tie).
    Measured at seed 11: 0.99% and 64/64 (edge), 1.00% and 64/64 (NPU).
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jquant
from repro.arch import abstract_params as jabstract
from repro.arch import classifier_forward as jforward
from repro.models import layers as JL
from repro.models import vision as jvision
from repro.models.common import ParamSpec as JSpec
from repro.models.common import matmul_backend as jbackend
from repro_torch import arch as A
from repro_torch import configs, interop, quant
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import vision
from repro_torch.models.common import matmul_backend, tree_leaves
from repro_torch.serving.engine import make_synthetic_video

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import own_fan_in  # noqa: E402

NAME = "swin-b"
F32 = dict(rtol=1e-4, atol=2e-5)
LOGIT_RTOL = 0.02
MIN_TOP1_AGREE = 63  # of 64


def _count(specs_j) -> int:
    return sum(math.prod(s.shape) for s in jax.tree.leaves(specs_j, is_leaf=lambda x: isinstance(x, JSpec)))


@pytest.mark.parametrize("w", [4, 7, 12])
def test_rel_bias_index_matches_reference(w):
    got = vision._rel_bias_index(w)
    assert got.shape == (w * w, w * w) and got.dtype == np.int64
    np.testing.assert_array_equal(got, jvision._rel_bias_index(w))
    assert got.min() == 0 and got.max() == (2 * w - 1) ** 2 - 1


@pytest.mark.parametrize("H,w,shift", [(8, 4, 2), (14, 7, 3), (56, 7, 3)])
def test_shift_mask(H, w, shift):
    """A query sees a key exactly when the cyclic shift brought both from the
    same one of the 3x3 regions the reference's slices cut: rows (and
    columns) [0, H-w), [H-w, H-shift), [H-shift, H)."""
    mask = vision._shift_mask(H, H, w, shift)
    n = H // w
    assert mask.shape == (n * n, w * w, w * w) and mask.dtype == bool

    def region(i):
        return 0 if i < H - w else (1 if i < H - shift else 2)

    for win in range(n * n):
        rows, cols = divmod(win, n)
        ids = [3 * region(rows * w + a) + region(cols * w + b) for a in range(w) for b in range(w)]
        np.testing.assert_array_equal(mask[win], np.equal.outer(ids, ids))
    assert mask[: (n - 1) * n].reshape(n - 1, n, w * w, w * w)[:, : n - 1].all()  # inner windows: one region


def _np_tree(rng, specs_j):
    """numpy weights for a reference spec tree (biases and norm scales
    non-trivial; matrices at their own fan-in)."""
    def param(s):
        if s.init == "zeros":
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if s.init == "ones":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if s.scale is not None:
            return (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)

    return jax.tree.map(param, specs_j, is_leaf=lambda x: isinstance(x, JSpec))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("H,w,shifted", [(8, 4, False), (8, 4, True), (14, 7, False), (14, 7, True)])
def test_window_attention_matches_reference_f32(H, w, shifted):
    dim, heads = 32, 4
    shift = w // 2 if shifted else 0
    rng = np.random.default_rng(H * 10 + w + shifted)
    cj = jvision.SwinConfig("s", img_res=4 * H, window=w)
    p = _np_tree(rng, JL.attention_specs(jvision._swin_attn_cfg(dim, heads)))
    p["rel_bias"] = (rng.standard_normal(((2 * w - 1) ** 2, heads)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, H * H, dim)).astype(np.float32)
    expect = np.asarray(jvision._window_attention(cj, dim, heads, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                                  H, H, shift))
    c = vision.SwinConfig("s", img_res=4 * H, window=w)
    got = vision._window_attention(c, dim, heads, _to_torch(p), torch.tensor(x), H, H, shift)
    np.testing.assert_allclose(got.numpy(), expect, **F32)


def test_patch_merge_order():
    """Channels [0:C], [C:2C], [2C:3C], [3C:4C] of a merged token are the
    (row, column) offsets (0,0), (0,1), (1,0), (1,1) of its 2x2 patch — the
    reference's order, not timm's — and the tokens run row by row."""
    B, H, W, C = 2, 6, 4, 3
    x = torch.arange(B * H * W * C, dtype=torch.float32).reshape(B, H * W, C)
    got = vision._patch_merge(x, H, W)
    grid = x.reshape(B, H, W, C)
    assert got.shape == (B, (H // 2) * (W // 2), 4 * C)
    for i in range(H // 2):
        for j in range(W // 2):
            want = torch.cat([grid[:, 2 * i + di, 2 * j + dj] for di, dj in ((0, 0), (0, 1), (1, 0), (1, 1))], -1)
            assert torch.equal(got[:, i * (W // 2) + j], want)
    xs = x.numpy().reshape(B, H // 2, 2, W // 2, 2, C).transpose(0, 1, 3, 2, 4, 5)  # the reference's lines
    np.testing.assert_array_equal(got.numpy(), xs.reshape(B, (H // 2) * (W // 2), 4 * C))


@pytest.mark.parametrize("smoke,expected", [(False, 87_768_224), (True, None)], ids=["full", "smoke"])
def test_param_counts_match_reference(smoke, expected):
    count_j = _count(jabstract(jconfigs.get(NAME, smoke=smoke))[0])
    assert A.n_params(configs.get(NAME, smoke=smoke)) == count_j
    if expected is not None:
        assert count_j == expected


def test_from_jax_carries_swin_weights():
    """Only the patch-embedding conv is transposed (HWIO -> OIHW);
    ``rel_bias [L, (2w-1)², heads]`` and ``merge.w`` arrive as they are."""
    arch = configs.get(NAME, smoke=True)
    _, params_j, _ = reference_params(NAME, seed=4)
    params, state = interop.from_jax(arch, params_j, {}, device=CPU)
    assert state == {}
    np.testing.assert_array_equal(params["patch_embed"]["w"].numpy(),
                                  params_j["patch_embed"]["w"].transpose(3, 2, 0, 1))
    blocks_j, blocks = params_j["stage0"]["blocks"], params["stage0"]["blocks"]
    assert blocks["rel_bias"].shape == (2, 49, 2)
    np.testing.assert_array_equal(blocks["rel_bias"].numpy(), blocks_j["rel_bias"])
    np.testing.assert_array_equal(params["stage0"]["merge"]["w"].numpy(), params_j["stage0"]["merge"]["w"])
    np.testing.assert_array_equal(blocks["attn"]["wq"].numpy(), blocks_j["attn"]["wq"])


def test_from_jax_rejects_mismatched_trees():
    arch = configs.get(NAME, smoke=True)
    _, vit_j, _ = reference_params("vit-s16", seed=0)
    with pytest.raises(ValueError):
        interop.from_jax(arch, vit_j, {}, device=CPU)
    _, params_j, _ = reference_params(NAME, seed=0)
    params_j["stage1"]["blocks"]["rel_bias"] = params_j["stage1"]["blocks"]["rel_bias"][:, :25]  # a 3x3 window's
    with pytest.raises(ValueError):
        interop.from_jax(arch, params_j, {}, device=CPU)


@pytest.fixture(scope="module")
def smoke_weights():
    """The smoke Swin's weights drawn by the reference from seed 11, the
    attention matrices at their own fan-in, and the reference's fake-quant
    weights, computed eagerly as its calibration does."""
    arch_j, params_j, _ = reference_params(NAME, seed=11)
    arch = configs.get(NAME, smoke=True)
    own_fan_in(params_j, arch.cfg)
    qparams_j = jax.tree.map(np.asarray, jquant.fake_quant_tree(jax.tree.map(jnp.asarray, params_j)))
    return arch_j, params_j, qparams_j, arch


def test_npu_variant_bit_equal(smoke_weights):
    """Per last axis for every rank >= 2 leaf: ``rel_bias`` per head,
    ``wq [L, d, H, hd]`` and ``bq [L, H, hd]`` per hd, the stacked norm
    scales per channel; the patch-embedding conv per output channel."""
    _, params_j, qparams_j, arch = smoke_weights
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    q_t, stats = quant.npu_variant(params, A.abstract_params(arch)[0])
    q_j, _ = interop.from_jax(arch, qparams_j, {}, device=CPU)
    for a, b in zip(tree_leaves(q_t), tree_leaves(q_j)):
        assert torch.equal(a, b)
    assert quant.quant_error_stats(params, q_j) == stats
    rb, rb_q = params["stage0"]["blocks"]["rel_bias"], q_t["stage0"]["blocks"]["rel_bias"]
    scale = rb.abs().amax(dim=(0, 1)) / 127.0  # one scale per head
    assert torch.equal(rb_q, torch.round(rb / scale) * scale)
    assert torch.equal(q_t["ln_f"]["scale"], params["ln_f"]["scale"])  # 1-D: kept


@pytest.fixture(scope="module")
def smoke_logits(smoke_weights):
    """(port, reference) logits of 64 frames for each variant."""
    arch_j, params_j, qparams_j, arch = smoke_weights
    frames, _ = make_synthetic_video(64, res=32, seed=5)

    def f_j(p, x):
        return jforward(arch_j, p, {}, x, train=False)[0]

    def f_t(p, x):
        return A.classifier_forward(arch, p, {}, x, train=False)[0]

    out = {}
    for variant, fj, pj, ft in (("edge", f_j, params_j, f_t),
                                ("npu", jquant.npu_forward(f_j, interpret=True), qparams_j, quant.npu_forward(f_t))):
        params, _ = interop.from_jax(arch, pj, {}, device=CPU)
        out_j = np.asarray(jax.jit(fj)(jax.tree.map(jnp.asarray, pj), jnp.asarray(frames)))
        with torch.no_grad():
            out[variant] = (ft(params, torch.tensor(frames)).numpy(), out_j)
    return out


@pytest.mark.parametrize("variant", ["edge", "npu"])
def test_smoke_forward_matches_reference(smoke_logits, variant):
    out, ref = smoke_logits[variant]
    assert out.shape == ref.shape == (64, 10) and out.dtype == np.float32
    err = float(np.max(np.abs(out - ref)))
    assert err <= LOGIT_RTOL * float(np.max(np.abs(ref))), err
    top = out.argmax(-1)
    same = top == ref.argmax(-1)
    tie = np.take_along_axis(ref, top[:, None], -1)[:, 0] >= ref.max(-1) - 2 * err
    assert int(same.sum()) >= MIN_TOP1_AGREE and not bool((~same & ~tie).any()), (int(same.sum()))


def test_npu_forward_issues_no_backend_gemm_and_no_flash(monkeypatch):
    """Every matmul of a Swin is an einsum or ``@`` that bypasses
    ``models.common.matmul`` in the reference, so its NPU variant issues no
    int8 GEMM in either package; its window attention is inline, so the
    flash op is never called.  The smoke config shifts its odd blocks
    (H = 8 > window 4)."""
    arch_j, params_j, _ = reference_params(NAME, seed=0)
    arch = configs.get(NAME, smoke=True)
    assert arch.cfg.img_res // arch.cfg.patch > arch.cfg.window
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    calls, calls_j = [], []
    real = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: (calls.append("flash"), real(*a, **k))[1])
    with matmul_backend(lambda a, b: (calls.append(a.shape), a @ b)[1]), torch.no_grad():
        A.classifier_forward(arch, params, {}, torch.zeros(1, 32, 32, 3), train=False)

    def traced(p, x):
        with jbackend(lambda a, b: (calls_j.append(a.shape), a @ b)[1]):
            return jforward(arch_j, p, {}, x, train=False)[0]

    jax.eval_shape(traced, jax.tree.map(jnp.asarray, params_j), jnp.zeros((1, 32, 32, 3)))
    assert calls == calls_j == []
