"""The port's transformer layers and ViT against the reference, on the CPU,
on the same weights (``interop.from_jax``).

Tolerances and why:
  * layers in f32 (layernorm, rmsnorm/RoPE through attention, the GELU MLP,
    attention on both of its branches): rtol 1e-4 / atol 2e-5 — the same
    f32 arithmetic, summed in another order;
  * fake-quant weights and carried-across weights: bit-equal;
  * the smoke ViT forward, on weights whose attention matrices have their
    own fan-in (``chip_smoke.own_fan_in``; the reference's init makes the
    softmax near one-hot, and then a bf16 ulp flips it): both compute in
    bf16, and their matmuls sum in different orders, so a rounded value
    differs by an ulp here and there.  The logits must agree within 2% of
    the logit scale and top-1 on at least 63 of 64 frames, and a frame may
    change its top-1 only where the reference's two classes lie within
    2·max|Δ| (a tie).  Measured at seed 11: 0.76% and 63/64 (one tie) for
    the edge variant, 0.90% and 64/64 for the NPU variant.  Over seeds 0-11
    (``python tests/test_torch_vit.py``) the port is 0.73-1.30% from the
    jitted reference, with top-1 equal on 61-64 frames and every change a
    tie; the reference is 0.12-0.29% from itself run eagerly.  At the
    reference's own init the port is 1.54-5.55% from it.
"""
from __future__ import annotations

import sys
from pathlib import Path

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro import serving as jserving
from repro.arch import classifier_forward as jforward
from repro.models import layers as JL
from repro.models.common import matmul_backend as jbackend
from repro_torch import arch as A
from repro_torch import configs, interop, quant, serving, session
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.models.common import matmul_backend, tree_leaves
from repro_torch.serving.calibrate import calibrate_model
from repro_torch.serving.engine import make_synthetic_video

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import own_fan_in  # noqa: E402

F32 = dict(rtol=1e-4, atol=2e-5)
LOGIT_RTOL = 0.02
MIN_TOP1_AGREE = 63  # of 64


def _tree(rng, specs_j):
    """numpy weights for a reference spec tree (biases and norm scales
    non-trivial, so every parameter is exercised)."""
    from repro.models.common import ParamSpec

    def param(s):
        if s.init == "zeros":
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if s.init == "ones":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)

    return jax.tree.map(param, specs_j, is_leaf=lambda x: isinstance(x, ParamSpec))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 17, 384)])
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    p = _tree(rng, JL.layernorm_specs(shape[-1]))
    expect = np.asarray(JL.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    np.testing.assert_allclose(L.layernorm(_to_torch(p), torch.tensor(x)).numpy(), expect, **F32)


@pytest.mark.parametrize("d,d_ff", [(64, 128), (384, 1536)])
def test_mlp_matches_reference(d, d_ff):
    """The GELU MLP in f32: ``jax.nn.gelu`` defaults to the tanh form."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    p = _tree(rng, JL.mlp_specs(d, d_ff))
    expect = np.asarray(JL.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    np.testing.assert_allclose(L.mlp(_to_torch(p), torch.tensor(x)).numpy(), expect, **F32)


ATTN_CASES = {  # name: (causal, rope, qk_norm, n_heads, n_kv_heads, head_dim)
    "vit": (False, False, False, 4, 4, 16),
    "causal": (True, False, False, 4, 4, 32),
    "causal_rope_gqa": (True, True, False, 8, 2, 16),
    "rope_qknorm": (False, True, True, 4, 2, 32),
}


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "autograd"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case, grad):
    """``layers.attention`` in f32 with biases: without an autograd graph it
    runs the flash op (the plain version on the CPU); with one it takes the
    reference's ``_sdpa`` branch.  Both equal the reference's."""
    causal, rope, qk_norm, H, KH, hd = ATTN_CASES[case]
    kw = dict(d_model=64, n_heads=H, n_kv_heads=KH, head_dim=hd, causal=causal, rope=rope,
              qk_norm=qk_norm, bias=True)
    rng = np.random.default_rng(H * hd + causal)
    p = _tree(rng, JL.attention_specs(JL.AttnCfg(**kw)))
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    y_j, (k_j, v_j) = JL.attention(JL.AttnCfg(**kw), jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    pt = _to_torch(p)
    for t in tree_leaves(pt):
        t.requires_grad_(grad)
    calls0 = flash_ops.flash_attention.launches
    with torch.set_grad_enabled(grad):
        y, (k, v) = L.attention(L.AttnCfg(**kw), pt, torch.tensor(x))
    if grad:
        y.sum().backward()
        assert pt["wq"].grad is not None and bool(torch.isfinite(pt["wq"].grad).all())
    assert flash_ops.flash_attention.launches == calls0  # the CPU launches no kernel
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **F32)
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(k_j), **F32)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_j), **F32)


@pytest.mark.parametrize("grad", [False, True])
def test_attention_dispatch(grad, monkeypatch):
    """The flash op runs exactly when no autograd graph is built: once per
    block of a ViT forward, never while training."""
    calls = []
    real = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    arch = configs.get("vit-s16", smoke=True)
    _, params_j, _ = reference_params("vit-s16", seed=3)
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    for t in tree_leaves(params):
        t.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        A.classifier_forward(arch, params, {}, torch.zeros(2, 32, 32, 3), train=grad)
    assert len(calls) == (0 if grad else arch.cfg.n_layers)


def test_from_jax_carries_vit_weights():
    """Only the patch-embedding conv is transposed (HWIO -> OIHW); the
    stacked rank-4 attention weights arrive as they are."""
    arch = configs.get("vit-s16", smoke=True)
    _, params_j, _ = reference_params("vit-s16", seed=4)
    params, state = interop.from_jax(arch, params_j, {}, device=CPU)
    assert state == {}
    blocks_j, blocks = params_j["blocks"]["attn"], params["blocks"]["attn"]
    for name in ("wq", "wk", "wv", "wo", "bq", "bo"):
        np.testing.assert_array_equal(blocks[name].numpy(), blocks_j[name])
    assert blocks["wq"].shape == (2, 64, 4, 16) and blocks["wo"].shape == (2, 4, 16, 64)
    np.testing.assert_array_equal(params["patch_embed"]["w"].numpy(),
                                  params_j["patch_embed"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(params["pos"].numpy(), params_j["pos"])


def _reference_qparams(params_j):
    """The reference's fake-quant weights, computed eagerly as its
    calibration does."""
    return jax.tree.map(np.asarray, jquant.fake_quant_tree(jax.tree.map(jnp.asarray, params_j)))


def test_npu_variant_bit_equal():
    """Per last axis for every non-conv leaf (``wq [L, d, H, hd]`` per hd),
    per output channel for the patch-embedding conv: the reference's."""
    arch = configs.get("vit-s16", smoke=True)
    _, params_j, _ = reference_params("vit-s16", seed=11)
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    q_t, stats = quant.npu_variant(params, A.abstract_params(arch)[0])
    q_j, _ = interop.from_jax(arch, _reference_qparams(params_j), {}, device=CPU)
    for a, b in zip(tree_leaves(q_t), tree_leaves(q_j)):
        assert torch.equal(a, b)
    assert quant.quant_error_stats(params, q_j) == stats
    assert stats.leaves_quantized > 0


def _smoke_logits(variant: str, seed: int, *, fan_in: bool = True, jit: bool = True):
    """(port, reference) logits of the smoke ViT on 64 frames, the weights
    drawn by the reference from ``seed`` and carried across by ``from_jax``."""
    arch_j, params_j, _ = reference_params("vit-s16", seed=seed)
    arch = configs.get("vit-s16", smoke=True)
    if fan_in:
        own_fan_in(params_j, arch.cfg)
    frames, _ = make_synthetic_video(64, res=32, seed=5)

    def f_j(p, x):
        return jforward(arch_j, p, {}, x, train=False)[0]

    def f_t(p, x):
        return A.classifier_forward(arch, p, {}, x, train=False)[0]

    p_j = params_j
    if variant == "npu":
        p_j = _reference_qparams(params_j)
        f_j = jquant.npu_forward(f_j, interpret=True)
        f_t = quant.npu_forward(f_t)
    params, _ = interop.from_jax(arch, p_j, {}, device=CPU)
    out_j = np.asarray((jax.jit(f_j) if jit else f_j)(jax.tree.map(jnp.asarray, p_j), jnp.asarray(frames)))
    with torch.no_grad():
        out = f_t(params, torch.tensor(frames)).numpy()
    return out, out_j


def _agreement(out, ref):
    """(max|Δ| over max|ref|, frames with equal top-1, top-1 changes that are
    not ties of ``ref`` within 2·max|Δ|)."""
    err = float(np.max(np.abs(out - ref)))
    top = out.argmax(-1)
    same = top == ref.argmax(-1)
    tie = np.take_along_axis(ref, top[:, None], -1)[:, 0] >= ref.max(-1) - 2 * err
    return err / float(np.max(np.abs(ref))), int(same.sum()), int((~same & ~tie).sum())


@pytest.mark.parametrize("variant", ["edge", "npu"])
def test_smoke_forward_matches_reference(variant):
    out, out_j = _smoke_logits(variant, seed=11)
    assert out.shape == out_j.shape == (64, 10) and out.dtype == np.float32
    rel, agree, flips = _agreement(out, out_j)
    assert rel <= LOGIT_RTOL, rel
    assert agree >= MIN_TOP1_AGREE and flips == 0, (agree, flips)


def test_npu_forward_issues_no_backend_gemm():
    """A ViT's matmuls never go through ``models.common.matmul`` in the
    reference, so its NPU variant launches no int8 GEMM in either package."""
    arch_j, params_j, _ = reference_params("vit-s16", seed=0)
    arch = configs.get("vit-s16", smoke=True)
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    calls, calls_j = [], []
    with matmul_backend(lambda a, b: (calls.append(a.shape), a @ b)[1]), torch.no_grad():
        A.classifier_forward(arch, params, {}, torch.zeros(1, 32, 32, 3), train=False)

    def traced(p, x):
        with jbackend(lambda a, b: (calls_j.append(a.shape), a @ b)[1]):
            return jforward(arch_j, p, {}, x, train=False)[0]

    jax.jit(traced)(jax.tree.map(jnp.asarray, params_j), jnp.zeros((1, 32, 32, 3)))
    assert calls == calls_j == []


def test_calibrate_vit_on_cpu(tmp_path):
    """``calibrate_model("vit-s16")`` at a tiny budget: a payload both
    packages load; on the CPU no kernel launches while timing."""
    cfg = serving.CalibrationConfig(
        model_names=("vit-s16",), train_steps={"vit-s16": 3}, batch_sizes=(1, 2), warmup=1,
        repeats=1, holdout_frames=16,
    )
    cm = calibrate_model("vit-s16", cfg, device=CPU)
    prov = cm.payload["provenance"]
    assert prov["kernel"] == "kernels/npu_matmul/ref.py, kernels/flash_attention/ref.py (plain torch, cpu)"
    assert prov["kernel_launches_timed"] == {"int8_matmul": 0, "flash_attention": 0}
    assert prov["train_steps"] == 3 and np.isfinite(prov["final_loss"])
    assert set(cm.payload["acc_server"]) == {"45", "90", "134", "179", "224"}
    art = {"schema": "repro/calibration@1", "models": [cm.payload]}
    path = serving.save_calibration(art, tmp_path / "vit.json")
    spec = session.ScenarioSpec(policy="max_accuracy", models=serving.load_calibration(path)["models"], n_frames=4)
    ref_spec = jserving.load_calibration(path)["models"]
    assert spec.models[0].name == ref_spec[0]["name"] == "vit-s16"
    assert spec.models[0].t_npu == pytest.approx(cm.payload["t_npu_ms"] / 1e3)
    logits = cm.npu_endpoint(np.zeros((2, cfg.res, cfg.res, 3), np.float32))
    assert logits.shape == (2, cfg.n_classes)


def main(seeds) -> None:
    """Per-seed readings behind the smoke forward's limits: the port against
    the jitted reference, and the reference jitted against itself eager, on
    weights at their own fan-in and at the reference's init."""
    print("seed variant init      port-vs-jit          jit-vs-eager (rel. max|d|, top-1 equal /64, non-tie flips)")
    for seed in seeds:
        for variant in ("edge", "npu"):
            for fan_in in (True, False):
                out, out_j = _smoke_logits(variant, seed, fan_in=fan_in)
                _, out_e = _smoke_logits(variant, seed, fan_in=fan_in, jit=False)
                a, b = _agreement(out, out_j), _agreement(out_j, out_e)
                print(f"{seed:>4} {variant:<7} {'own' if fan_in else 'ref':<9} {a[0]:.4%} {a[1]} {a[2]}    "
                      f"{b[0]:.4%} {b[1]} {b[2]}", flush=True)


if __name__ == "__main__":
    main(range(int(sys.argv[1]) if len(sys.argv) > 1 else 12))
