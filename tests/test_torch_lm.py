"""The port's decoder LMs (``models/lm``) and their decode layers against the
reference, on the CPU, on the same weights (``interop.from_jax``), for the
smoke configs of all four LMs.

Tolerances and why:
  * int8 outputs (``quantize_kv``'s values, int8 caches) and lengths: exactly
    equal; ``quantize_kv``'s scales ``==`` (the same f32 division, rounding
    half to even on both sides);
  * floats in f32: ``F32`` (rtol 1e-4, atol 2e-5) — the same f32 arithmetic
    summed in another order.  Prefill and decode run in f32 by standing in a
    ``torch`` / ``jnp`` whose ``bfloat16`` is float32 in both ``lm`` modules
    (as ``tests/test_torch_effnet.py`` does), so the comparison is of the
    algorithm, not of where bf16 rounds;
  * logits in bf16 (the packages as they run): within ``LOGIT_RTOL`` = 2% of
    max|logit|, the ViT and Swin tests' rule, on weights whose attention
    matrices have their own fan-in (``chip_smoke.own_fan_in``);
  * in the port alone, decode equals prefill within the reference's own
    rtol/atol 2e-4 (``tests/test_models.py:60-74``), an MoE against a prefill
    that drops no token; the int8 cache is within 5% of the bf16 cache with
    equal top-1 (``tests/test_models.py:161-184``).
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.arch import abstract_params as jabstract
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.common import param_bytes as jparam_bytes
from repro.models.common import param_count as jparam_count
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.models import common
from repro_torch.models import layers as L
from repro_torch.models import lm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import own_fan_in  # noqa: E402

F32 = dict(rtol=1e-4, atol=2e-5)
LOGIT_RTOL = 0.02
LMS = ("qwen3-0.6b", "command-r-35b", "qwen2-moe-a2.7b", "deepseek-moe-16b")
FULL_PARAMS = {"qwen3-0.6b": 751_632_384, "command-r-35b": 32_380_690_432,
               "qwen2-moe-a2.7b": 15_146_256_384, "deepseek-moe-16b": 16_879_568_896}


class _F32:
    """A stand-in for a module's ``torch`` / ``jnp`` whose ``bfloat16`` is
    float32, so a step that casts to bf16 computes in f32."""

    def __init__(self, mod, f32):
        self._mod, self.bfloat16 = mod, f32

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(lm, "torch", _F32(torch, torch.float32))
    monkeypatch.setattr(jlm, "jnp", _F32(jnp, jnp.float32))


def _weights(name: str, seed: int, *, own: bool = False, quant: bool = False):
    """(reference cfg, numpy params, port cfg, port params): the smoke
    config's weights drawn with numpy and carried across."""
    arch_j, params_j, _ = reference_params(name, seed)
    arch = configs.get(name, smoke=True)
    if own:
        own_fan_in(params_j, arch.cfg)
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    cfg_j, cfg = arch_j.cfg, arch.cfg
    if quant:
        cfg_j, cfg = dataclasses.replace(cfg_j, kv_quant=True), dataclasses.replace(cfg, kv_quant=True)
    return cfg_j, params_j, cfg, params


def _tokens(cfg, seed: int, shape=(2, 12)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_cache_equal(cache_t, cache_j):
    assert set(cache_t) == set(cache_j)
    for key, ref in cache_j.items():
        got, ref = _np(cache_t[key]), np.asarray(ref)
        assert got.shape == ref.shape, key
        if key in ("len", "k", "v") and ref.dtype in (np.int8, np.int32):
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref.astype(np.float32), err_msg=key, **F32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,d_ff,lead", [(64, 128, (2, 12)), (96, 80, (3,))])
def test_swiglu_matches_reference(d, d_ff, lead):
    rng = np.random.default_rng(d + d_ff)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, d_ff)), ("w_up", (d, d_ff)), ("w_down", (d_ff, d)))}
    x = rng.standard_normal((*lead, d)).astype(np.float32)
    want = np.asarray(JL.swiglu(_jtree(p), jnp.asarray(x)))
    got = L.swiglu({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert L.swiglu_specs(d, d_ff) == {k: common.spec(s.shape, s.axes) for k, s in JL.swiglu_specs(d, d_ff).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    rng = np.random.default_rng(7)
    t = (rng.standard_normal((3, 9, 2, 16)) * rng.uniform(0.01, 30, (3, 9, 2, 1))).astype(np.float32)
    t[0, 0, 0] = 0.0  # amax 0: scale 1
    t[1, 2, 1, :4] = [127.0, 63.5, -0.5, 1.5]  # exact halves at scale 1: round half to even
    t[1, 2, 1, 4:] = 0.0
    tj = jnp.asarray(t, getattr(jnp, dtype))
    tt = torch.tensor(t).to(getattr(torch, dtype))
    qj, sj = JL.quantize_kv(tj)
    qt, st = L.quantize_kv(tt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for out in (torch.float32, torch.bfloat16):
        want = np.asarray(JL.dequantize_kv(qj, sj, jnp.float32 if out == torch.float32 else jnp.bfloat16))
        np.testing.assert_array_equal(_np(L.dequantize_kv(qt, st, out)), want.astype(np.float32))


# cache_len in the middle, at the last slot, and past it (the write clamps to
# T - 1, the mask and the rotary position use the unclamped length)
@pytest.mark.parametrize("cache_len", [5, 11, 14])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_attention_decode_matches_reference(cache_len, quant):
    name = "qwen3-0.6b"
    rng = np.random.default_rng(cache_len + 100 * quant)
    cfg_j, params_j, cfg, params = _weights(name, 3)
    c_j, c = cfg_j.attn_cfg(), cfg.attn_cfg()
    attn_j = jax.tree.map(lambda a: a[0], params_j["blocks"]["attn"])
    attn = common.unstack_tree(params["blocks"]["attn"])[0]
    B, T, KH, hd = 2, 12, cfg.n_kv_heads, cfg.hd
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, B, T, KH, hd)).astype(np.float32)
    if quant:
        caches = [np.asarray(a) for pair in (JL.quantize_kv(jnp.asarray(kv[0])), JL.quantize_kv(jnp.asarray(kv[1])))
                  for a in pair]  # k, k_scale, v, v_scale
        ck, ks, cv, vs = caches
        out_j = JL.attention_decode(c_j, attn_j, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(cache_len, jnp.int32), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        bufs = [torch.tensor(a.copy()) for a in (ck, cv, ks, vs)]
        out_t = L.attention_decode(c, attn, torch.tensor(x), bufs[0], bufs[1], torch.tensor(cache_len, dtype=torch.int32),
                                   k_scale=bufs[2], v_scale=bufs[3])
        assert all(o is b for o, b in zip(out_t[1:], bufs))  # updated in place and returned
        for got, want in zip(out_t[1:3], out_j[1:3]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(out_t[3:], out_j[3:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    else:
        out_j = JL.attention_decode(c_j, attn_j, jnp.asarray(x), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                    jnp.asarray(cache_len, jnp.int32))
        bufs = [torch.tensor(kv[0].copy()), torch.tensor(kv[1].copy())]
        out_t = L.attention_decode(c, attn, torch.tensor(x), *bufs, torch.tensor(cache_len, dtype=torch.int32))
        assert out_t[1] is bufs[0] and out_t[2] is bufs[1]
        for got, want in zip(out_t[1:], out_j[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        written = min(cache_len, T - 1)
        untouched = [t for t in range(T) if t != written]
        np.testing.assert_array_equal(out_t[1].numpy()[:, untouched], kv[0][:, untouched])
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), **F32)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,quant", [(n, False) for n in LMS] + [("qwen3-0.6b", True), ("qwen2-moe-a2.7b", True)])
def test_prefill_matches_reference_f32(f32_mode, name, quant):
    cfg_j, params_j, cfg, params = _weights(name, 1, quant=quant)
    tokens = _tokens(cfg, 2)
    lj, cj = jlm.prefill(cfg_j, _jtree(params_j), jnp.asarray(tokens), max_len=16)
    lt, ct = lm.prefill(cfg, params, torch.tensor(tokens), max_len=16)
    assert lt.shape == (2, 1, cfg.vocab) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    _assert_cache_equal(ct, cj)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_forward_matches_reference_f32(f32_mode, name):
    """The full-sequence forward (hidden states after ``ln_f``, MoE aux loss)."""
    cfg_j, params_j, cfg, params = _weights(name, 8)
    tokens = _tokens(cfg, 9)
    hj, auxj = jlm.forward(cfg_j, _jtree(params_j), jnp.asarray(tokens))
    with torch.no_grad():
        ht, auxt = lm.forward(cfg, params, torch.tensor(tokens))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **F32)
    np.testing.assert_allclose(float(auxt), float(auxj), **F32)
    assert (float(auxt) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("name,quant", [(n, False) for n in LMS] + [("qwen3-0.6b", True), ("deepseek-moe-16b", True)])
def test_decode_steps_match_reference_f32(f32_mode, name, quant):
    """Prefill 8 tokens into a 12-slot cache, then decode 4 steps."""
    cfg_j, params_j, cfg, params = _weights(name, 4, quant=quant)
    tokens = _tokens(cfg, 5)
    pj, cache_j = jlm.prefill(cfg_j, _jtree(params_j), jnp.asarray(tokens[:, :8]), max_len=12)
    _, cache_t = lm.prefill(cfg, params, torch.tensor(tokens[:, :8]), max_len=12)
    for s in range(8, 12):
        lj, cache_j = jlm.decode_step(cfg_j, _jtree(params_j), jnp.asarray(tokens[:, s:s + 1]), cache_j)
        lt, cache_t = lm.decode_step(cfg, params, torch.tensor(tokens[:, s:s + 1]), cache_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {s}", **F32)
    assert int(cache_t["len"]) == 12
    _assert_cache_equal(cache_t, cache_j)


@pytest.mark.parametrize("name", LMS)
def test_bf16_prefill_and_decode_logits_match_reference(name):
    cfg_j, params_j, cfg, params = _weights(name, 6, own=True)
    tokens = _tokens(cfg, 7)
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params_j)
    pt = common.tree_map(lambda t: t.to(torch.bfloat16), params)
    lj, cache_j = jax.jit(lambda p, t: jlm.prefill(cfg_j, p, t, max_len=14))(pj, jnp.asarray(tokens))
    lt, cache_t = lm.prefill(cfg, pt, torch.tensor(tokens), max_len=14)
    step = jax.jit(lambda p, t, c: jlm.decode_step(cfg_j, p, t, c))
    outs = [(lt, lj)]
    for s in range(2):
        tok = tokens[:, s:s + 1]
        lj, cache_j = step(pj, jnp.asarray(tok), cache_j)
        lt, cache_t = lm.decode_step(cfg, pt, torch.tensor(tok), cache_t)
        outs.append((lt, lj))
    for i, (got, want) in enumerate(outs):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= LOGIT_RTOL * scale, (i, float(np.abs(got - want).max()), scale)
    assert int(cache_t["len"]) == int(cache_j["len"]) == 14


def _no_drop(cfg):
    """``cfg`` with a capacity that drops no token in any prefill."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


@pytest.mark.parametrize("name", LMS)
def test_decode_matches_prefill(name):
    """Feeding tokens one at a time through decode_step gives the prefill's
    last-token logits (an MoE: a prefill that drops no token; decode never
    drops, each token's top-k experts being distinct)."""
    arch = configs.get(name, smoke=True)
    cfg = arch.cfg
    params = common.init_tree(torch.Generator().manual_seed(0), lm.abstract_params(cfg), device=CPU)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    logits_p, _ = lm.prefill(_no_drop(cfg), params, tokens, max_len=16)
    cache = lm.make_cache(cfg, 2, 16, device=CPU)
    for s in range(12):
        lg, cache = lm.decode_step(cfg, params, tokens[:, s:s + 1], cache)
    torch.testing.assert_close(lg.float(), logits_p.float(), rtol=2e-4, atol=2e-4)


def test_int8_kv_cache_decode_close_to_fp():
    arch = configs.get("qwen3-0.6b", smoke=True)
    cfg = arch.cfg
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    params = common.init_tree(torch.Generator().manual_seed(0), lm.abstract_params(cfg), device=CPU)
    tokens = torch.randint(0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(1))
    c_fp, c_q = lm.make_cache(cfg, 2, 12, device=CPU), lm.make_cache(cfgq, 2, 12, device=CPU)
    assert c_q["k"].dtype == torch.int8 and c_q["k_scale"].dtype == torch.float32
    for s in range(10):
        lf, c_fp = lm.decode_step(cfg, params, tokens[:, s:s + 1], c_fp)
        lq, c_q = lm.decode_step(cfgq, params, tokens[:, s:s + 1], c_q)
    rel = float(torch.linalg.norm((lf - lq).float()) / torch.linalg.norm(lf.float()))
    assert 0 < rel < 0.05
    assert torch.equal(lf.argmax(-1), lq.argmax(-1))


# ---------------------------------------------------------------------------
# Params: counts, bytes, carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LMS)
def test_full_config_sized_without_allocation(name):
    arch, arch_j = configs.get(name), jconfigs.get(name)
    specs, state = A.abstract_params(arch)
    specs_j, _ = jabstract(arch_j)
    assert state == {}
    assert A.n_params(arch) == common.param_count(specs) == jparam_count(specs_j) == FULL_PARAMS[name]
    assert common.param_bytes(specs) == jparam_bytes(specs_j) == 4 * FULL_PARAMS[name]
    bf16 = common.tree_map(lambda s: dataclasses.replace(s, dtype=torch.bfloat16), specs)
    assert common.param_bytes(bf16) == 2 * FULL_PARAMS[name]
    meta = common.abstract_tree(specs)
    leaves, leaves_j = common.tree_leaves(meta), jax.tree.leaves(jax.tree.map(
        lambda s: s.shape, specs_j, is_leaf=lambda x: hasattr(x, "axes")), is_leaf=lambda x: isinstance(x, tuple))
    assert all(t.device.type == "meta" for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [tuple(s) for s in leaves_j]
    assert dataclasses.asdict(arch.cfg) == dataclasses.asdict(arch_j.cfg)
    assert arch.notes == arch_j.notes
    assert [dataclasses.asdict(s) for s in arch.shapes] == [dataclasses.asdict(s) for s in arch_j.shapes]


def test_embed_fan_in_and_policies():
    assert common._fan_in((151936, 1024), "embed") == 1.0
    assert common._fan_in((3, 1024, 16, 128), "normal") == 16.0
    assert common.SERVE_POLICY.param_dtype == torch.bfloat16 and common.TRAIN_POLICY.param_dtype == torch.float32
    tree = {"w": torch.ones(2, dtype=torch.float32), "i": torch.ones(2, dtype=torch.int32)}
    cast = common.TRAIN_POLICY.cast(tree)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


def test_large_leaf_drawn_in_slices(monkeypatch):
    """A leaf above ``DRAW_ELEMENTS`` is drawn a run of leading-axis slices at
    a time: same shape and scale, cast to the spec's dtype."""
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 1000)
    s = common.spec((5, 40, 30), ("layers", "embed", "mlp"), dtype=torch.bfloat16)
    x = common.init_param(torch.Generator().manual_seed(0), s, CPU)
    assert x.shape == (5, 40, 30) and x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) - 1 / np.sqrt(40)) < 0.02
    assert not torch.equal(x[0], x[1])


@pytest.mark.parametrize("name", LMS)
def test_from_jax_carries_lm_weights(name):
    arch_j, params_j, _ = reference_params(name, 9)
    arch = configs.get(name, smoke=True)
    params, state = interop.from_jax(arch, params_j, {}, device=CPU)
    assert state == {}
    flat_j = jax.tree_util.tree_leaves_with_path(params_j)
    assert len(flat_j) == len(common.tree_leaves(params))
    for path, leaf in flat_j:
        got = params
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), leaf)
    bad = dict(params_j, blocks={k: v for k, v in params_j["blocks"].items() if k != "ln2"})
    with pytest.raises(ValueError):
        interop.from_jax(arch, bad, {}, device=CPU)


def test_make_inputs(monkeypatch):
    arch = configs.get("qwen3-0.6b", smoke=True)
    a = dataclasses.replace(arch, shapes=(A.ShapeSpec("p", "prefill", 3, seq=20),))
    x = A.make_inputs(a, a.shape("p"), 4, device=CPU)
    y = A.make_inputs(a, a.shape("p"), torch.Generator().manual_seed(4), device=CPU)
    assert x["tokens"].shape == (3, 20) and x["tokens"].dtype == torch.int32
    assert torch.equal(x["tokens"], y["tokens"])
    assert 0 <= int(x["tokens"].min()) and int(x["tokens"].max()) < arch.cfg.vocab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        A.make_inputs(a, a.shape("p"), 4)  # the card by default, and no fallback
