"""The port's flash attention (its CPU path, the plain version) against the
reference's Pallas kernel in interpret mode and its jnp oracle.

Tolerances are tests/test_kernels.py's own and why:
  * f32: rtol 1e-4 / atol 2e-5 — the same softmax in f32, summed in another
    order (and online, block by block, in the Pallas kernel);
  * bf16: rtol 0.05 / atol 0.02 against the oracle on f32-upcast inputs —
    the bf16 inputs and the bf16 cast of the output;
  * ``blockwise_sdpa``: rtol 1e-5 / atol 2e-6 — the same online-softmax
    algorithm in f32 on both sides.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fk
from repro.kernels.flash_attention import ref as fr
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as L

F32 = dict(rtol=1e-4, atol=2e-5)
BF16 = dict(rtol=0.05, atol=0.02)
SHAPES = [  # tests/test_kernels.py:140-144
    (2, 128, 128, 8, 4, 64, True),
    (1, 100, 200, 4, 4, 32, False),
    (2, 257, 257, 8, 2, 64, True),
    (1, 64, 512, 16, 8, 128, True),
    (1, 33, 65, 2, 1, 16, False),
]


def _qkv(b, s, t, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kh, hd)).astype(np.float32)
    return q, k, v


def _both(q, k, v, causal, block):
    """(reference kernel in interpret mode, reference oracle) as numpy."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern = fk.flash_attention(jq, jk, jv, causal=causal, block_q=block, block_kv=block, interpret=True)
    return np.asarray(kern), np.asarray(fr.sdpa_ref(jq, jk, jv, causal=causal))


@pytest.mark.parametrize("b,s,t,h,kh,hd,causal", SHAPES)
def test_attention_matches_reference_f32(b, s, t, h, kh, hd, causal):
    q, k, v = _qkv(b, s, t, h, kh, hd, seed=s * t)
    kern, oracle = _both(q, k, v, causal, 64)
    out = ops.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal)
    assert out.shape == (b, s, h, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), kern, **F32)
    np.testing.assert_allclose(out.numpy(), oracle, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bf16(causal):
    """tests/test_kernels.py:157-168: bf16 in, bf16 out, held against the
    oracle on the f32-upcast inputs."""
    q, k, v = _qkv(2, 128, 128, 8, 4, 64, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    up = [np.asarray(a.astype(jnp.float32)) for a in (jq, jk, jv)]
    oracle = np.asarray(fr.sdpa_ref(*(jnp.asarray(a) for a in up), causal=causal))
    kern = np.asarray(
        fk.flash_attention(jq, jk, jv, causal=causal, block_q=64, block_kv=64, interpret=True), np.float32
    )
    out = ops.attention(*(torch.tensor(a).to(torch.bfloat16) for a in up), causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), oracle, **BF16)
    np.testing.assert_allclose(out.float().numpy(), kern, **BF16)


@pytest.mark.parametrize("b,blocks,causal", [
    (1, 1, True), (2, 2, False), (3, 3, True), (4, 5, False), (2, 4, True), (1, 5, True),
])
def test_attention_ragged_sizes(b, blocks, causal):
    """tests/test_kernels.py:184-194: S = T = 17·n + 3, never a block multiple."""
    s = 17 * blocks + 3
    q, k, v = _qkv(b, s, s, 4, 2, 32, seed=b * blocks)
    kern, oracle = _both(q, k, v, causal, 32)
    out = ops.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal).numpy()
    np.testing.assert_allclose(out, kern, **F32)
    np.testing.assert_allclose(out, oracle, **F32)


def test_attention_causal_more_queries_than_keys():
    """Causal with S > T: the first S - T query rows see no key, so every
    logit of theirs is -1e30 and the softmax gives each the mean of v over T,
    as the reference's oracle does."""
    q, k, v = _qkv(1, 40, 20, 4, 2, 32, seed=7)
    oracle = np.asarray(fr.sdpa_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
    out = ops.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True).numpy()
    np.testing.assert_allclose(out, oracle, **F32)
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=2)  # head h reads KV head h // 2
    np.testing.assert_allclose(out[:, :20], np.broadcast_to(mean_v, (1, 20, 4, 32)), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_sdpa_matches_reference(causal):
    """tests/test_kernels.py:171-180, both masks: q_block 32, kv_block 48."""
    q, k, v = _qkv(2, 100, 100, 8, 4, 32, seed=3)
    expect = np.asarray(fr.blockwise_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, q_block=32, kv_block=48))
    out = ref.blockwise_sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal, q_block=32, kv_block=48)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), ref.sdpa_ref(*(torch.tensor(a) for a in (q, k, v)), causal=causal).numpy(),
                               rtol=1e-5, atol=2e-6)


def test_cpu_path_launches_nothing():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 16, 16, 2, 2, 16, seed=0))
    before = ops.flash_attention.launches
    ops.attention(q, k, v, causal=True)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["hd", "dtype", "mixed_dtype", "non_contiguous", "device", "groups", "shape"])
def test_wrapper_refuses(bad):
    q, k, v = (torch.tensor(a) for a in _qkv(1, 8, 8, 4, 2, 16, seed=1))
    err = ValueError
    if bad == "hd":  # wider than the widest kernel (narrower ones run zero-padded)
        q, k, v = (torch.zeros(*t.shape[:3], 160) for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
        err = TypeError
    elif bad == "mixed_dtype":
        k = k.to(torch.bfloat16)
        err = TypeError
    elif bad == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif bad == "groups":
        k, v = (torch.zeros(1, 8, 3, 16) for _ in range(2))
    else:
        v = torch.zeros(1, 9, 2, 16)
    with pytest.raises(err):
        ops.attention(q, k, v, causal=False)


# Head dims outside the kernel's set: DiT-XL/2 (1152 / 16 = 72, bidirectional)
# and the command-r smoke config (hd 8, causal GQA).
PADDED_CASES = {  # hd: (causal, n_heads, n_kv_heads, kernel width)
    8: (True, 4, 2, 16),
    72: (False, 2, 2, 128),
}


@pytest.mark.parametrize("hd", sorted(PADDED_CASES))
def test_attention_pads_head_dims_outside_the_kernel_set(hd, monkeypatch):
    """``layers.attention`` at a head dim the kernel is not built for runs
    the flash op zero-padded to the next kernel width (the plain version on
    the CPU sees the padded width) with the caller's ``1/sqrt(hd)``, and
    equals the reference's ``_sdpa`` forward within the f32 tolerance."""
    causal, H, KH, width = PADDED_CASES[hd]
    assert ops.padded_head_dim(hd) == width
    kw = dict(d_model=32, n_heads=H, n_kv_heads=KH, head_dim=hd, causal=causal, rope=False, bias=True)
    rng = np.random.default_rng(hd)
    specs = JL.attention_specs(JL.AttnCfg(**kw))
    p = {name: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32) for name, s in specs.items()}
    x = rng.standard_normal((2, 13, 32)).astype(np.float32)
    y_j, _ = JL.attention(JL.AttnCfg(**kw), {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    widths = []
    real = ref.sdpa_ref
    monkeypatch.setattr(ref, "sdpa_ref", lambda q, *a, **kw_: (widths.append(q.shape[-1]), real(q, *a, **kw_))[1])
    with torch.no_grad():
        y, _ = L.attention(L.AttnCfg(**kw), {n: torch.tensor(a) for n, a in p.items()}, torch.tensor(x))
    assert widths == [width]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **F32)
