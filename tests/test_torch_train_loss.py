"""The port's training losses (``lm.train_loss``, ``diffusion.dit_train_loss``
and ``flux_train_loss``) and their gradients against the reference's, on the
CPU, on the same weights (``interop.from_jax``), for the smoke configs.

Tolerances and why:
  * the loss and every gradient leaf (``torch.autograd.grad`` against
    ``jax.grad``) in f32: within ``GRAD_RTOL`` = 1e-4 of the leaf's
    max|grad|, plus ``GRAD_ATOL`` = 1e-7 for leaves whose exact gradient is
    zero (an attention key bias: softmax is invariant to it), which read f32
    noise of ~1e-8 on both sides (the loss: rtol 1e-5).  The leaves under
    ``t_embed`` and ``g_embed`` take ``EMBED_RTOL`` = 5e-4: they read
    ``timestep_embedding`` at t · 1000 (guidance · 1000 = 4000), whose angles
    carry XLA's and torch's one-ulp difference in ``exp`` times that factor
    (``tests/test_torch_diffusion.py``), 1.2e-4 of max|grad| at most here;  Both ``lm`` (or both ``diffusion``)
    modules run through the ``_F32`` stand-in of ``tests/test_torch_lm.py``,
    whose ``bfloat16`` is float32, so the comparison is of the algorithm, not
    of where bf16 rounds; what is left is f32 summed in another order;
  * remat on against remat off, in the port: bitwise equal gradients (the
    checkpointed block runs the same operations again);
  * under autograd the flash wrapper is never called: it is patched to raise;
  * the blockwise attention that a differentiated attention takes above
    ``BLOCKWISE_THRESHOLD`` (Flux's train_1024, 4352 tokens): its q, k and v
    gradients against ``jax.grad`` of the reference's ``blockwise_sdpa`` on
    ragged blocks, within ``GRAD_RTOL`` of each one's max|grad| plus
    ``GRAD_ATOL``; and a causal LM and Flux trained through it (the
    threshold lowered in both packages, small blocks), their loss and
    gradients as above.

The weights are ``reference_params``' numpy draws, whose zero-init leaves
are N(0, 0.05), so every gradient leaf is non-zero.
"""
from __future__ import annotations

import dataclasses
import functools

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first
from test_torch_lm import _F32  # a torch / jnp whose bfloat16 is float32

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models import diffusion as jdiff
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common, diffusion, layers, lm

GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
EMBED_RTOL = 5e-4
LOSS_RTOL = 1e-5
LMS = ("qwen3-0.6b", "command-r-35b", "qwen2-moe-a2.7b", "deepseek-moe-16b")


@pytest.fixture
def f32_mode(monkeypatch):
    for mod, jmod in ((lm, jlm), (diffusion, jdiff)):
        monkeypatch.setattr(mod, "torch", _F32(torch, torch.float32))
        monkeypatch.setattr(jmod, "jnp", _F32(jnp, jnp.float32))


@pytest.fixture
def no_flash(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the flash wrapper was called under autograd")

    monkeypatch.setattr(flash_ops, "attention", refuse)


def _weights(name: str, seed: int):
    """(reference cfg, jnp params, port cfg, port params): the smoke config's
    numpy weights carried across."""
    arch_j, params_j, _ = reference_params(name, seed)
    arch = configs.get(name, smoke=True)
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    return arch_j.cfg, jax.tree.map(jnp.asarray, params_j), arch.cfg, params


def _grads(loss_fn, params):
    """(loss, metrics, gradient leaves) of ``loss_fn(params)`` in the port."""
    alias = common.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(alias)
    leaves = common.tree_leaves(alias)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics, grads


def _check(loss_j, grads_j, loss, grads):
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(want) == len(grads)
    for g, (path, w) in zip(grads, want):
        name, w = jax.tree_util.keystr(path), np.asarray(w, np.float32)
        assert g.shape == w.shape
        rtol = EMBED_RTOL if "t_embed" in name or "g_embed" in name else GRAD_RTOL
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= rtol * scale + GRAD_ATOL, (name, err, scale)


def _lm_batch(cfg, seed: int, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    labels[1, -1] = -1
    return tokens, labels


@pytest.mark.parametrize("name", LMS)
def test_lm_train_loss_and_grads_match_reference(name, f32_mode, no_flash):
    cfg_j, pj, cfg, params = _weights(name, 0)
    tokens, labels = _lm_batch(cfg, 1)
    (loss_j, m_j), grads_j = jax.value_and_grad(
        lambda p: jlm.train_loss(cfg_j, p, jnp.asarray(tokens), jnp.asarray(labels)), has_aux=True)(pj)
    loss, m, grads = _grads(lambda p: lm.train_loss(cfg, p, torch.tensor(tokens), torch.tensor(labels)), params)
    _check(loss_j, grads_j, loss, grads)
    np.testing.assert_allclose(float(m["ce"].detach()), float(m_j["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["aux"].detach()), float(m_j["aux"]), rtol=LOSS_RTOL, atol=1e-9)
    assert (float(m["aux"].detach()) > 0) == (cfg.moe is not None)


def _dit_batch(cfg, seed: int, batch: int = 2, img: int = 64):
    rng = np.random.default_rng(seed)
    lat = img // 8
    return {
        "x": rng.standard_normal((batch, lat, lat, cfg.in_ch)).astype(np.float32),
        "t": rng.uniform(0.02, 0.98, batch).astype(np.float32),
        "y": rng.integers(0, cfg.n_classes, batch).astype(np.int32),
        "noise": rng.standard_normal((batch, lat, lat, cfg.in_ch)).astype(np.float32),
    }


def _flux_batch(cfg, seed: int, batch: int = 2):
    rng = np.random.default_rng(seed)
    lat = cfg.latent_res
    return {
        "x": rng.standard_normal((batch, lat, lat, cfg.in_ch)).astype(np.float32),
        "txt": rng.standard_normal((batch, cfg.txt_len, cfg.txt_dim)).astype(np.float32),
        "vec": rng.standard_normal((batch, cfg.vec_dim)).astype(np.float32),
        "t": rng.uniform(0.02, 0.98, batch).astype(np.float32),
        "noise": rng.standard_normal((batch, lat, lat, cfg.in_ch)).astype(np.float32),
    }


def _dit_loss(mod, cfg, b, conv):
    return lambda p: mod.dit_train_loss(cfg, p, conv(b["x"]), conv(b["t"]), conv(b["y"]), conv(b["noise"]))


def _flux_loss(mod, cfg, b, conv):
    return lambda p: mod.flux_train_loss(cfg, p, conv(b["x"]), conv(b["txt"]), conv(b["vec"]), conv(b["t"]),
                                         conv(b["noise"]))


def test_dit_train_loss_and_grads_match_reference(f32_mode, no_flash):
    cfg_j, pj, cfg, params = _weights("dit-xl2", 0)
    b = _dit_batch(cfg, 2)
    (loss_j, _), grads_j = jax.value_and_grad(_dit_loss(jdiff, cfg_j, b, jnp.asarray), has_aux=True)(pj)
    loss, m, grads = _grads(_dit_loss(diffusion, cfg, b, torch.tensor), params)
    assert m == {}
    _check(loss_j, grads_j, loss, grads)


@pytest.mark.parametrize("guidance", [True, False])
def test_flux_train_loss_and_grads_match_reference(guidance, f32_mode, no_flash):
    cfg_j, pj, cfg, params = _weights("flux-dev", 0)
    cfg_j, cfg = dataclasses.replace(cfg_j, guidance=guidance), dataclasses.replace(cfg, guidance=guidance)
    b = _flux_batch(cfg, 3)
    (loss_j, _), grads_j = jax.value_and_grad(_flux_loss(jdiff, cfg_j, b, jnp.asarray), has_aux=True)(pj)
    loss, m, grads = _grads(_flux_loss(diffusion, cfg, b, torch.tensor), params)
    assert m == {}
    _check(loss_j, grads_j, loss, grads)
    g_embed = float(sum(g.abs().sum() for g in common.tree_leaves(_unflatten(params, grads)["g_embed"])))
    assert (g_embed > 0) == guidance  # without guidance g_embed takes no gradient (zeros, as jax.grad)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return common.tree_map(lambda _: next(it), tree)


def _remat_case(name: str):
    """(cfg, params, loss builder) of one model at the smoke size, bf16 as it runs."""
    arch = configs.get(name, smoke=True)
    params = common.init_tree(torch.Generator().manual_seed(0), A.abstract_params(arch)[0], device=CPU)
    if arch.family == "lm":
        tokens, labels = _lm_batch(arch.cfg, 4)
        return arch.cfg, params, lambda c: lambda p: lm.train_loss(c, p, torch.tensor(tokens), torch.tensor(labels))
    if arch.family == "dit":
        b = _dit_batch(arch.cfg, 5)
        return arch.cfg, params, lambda c: _dit_loss(diffusion, c, b, torch.tensor)
    b = _flux_batch(arch.cfg, 6)
    return arch.cfg, params, lambda c: _flux_loss(diffusion, c, b, torch.tensor)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "deepseek-moe-16b", "dit-xl2", "flux-dev"])
def test_remat_gives_bitwise_equal_gradients(name, no_flash, monkeypatch):
    cfg, params, loss_of = _remat_case(name)
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return checkpoint(*args, **kw)

    monkeypatch.setattr(common, "checkpoint", counted)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = _grads(loss_of(c), params)
        out[remat] = (loss, grads)
    blocks = cfg.n_double + cfg.n_single if hasattr(cfg, "n_double") else cfg.n_layers
    assert len(calls) == blocks  # every block checkpointed under remat, none without
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_sdpa_grads_match_reference(causal):
    """GQA (8 query heads on 4 KV heads), S = T = 100 over query blocks of 32
    and key blocks of 48, so the last of each is padded and masked."""
    rng = np.random.default_rng(20 + causal)
    q = rng.standard_normal((2, 100, 8, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 100, 4, 32)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal(q.shape).astype(np.float32)
    blocks = {"causal": causal, "q_block": 32, "kv_block": 48}
    want = jax.grad(lambda *a: jnp.sum(jlayers.blockwise_sdpa(*a, **blocks) * cot), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    qkv = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = torch.autograd.grad((layers.blockwise_sdpa(*qkv, **blocks) * torch.tensor(cot)).sum(), qkv)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL


@pytest.mark.parametrize("name", ["qwen3-0.6b", "flux-dev"])
def test_training_through_blockwise_matches_reference(name, f32_mode, no_flash, monkeypatch):
    """Both packages' threshold at 8 tokens (the LM's 12, Flux's 8 text + 16
    image tokens), blocks of 5 queries by 8 keys; the port's blockwise
    attention counted, so that the path is known to be taken."""
    calls = []

    def counted(q, k, v, *, causal):
        calls.append(causal)
        return real(q, k, v, causal=causal, q_block=5, kv_block=8)

    real = layers.blockwise_sdpa
    monkeypatch.setattr(layers, "blockwise_sdpa", counted)
    monkeypatch.setattr(jlayers, "blockwise_sdpa", functools.partial(jlayers.blockwise_sdpa, q_block=5, kv_block=8))
    for mod in (layers, jlayers):
        monkeypatch.setattr(mod, "BLOCKWISE_THRESHOLD", 8)
    cfg_j, pj, cfg, params = _weights(name, 0)
    if name == "flux-dev":
        b = _flux_batch(cfg, 3)
        loss_j_fn, loss_fn = _flux_loss(jdiff, cfg_j, b, jnp.asarray), _flux_loss(diffusion, cfg, b, torch.tensor)
        layers_hit = cfg.n_double + cfg.n_single
    else:
        tokens, labels = _lm_batch(cfg, 1)
        loss_j_fn = lambda p: jlm.train_loss(cfg_j, p, jnp.asarray(tokens), jnp.asarray(labels))  # noqa: E731
        loss_fn = lambda p: lm.train_loss(cfg, p, torch.tensor(tokens), torch.tensor(labels))  # noqa: E731
        layers_hit = cfg.n_layers
    (loss_j, _), grads_j = jax.value_and_grad(loss_j_fn, has_aux=True)(pj)
    loss, _, grads = _grads(loss_fn, params)
    assert calls == [name != "flux-dev"] * layers_hit  # causal for the LM
    _check(loss_j, grads_j, loss, grads)
