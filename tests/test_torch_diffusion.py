"""The port's diffusion backbones (``models/diffusion``: DiT and Flux) and
``layers.modulate`` against the reference, on the CPU, on the same weights
(``interop.from_jax``), for both SMOKE configs at small shapes (64² images:
8² latents, 16 image tokens; Flux adds 8 text tokens).

Tolerances and why:
  * ``sincos_2d``: bit-equal (the same numpy arithmetic on both sides); the
    patchify round trip: exact (a permutation);
  * ``timestep_embedding``, ``modulate``, ``_patchify`` / ``_unpatchify``:
    ``F32`` (rtol 1e-4, atol 2e-5); ``timestep_embedding`` at the models'
    t · 1000 also t · 2⁻²³ absolute (XLA's ``exp`` and torch's differ by an
    ulp in some frequencies, and the angle multiplies that ulp by t);
  * blocks, forwards and sample steps in f32: ``F32`` — both ``diffusion``
    modules run through an ``_F32`` stand-in for ``torch`` / ``jnp`` whose
    ``bfloat16`` is float32 (as ``tests/test_torch_lm.py`` does), so the
    comparison is of the algorithm, not of where bf16 rounds;
  * blocks and forwards in bf16, as they run: within ``BF16_RTOL`` = 2% of
    max|out|, the ViT, Swin and LM tests' rule, on weights whose attention
    matrices have their own fan-in (``chip_smoke.own_fan_in``);
  * parameter counts, cells, argument shapes and flash calls: exactly equal.

The weights are ``reference_params``' numpy draws, whose zero-init leaves
(adaLN, Flux's modulation, the output projections, the biases) are
N(0, 0.05): every comparison runs on non-zero modulation, where the
prediction depends on the attention.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first
from test_torch_lm import _F32  # a torch / jnp whose bfloat16 is float32

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.arch import abstract_params as jabstract
from repro.arch import input_specs as jinput_specs
from repro.models import diffusion as jdiff
from repro.models import layers as JL
from repro.models.common import param_count as jparam_count
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common, diffusion
from repro_torch.models import layers as L

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import own_fan_in  # noqa: E402

F32 = dict(rtol=1e-4, atol=2e-5)
BF16_RTOL = 0.02
MODELS = ("dit-xl2", "flux-dev")
FULL_PARAMS = {"dit-xl2": 674_966_048, "flux-dev": 11_901_647_936}
IMG = 64  # 8² latents, 16 image tokens at patch 2


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(diffusion, "torch", _F32(torch, torch.float32))
    monkeypatch.setattr(jdiff, "jnp", _F32(jnp, jnp.float32))


def _weights(name: str, seed: int, *, own: bool = False, dtype=None):
    """(reference cfg, jnp params, port cfg, port params) of the smoke
    config's numpy weights, carried across; in ``dtype`` on both sides when
    given."""
    arch_j, params_j, _ = reference_params(name, seed)
    arch = configs.get(name, smoke=True)
    if own:
        own_fan_in(params_j, arch.cfg)
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    if dtype is not None:
        params = common.tree_map(lambda t: t.to(getattr(torch, dtype)), params)
    jdt = getattr(jnp, dtype) if dtype is not None else jnp.float32
    return arch_j.cfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), params_j), arch.cfg, params


def _inputs(cfg, seed: int, batch: int = 2, img: int = IMG) -> dict[str, np.ndarray]:
    """A denoise step's inputs, drawn with numpy (``make_inputs``' rules)."""
    rng = np.random.default_rng(seed)
    lat = img // 8
    out = {
        "x": rng.standard_normal((batch, lat, lat, cfg.in_ch)).astype(np.float32),
        "t": rng.uniform(0.02, 0.98, batch).astype(np.float32),
        "dt": np.full(batch, 0.02, np.float32),
    }
    if isinstance(cfg, (diffusion.DiTConfig, jdiff.DiTConfig)):
        out["y"] = rng.integers(0, cfg.n_classes, batch).astype(np.int32)
    else:
        out["txt"] = rng.standard_normal((batch, cfg.txt_len, cfg.txt_dim)).astype(np.float32)
        out["vec"] = rng.standard_normal((batch, cfg.vec_dim)).astype(np.float32)
        out["guidance"] = np.full(batch, 4.0, np.float32)
    return out


def _j(a, dtype=None):
    return jnp.asarray(a, dtype)


def _t(a, dtype=None):
    t = torch.tensor(a)
    return t.to(getattr(torch, dtype)) if dtype is not None and t.is_floating_point() else t


def _close(got: torch.Tensor, want, dtype=None):
    """F32 in f32; within BF16_RTOL of max|want| in bf16."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype != "bfloat16":
        np.testing.assert_allclose(got, want, **F32)
        return
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert scale > 0 and err <= BF16_RTOL * scale, (err, scale)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_max", [1.0, 1000.0])
@pytest.mark.parametrize("dim,max_period", [(256, 10000.0), (32, 100.0)])
def test_timestep_embedding_matches_reference(dim, max_period, t_max):
    """``F32``, plus ``t_max`` · 2⁻²³ absolute at the models' t · 1000: XLA's
    ``exp`` and torch's differ by an ulp in some frequencies (≤ 1), and an
    angle t · freq carries that ulp times t into cos and sin."""
    t = np.random.default_rng(dim).uniform(0, t_max, 5).astype(np.float32)
    want = np.asarray(jdiff.timestep_embedding(jnp.asarray(t), dim, max_period))
    got = diffusion.timestep_embedding(torch.tensor(t), dim, max_period)
    assert got.dtype == torch.float32 and got.shape == (5, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32["rtol"], atol=F32["atol"] + t_max * 2.0**-23)


@pytest.mark.parametrize("d,h,w", [(64, 4, 4), (1152, 32, 32), (3072, 8, 16)])
def test_sincos_2d_bit_equal(d, h, w):
    got, want = diffusion.sincos_2d(d, h, w), jdiff.sincos_2d(d, h, w)
    assert got.dtype == np.float32 and got.shape == (h * w, d)
    np.testing.assert_array_equal(got, want)


def test_pos_embed_made_once_per_key():
    a = diffusion._pos_embed(64, 4, 4, CPU)
    assert diffusion._pos_embed(64, 4, 4, CPU) is a
    assert a.shape == (1, 16, 64) and a.dtype == torch.float32
    np.testing.assert_array_equal(a[0].numpy(), diffusion.sincos_2d(64, 4, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modulate_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x, sh, sc = rng.standard_normal((2, 5, 16)), rng.standard_normal((2, 16)), rng.standard_normal((2, 16))
    want = JL.modulate(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (x, sh, sc)))
    got = L.modulate(*(torch.tensor(a).to(getattr(torch, dtype)) for a in (x, sh, sc)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **F32)


@pytest.mark.parametrize("p,hw,c", [(2, (8, 8), 4), (2, (4, 6), 16), (4, (8, 12), 3)])
def test_patchify_matches_reference_and_round_trips(p, hw, c):
    x = np.random.default_rng(p + c).standard_normal((2, *hw, c)).astype(np.float32)
    got = diffusion._patchify(torch.tensor(x), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdiff._patchify(jnp.asarray(x), p)), **F32)
    back = diffusion._unpatchify(got, p, hw[0] // p, hw[1] // p, c)
    np.testing.assert_array_equal(back.numpy(), x)
    want = np.asarray(jdiff._unpatchify(jnp.asarray(got.numpy()), p, hw[0] // p, hw[1] // p, c))
    np.testing.assert_allclose(back.numpy(), want, **F32)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _layer(tree_j, tree, i: int = 0):
    return jax.tree.map(lambda a: a[i], tree_j), common.unstack_tree(tree)[i]


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_dit_block_matches_reference(f32_mode, dtype):
    cfg_j, pj, cfg, pt = _weights("dit-xl2", 21, own=True, dtype=dtype)
    bj, bt = _layer(pj["blocks"], pt["blocks"], 1)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    cond = (0.5 * rng.standard_normal((2, cfg.d_model))).astype(np.float32)
    want = jdiff._dit_block(cfg_j, bj, _j(x, dtype), _j(cond, dtype))
    got = diffusion._dit_block(cfg, bt, _t(x, dtype), _t(cond, dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_double_block_matches_reference(f32_mode, dtype):
    cfg_j, pj, cfg, pt = _weights("flux-dev", 23, own=True, dtype=dtype)
    bj, bt = _layer(pj["double"], pt["double"], 1)
    rng = np.random.default_rng(24)
    img = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    txt = rng.standard_normal((2, cfg.txt_len, cfg.d_model)).astype(np.float32)
    vec = (0.5 * rng.standard_normal((2, cfg.d_model))).astype(np.float32)
    wi, wt = jdiff._double_block(cfg_j, bj, _j(img, dtype), _j(txt, dtype), _j(vec, dtype))
    gi, gt = diffusion._double_block(cfg, bt, _t(img, dtype), _t(txt, dtype), _t(vec, dtype))
    _close(gi, wi, dtype)
    _close(gt, wt, dtype)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_single_block_matches_reference(f32_mode, dtype):
    cfg_j, pj, cfg, pt = _weights("flux-dev", 25, own=True, dtype=dtype)
    bj, bt = _layer(pj["single"], pt["single"], 0)
    rng = np.random.default_rng(26)
    x = rng.standard_normal((2, cfg.txt_len + 16, cfg.d_model)).astype(np.float32)
    vec = (0.5 * rng.standard_normal((2, cfg.d_model))).astype(np.float32)
    want = jdiff._single_block(cfg_j, bj, _j(x, dtype), _j(vec, dtype))
    got = diffusion._single_block(cfg, bt, _t(x, dtype), _t(vec, dtype))
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# Forwards and sample steps
# ---------------------------------------------------------------------------


def _dit_args(inp, convert):
    return convert(inp["x"]), convert(inp["t"] * 1000.0), convert(inp["y"])


def test_dit_forward_matches_reference_f32(f32_mode):
    cfg_j, pj, cfg, pt = _weights("dit-xl2", 31)
    inp = _inputs(cfg, 32)
    want = jdiff.dit_forward(cfg_j, pj, *_dit_args(inp, jnp.asarray))
    with torch.no_grad():
        got = diffusion.dit_forward(cfg, pt, *_dit_args(inp, torch.tensor))
    assert got.shape == (2, 8, 8, 2 * cfg.in_ch) and got.dtype == torch.float32
    assert float(got.abs().max()) > 0.1  # non-zero modulation: the prediction is not 0
    _close(got, want)


@pytest.mark.parametrize("guidance", ["given", "none", "off"])
def test_flux_forward_matches_reference_f32(f32_mode, guidance):
    """With a guidance scale, with ``guidance=None``, and with a config
    built without the guidance embedding (``FluxConfig(guidance=False)``)."""
    cfg_j, pj, cfg, pt = _weights("flux-dev", 33)
    if guidance == "off":
        cfg_j, cfg = dataclasses.replace(cfg_j, guidance=False), dataclasses.replace(cfg, guidance=False)
    inp = _inputs(cfg, 34)
    g = None if guidance == "none" else inp["guidance"]
    want = jdiff.flux_forward(cfg_j, pj, *(jnp.asarray(inp[k]) for k in ("x", "txt", "vec", "t")),
                              None if g is None else jnp.asarray(g))
    with torch.no_grad():
        got = diffusion.flux_forward(cfg, pt, *(torch.tensor(inp[k]) for k in ("x", "txt", "vec", "t")),
                                     None if g is None else torch.tensor(g))
    assert got.shape == (2, 8, 8, cfg.in_ch) and got.dtype == torch.float32
    _close(got, want)
    if guidance == "given":  # the guidance embedding moves the prediction
        with torch.no_grad():
            unguided = diffusion.flux_forward(cfg, pt, *(torch.tensor(inp[k]) for k in ("x", "txt", "vec", "t")))
        assert float((unguided - got).abs().max()) > 1e-3


@pytest.mark.parametrize("name", MODELS)
def test_bf16_forward_matches_reference(name):
    cfg_j, pj, cfg, pt = _weights(name, 35, own=True, dtype="bfloat16")
    inp = _inputs(cfg, 36, batch=3)
    if name == "dit-xl2":
        want = jax.jit(lambda p, *a: jdiff.dit_forward(cfg_j, p, *a))(pj, *_dit_args(inp, jnp.asarray))
        with torch.no_grad():
            got = diffusion.dit_forward(cfg, pt, *_dit_args(inp, torch.tensor))
    else:
        keys = ("x", "txt", "vec", "t", "guidance")
        want = jax.jit(lambda p, *a: jdiff.flux_forward(cfg_j, p, *a))(pj, *(jnp.asarray(inp[k]) for k in keys))
        with torch.no_grad():
            got = diffusion.flux_forward(cfg, pt, *(torch.tensor(inp[k]) for k in keys))
    assert got.dtype == torch.float32
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("name", MODELS)
def test_sample_step_matches_reference_f32(f32_mode, name):
    cfg_j, pj, cfg, pt = _weights(name, 37)
    inp = _inputs(cfg, 38)
    if name == "dit-xl2":
        keys, fj, ft = ("x", "t", "dt", "y"), jdiff.dit_sample_step, diffusion.dit_sample_step
    else:
        keys = ("x", "txt", "vec", "t", "dt", "guidance")
        fj, ft = jdiff.flux_sample_step, diffusion.flux_sample_step
    want = fj(cfg_j, pj, *(jnp.asarray(inp[k]) for k in keys))
    got = ft(cfg, pt, *(torch.tensor(inp[k]) for k in keys))
    assert not got.requires_grad
    _close(got, want)
    assert float((got - torch.tensor(inp["x"])).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# The flash kernel's call sites
# ---------------------------------------------------------------------------


def _forward(name, cfg, params, inp):
    if name == "dit-xl2":
        return diffusion.dit_forward(cfg, params, *_dit_args(inp, torch.tensor))
    return diffusion.flux_forward(cfg, params, *(torch.tensor(inp[k]) for k in ("x", "txt", "vec", "t", "guidance")))


@pytest.mark.parametrize("name,calls", [("dit-xl2", 2), ("flux-dev", 4)])
def test_flash_op_called_once_per_attention_layer(monkeypatch, name, calls):
    """A serving forward calls ``flash_ops.attention`` once per attention
    layer, non-causal (DiT's 2 blocks; Flux's 2 double blocks, joint over
    text and image tokens, and 2 single blocks); a forward that needs
    gradients calls it never, taking the reference's ``_sdpa``, and agrees."""
    _, _, cfg, params = _weights(name, 41)
    inp = _inputs(cfg, 42)
    seen, real = [], flash_ops.attention

    def counting(q, k, v, *, causal=True, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(flash_ops, "attention", counting)
    with torch.no_grad():
        served = _forward(name, cfg, params, inp)
    S = 16 if name == "dit-xl2" else 16 + cfg.txt_len
    hd = cfg.d_model // cfg.n_heads
    assert seen == [((2, S, cfg.n_heads, hd), (2, S, cfg.n_heads, hd), False)] * calls
    seen.clear()
    grads = common.tree_map(lambda t: t.clone().requires_grad_(True), params)
    trained = _forward(name, cfg, grads, inp)
    assert seen == [] and trained.requires_grad
    torch.testing.assert_close(trained.detach(), served, **F32)


# ---------------------------------------------------------------------------
# Params, configs, inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_full_config_sized_without_allocation(name):
    arch, arch_j = configs.get(name), jconfigs.get(name)
    specs, state = A.abstract_params(arch)
    specs_j, _ = jabstract(arch_j)
    assert state == {}
    assert A.n_params(arch) == common.param_count(specs) == jparam_count(specs_j) == FULL_PARAMS[name]
    meta = common.abstract_tree(specs)
    leaves = common.tree_leaves(meta)
    leaves_j = jax.tree.leaves(jax.tree.map(lambda s: s.shape, specs_j, is_leaf=lambda x: hasattr(x, "axes")),
                               is_leaf=lambda x: isinstance(x, tuple))
    assert all(t.device.type == "meta" for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [tuple(s) for s in leaves_j]
    assert dataclasses.asdict(arch.cfg) == dataclasses.asdict(arch_j.cfg)
    assert (arch.name, arch.family, arch.notes, arch.sharding_overrides) == (
        arch_j.name, arch_j.family, arch_j.notes, arch_j.sharding_overrides)
    assert [dataclasses.asdict(s) for s in arch.shapes] == [dataclasses.asdict(s) for s in arch_j.shapes]
    smoke, smoke_j = configs.get(name, smoke=True), jconfigs.get(name, smoke=True)
    assert dataclasses.asdict(smoke.cfg) == dataclasses.asdict(smoke_j.cfg) and smoke.name == smoke_j.name


def test_registry_and_cells_match_reference():
    assert configs.ALL == jconfigs.ALL and configs.ASSIGNED == jconfigs.ASSIGNED
    cells = configs.cells()
    assert len(cells) == 40 and cells == jconfigs.cells()
    for name, shape in cells:
        assert configs.get(name).shape(shape).name == shape


@pytest.mark.parametrize("name", MODELS)
def test_from_jax_carries_diffusion_weights(name):
    arch_j, params_j, _ = reference_params(name, 43)
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
    bad = dict(params_j, final={k: v for k, v in params_j["final"].items() if k != "proj"})
    with pytest.raises(ValueError):
        interop.from_jax(arch, bad, {}, device=CPU)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("kind", ["denoise_step", "denoise_train"])
def test_input_specs_and_make_inputs(monkeypatch, name, kind):
    arch, arch_j = configs.get(name, smoke=True), jconfigs.get(name, smoke=True)
    shape = A.ShapeSpec("s", kind, 3, img=IMG)
    specs, specs_j = A.input_specs(arch, shape), jinput_specs(arch_j, shape)
    assert {k: (s.shape, s.axes, str(s.dtype).removeprefix("torch.")) for k, s in specs.items()} == {
        k: (s.shape, s.axes, str(np.dtype(s.dtype))) for k, s in specs_j.items()}
    x = A.make_inputs(arch, shape, 4, device=CPU)
    assert sorted(x) == sorted(specs)
    assert 0.02 <= float(x["t"].min()) and float(x["t"].max()) <= 0.98 and x["t"].dtype == torch.float32
    if kind == "denoise_step":
        assert bool((x["dt"] == 0.02).all())
    else:
        assert "dt" not in x and x["noise"].shape == x["x"].shape
    if name == "dit-xl2":
        assert x["y"].dtype == torch.int32 and 0 <= int(x["y"].min()) and int(x["y"].max()) < arch.cfg.n_classes
    else:
        assert bool((x["guidance"] == 4.0).all()) and x["txt"].shape == (3, arch.cfg.txt_len, arch.cfg.txt_dim)
    assert abs(float(x["x"].std()) - 1.0) < 0.25
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        A.make_inputs(arch, shape, 4)  # the card by default, and no fallback
