"""Diffusion backbones: DiT (adaLN-Zero) and Flux-style MMDiT (double-stream
joint attention + single-stream blocks, rectified flow).

Both operate on VAE latents (the reference's stub frontend: the inputs are
latents).  One call = ONE denoising step; samplers loop around it.

  dit_forward(cfg, params, x_t, t, y)                 -> prediction (noise, 2C ch)
  flux_forward(cfg, params, img, txt, vec, t, g)      -> velocity prediction
  dit_train_loss / flux_train_loss                    the training objectives
  dit_sample_step / flux_sample_step                  one step, under no_grad

Parameters keep the reference's keys and stacked ``[L]`` block layout, so
``interop.from_jax`` carries them across; each forward loops over the
stacked blocks (``common.unstack_tree``) where the reference scans.  Every
attention goes through ``layers._attend``, so on the card each attention
layer of a sampling step launches the flash kernel (non-causal): DiT's
blocks through ``layers.attention``, and Flux's joint and single-stream
attention, where the reference calls ``_sdpa`` / ``blockwise_sdpa``
directly (the kernel is the reference's kernel for that math).  A forward
that builds an autograd graph takes the reference's differentiable
branches instead, and with ``cfg.remat`` checkpoints each block (DiT's,
Flux's double and single alike) as the reference's ``jax.checkpoint``
does.

Under mesh rules (``launch/steps.build_cell(..., rules=)``, a sampling step
over ``torch.distributed`` ranks) the arguments are DTensors and each rank
computes on its local shards, as the reference's GSPMD partitions the
step: the batch on ``data``; attention on the rank's heads and the MLPs
column- then row-parallel on ``model`` (``models/layers``); the adaLN
modulation ``[B, n·d]``, whose columns split over ``mlp``, gathered whole
before it is chunked (``_mod``: a gather of a few kB a row, where giving
each rank the chunks it owns would split every chunk across ranks).
DiT's residual is whole on ``model``; Flux's image residual, and the joint
sequence of its single blocks, split over the sequence (``act_seq``) at
the reference's ``shard`` points: gathered once a sublayer before the
attention or MLP reads it, the row-parallel partials summed and cut back
to the rank's rows (one sum for a single block's attention and MLP
together).  Flux's text stream stays whole on ``model``.  The reference's
``_pin_replicated`` only steers its partitioner; here each rank attends
over its own heads.  On one card every ``shard`` is the identity.  A
training step over ranks (``train_rules``) runs the same code under
autograd: the weights' ``embed`` dims gathered (``common.used_on``), the
losses the global batch's means (``common.batch_mean``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from ..sharding.rules import all_gather, grad_sum
from . import layers as L
from .common import (batch_mean, checkpointed, like, local, local_slice, mesh_of, rows_like, shard, spec, stack_specs,
                     unstack_tree, used_on, weights)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """t: [B] float in [0, 1] or integer steps -> [B, dim] sinusoidal."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def sincos_2d(d: int, h: int, w: int) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding [h*w, d] (DiT uses this)."""

    def one(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2) / (dim // 2))
        out = pos[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh, gw = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.concatenate([one(d // 2, gh.reshape(-1)), one(d // 2, gw.reshape(-1))], axis=1).astype(
        np.float32
    )


@functools.lru_cache(maxsize=16)
def _pos_embed(d: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """``sincos_2d`` as a [1, h*w, d] f32 tensor on ``device``, made once per
    key so that a denoising step copies nothing from the host."""
    return torch.from_numpy(sincos_2d(d, h, w)).to(device)[None]


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str
    img_res: int = 256  # pixel space; latent = img_res // 8
    patch: int = 2
    n_layers: int = 28
    d_model: int = 1152
    n_heads: int = 16
    in_ch: int = 4
    n_classes: int = 1000
    mlp_ratio: int = 4
    remat: bool = False  # checkpoint each block while an autograd graph is built

    @property
    def latent(self) -> int:
        return self.img_res // 8

    @property
    def tokens(self) -> int:
        return (self.latent // self.patch) ** 2

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_heads,
            head_dim=self.d_model // self.n_heads,
            causal=False,
            rope=False,
            bias=True,
        )


def _dit_block_specs(c: DiTConfig) -> dict:
    d = c.d_model
    return {
        "ln1": L.layernorm_specs(d),
        "attn": L.attention_specs(c.attn_cfg()),
        "ln2": L.layernorm_specs(d),
        "mlp": L.mlp_specs(d, d * c.mlp_ratio),
        "adaln": {
            "w": spec((d, 6 * d), ("embed", "mlp"), init="zeros"),
            "b": spec((6 * d,), ("mlp",), init="zeros"),
        },
    }


def dit_abstract_params(c: DiTConfig) -> dict:
    d = c.d_model
    pdim = c.patch * c.patch * c.in_ch
    return {
        "x_embed": {"w": spec((pdim, d), (None, "embed")), "b": spec((d,), ("embed",), init="zeros")},
        "t_embed": L.mlp_specs(256, d, out_dim=d),
        "y_embed": spec((c.n_classes + 1, d), (None, "embed"), init="embed", scale=0.02),
        "blocks": stack_specs(_dit_block_specs(c), c.n_layers),
        "final": {
            "ln": L.layernorm_specs(d),
            "adaln": {
                "w": spec((d, 2 * d), ("embed", "mlp"), init="zeros"),
                "b": spec((2 * d,), ("mlp",), init="zeros"),
            },
            "proj": {
                "w": spec((d, c.patch * c.patch * 2 * c.in_ch), ("embed", None), init="zeros"),
                "b": spec((c.patch * c.patch * 2 * c.in_ch,), (None,), init="zeros"),
            },
        },
    }


def _patchify(x, p):
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def _unpatchify(x, p, h, w, c_out):
    B = x.shape[0]
    x = x.reshape(B, h, w, p, p, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * p, w * p, c_out)


def _res(x, g, y):
    """The gated residual ``x + g·y`` (g [B, D] a row), laid out as ``x``."""
    return like(x, local(x) + used_on(g, x)[:, None, :] * local(y))


def _linear(p, x):
    """``x @ w + b`` on the local rows of ``x``, its input dim whole (the
    weights as ``common.used_on`` gives them)."""
    xl, lp = local(x), weights(p, x)
    return xl @ lp["w"].to(xl.dtype) + lp["b"].to(xl.dtype)


def _mod(p, cond, n):
    """The adaLN modulation ``cond @ w + b`` in ``n`` chunks of [B, D].  Over
    ranks ``w``'s columns split over ``mlp``: each rank makes its columns
    and they are gathered whole before the chunks are cut, as the chunks'
    boundaries do not fall on the ranks'."""
    mesh, axes = mesh_of(p["w"]), local_slice(p["w"], 1)[1]
    m = _linear(p, grad_sum(cond, mesh, axes))
    return torch.chunk(all_gather(m, -1, mesh, axes), n, dim=-1)


def _dit_block(c: DiTConfig, p, x, cond):
    sh1, sc1, g1, sh2, sc2, g2 = _mod(p["adaln"], cond, 6)
    h = L.modulate(L.layernorm(p["ln1"], x), sh1, sc1)
    a, _ = L.attention(c.attn_cfg(), p["attn"], h)
    x = shard(_res(x, g1, a), "batch", None, None)
    h = L.modulate(L.layernorm(p["ln2"], x), sh2, sc2)
    f = L.mlp(p["mlp"], h)
    return shard(_res(x, g2, f), "batch", None, None)


def dit_forward(c: DiTConfig, params, x_t, t, y):
    """x_t: [B, L, L, C] latent; t: [B]; y: [B] int labels.
    Returns [B, L, L, 2C] f32 (noise prediction + sigma channels)."""
    _, H, W, _ = x_t.shape
    p = c.patch
    x = _linear(params["x_embed"], _patchify(local(x_t).to(torch.bfloat16), p))
    x = x + _pos_embed(c.d_model, H // p, W // p, x.device).to(x.dtype)
    x = shard(rows_like(x_t, x), "batch", None, None)

    temb = L.mlp(params["t_embed"], rows_like(t, timestep_embedding(local(t), 256).to(torch.bfloat16)), act=F.silu)
    yemb = used_on(params["y_embed"]).to(torch.bfloat16)[local(y)]
    cond = F.silu(local(temb) + yemb)

    block = checkpointed(c.remat, _dit_block)
    for blk in unstack_tree(params["blocks"]):
        x = block(c, blk, x, cond)

    fin = params["final"]
    sh, sc = _mod(fin["adaln"], cond, 2)
    x = _linear(fin["proj"], L.modulate(L.layernorm(fin["ln"], x), sh, sc))
    return rows_like(x_t, _unpatchify(x.to(torch.float32), p, H // p, W // p, 2 * c.in_ch))


def dit_train_loss(c: DiTConfig, params, x0, t, y, noise):
    """DDPM eps-prediction MSE at cosine-schedule timestep t in [0,1]; over
    ranks on the local rows, the mean the global batch's."""
    tl, nl = local(t), local(noise)
    a = torch.cos(0.5 * math.pi * tl).to(torch.float32)[:, None, None, None]
    s = torch.sin(0.5 * math.pi * tl).to(torch.float32)[:, None, None, None]
    x_t = rows_like(x0, a * local(x0) + s * nl)
    pred = dit_forward(c, params, x_t, rows_like(t, tl * 1000.0), y)
    eps = local(pred)[..., : c.in_ch]
    return batch_mean((eps - nl) ** 2, x0), {}


@torch.no_grad()
def dit_sample_step(c: DiTConfig, params, x_t, t, dt, y):
    """One DDIM-style step from t to t - dt (cosine schedule)."""
    pred = dit_forward(c, params, x_t, t * 1000.0, y)
    eps = local(pred)[..., : c.in_ch].to(torch.float32)
    xl, tl = local(x_t), local(t)
    a_t = torch.cos(0.5 * math.pi * tl)[:, None, None, None]
    s_t = torch.sin(0.5 * math.pi * tl)[:, None, None, None]
    x0 = (xl - s_t * eps) / torch.clamp(a_t, min=1e-4)
    t2 = torch.clamp(tl - local(dt), min=0.0)
    a2 = torch.cos(0.5 * math.pi * t2)[:, None, None, None]
    s2 = torch.sin(0.5 * math.pi * t2)[:, None, None, None]
    return like(x_t, a2 * x0 + s2 * eps)


# ---------------------------------------------------------------------------
# Flux-style MMDiT
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    name: str
    img_res: int = 1024
    latent_res: int = 128
    patch: int = 2
    n_double: int = 19
    n_single: int = 38
    d_model: int = 3072
    n_heads: int = 24
    in_ch: int = 16
    txt_len: int = 256
    txt_dim: int = 4096
    vec_dim: int = 768
    mlp_ratio: int = 4
    guidance: bool = True
    remat: bool = True  # checkpoint each block while an autograd graph is built

    @property
    def tokens(self) -> int:
        return (self.latent_res // self.patch) ** 2

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_heads,
            head_dim=self.d_model // self.n_heads,
            causal=False,
            rope=False,
            bias=True,
            qk_norm=True,
        )


def _mod_specs(d: int, n: int) -> dict:
    return {"w": spec((d, n * d), ("embed", "mlp"), init="zeros"), "b": spec((n * d,), ("mlp",), init="zeros")}


def _double_block_specs(c: FluxConfig) -> dict:
    d = c.d_model

    def stream():
        return {
            "mod": _mod_specs(d, 6),
            "ln1": L.layernorm_specs(d),
            "attn": L.attention_specs(c.attn_cfg()),
            "ln2": L.layernorm_specs(d),
            "mlp": L.mlp_specs(d, d * c.mlp_ratio),
        }

    return {"img": stream(), "txt": stream()}


def _single_block_specs(c: FluxConfig) -> dict:
    d = c.d_model
    h = d * c.mlp_ratio
    return {
        "mod": _mod_specs(d, 3),
        "ln": L.layernorm_specs(d),
        "attn": L.attention_specs(c.attn_cfg()),
        "mlp_in": spec((d, h), ("embed", "mlp")),
        "mlp_out": spec((h, d), ("mlp", "embed")),
    }


def flux_abstract_params(c: FluxConfig) -> dict:
    d = c.d_model
    pdim = c.patch * c.patch * c.in_ch
    return {
        "img_in": {"w": spec((pdim, d), (None, "embed")), "b": spec((d,), ("embed",), init="zeros")},
        "txt_in": {"w": spec((c.txt_dim, d), (None, "embed")), "b": spec((d,), ("embed",), init="zeros")},
        "vec_in": L.mlp_specs(c.vec_dim, d, out_dim=d),
        "t_embed": L.mlp_specs(256, d, out_dim=d),
        "g_embed": L.mlp_specs(256, d, out_dim=d),
        "double": stack_specs(_double_block_specs(c), c.n_double),
        "single": stack_specs(_single_block_specs(c), c.n_single),
        "final": {
            "ln": L.layernorm_specs(d),
            "adaln": _mod_specs(d, 2),
            "proj": {
                "w": spec((d, pdim), ("embed", None), init="zeros"),
                "b": spec((pdim,), (None,), init="zeros"),
            },
        },
    }


def _joint_attention(c: FluxConfig, p_img, p_txt, img, txt, onto=None):
    """Compute q/k/v per stream, attend jointly over [txt; img].  Over ranks
    on the rank's heads: the text output summed whole, the image output
    summed and cut to ``onto``'s rows (the image residual's)."""
    ac = c.attn_cfg()
    mesh = mesh_of(img)
    qi, ki, vi = L._heads_in(ac, p_img, img, None)  # no rope: positions unused
    qt, kt, vt = L._heads_in(ac, p_txt, txt, None)
    q = torch.cat([qt, qi], dim=1)
    k = torch.cat([kt, ki], dim=1)
    v = torch.cat([vt, vi], dim=1)
    out = L._attend(ac, q, k, v)
    T, dtype, axes = qt.shape[1], qt.dtype, local_slice(p_img["wq"], 1)[1]
    ot, oi = out[:, :T], out[:, T:]
    rows = img if onto is None else onto
    yi = L._summed(L._partial("bshk,hkd->bsd", oi, used_on(p_img["wo"], img), axes), mesh, axes, dtype, onto)
    yt = L._summed(L._partial("bshk,hkd->bsd", ot, used_on(p_txt["wo"], txt), axes), mesh, axes, dtype)
    yi = yi + used_on(p_img["bo"], rows).to(dtype)
    return like(rows, yi), like(txt, yt + used_on(p_txt["bo"], txt).to(dtype))


def _double_block(c: FluxConfig, p, img, txt, vec):
    mi = _mod(p["img"]["mod"], vec, 6)
    mt = _mod(p["txt"]["mod"], vec, 6)
    # The seq-split image residual gathered once a sublayer, before q/k/v or the MLP read it.
    hi = shard(L.modulate(L.layernorm(p["img"]["ln1"], img), mi[0], mi[1]), "batch", None, None)
    ht = L.modulate(L.layernorm(p["txt"]["ln1"], txt), mt[0], mt[1])
    ai, at = _joint_attention(c, p["img"]["attn"], p["txt"]["attn"], hi, ht, onto=img)
    img = shard(_res(img, mi[2], ai), "batch", "act_seq", None)
    txt = _res(txt, mt[2], at)
    hi2 = shard(L.modulate(L.layernorm(p["img"]["ln2"], img), mi[3], mi[4]), "batch", None, None)
    fi = L.mlp(p["img"]["mlp"], hi2, onto=img)
    ft = L.mlp(p["txt"]["mlp"], L.modulate(L.layernorm(p["txt"]["ln2"], txt), mt[3], mt[4]))
    img = shard(_res(img, mi[5], fi), "batch", "act_seq", None)
    txt = _res(txt, mt[5], ft)
    return img, txt


def _single_block(c: FluxConfig, p, x, vec):
    sh, sc, g = _mod(p["mod"], vec, 3)
    h = shard(L.modulate(L.layernorm(p["ln"], x), sh, sc), "batch", None, None)
    ac = c.attn_cfg()
    mesh, hl, pa = mesh_of(x), local(h), p["attn"]
    q, k, v = L._heads_in(ac, pa, h, None)
    o = L._attend(ac, q, k, v)
    head_axes, mlp_axes = local_slice(pa["wq"], 1)[1], local_slice(p["mlp_in"], 1)[1]
    a = L._partial("bshk,hkd->bsd", o, used_on(pa["wo"], h), head_axes)
    hidden = L._gelu(grad_sum(hl, mesh, mlp_axes) @ used_on(p["mlp_in"], h).to(hl.dtype))
    f = L._partial("...f,fd->...d", hidden, used_on(p["mlp_out"], h), mlp_axes)
    # attn and MLP share the residual: one sum of their partials onto x's rows, one reshard
    if head_axes == mlp_axes:
        af = L._summed(a + f, mesh, head_axes, hl.dtype, x)
    else:
        af = L._summed(a, mesh, head_axes, hl.dtype, x) + L._summed(f, mesh, mlp_axes, hl.dtype, x)
    return shard(_res(x, g, af + used_on(pa["bo"], x).to(hl.dtype)), "batch", "act_seq", None)


def flux_forward(c: FluxConfig, params, img_lat, txt, vec, t, guidance=None):
    """img_lat: [B, R, R, C]; txt: [B, T, txt_dim]; vec: [B, vec_dim];
    t: [B] in [0,1]; guidance: [B] scale.  Returns velocity [B, R, R, C] f32."""
    _, H, W, _ = img_lat.shape
    p = c.patch
    img = _linear(params["img_in"], _patchify(local(img_lat).to(torch.bfloat16), p))
    img = img + _pos_embed(c.d_model, H // p, W // p, img.device).to(img.dtype)
    img = shard(rows_like(img_lat, img), "batch", "act_seq", None)
    txt = rows_like(img_lat, _linear(params["txt_in"], local(txt).to(torch.bfloat16)))

    def embed(p_mlp, v):
        return local(L.mlp(p_mlp, rows_like(img_lat, v.to(torch.bfloat16)), act=F.silu))

    cond = embed(params["t_embed"], timestep_embedding(local(t) * 1000.0, 256))
    cond = cond + embed(params["vec_in"], local(vec))
    if c.guidance and guidance is not None:
        cond = cond + embed(params["g_embed"], timestep_embedding(local(guidance) * 1000.0, 256))
    cond = F.silu(cond)

    double, single = checkpointed(c.remat, _double_block), checkpointed(c.remat, _single_block)
    for blk in unstack_tree(params["double"]):
        img, txt = double(c, blk, img, txt, cond)

    # The joint sequence, split over act_seq as the single blocks' residual.
    img = shard(img, "batch", None, None)
    x = shard(like(img, torch.cat([local(txt), local(img)], dim=1)), "batch", "act_seq", None)
    for blk in unstack_tree(params["single"]):
        x = single(c, blk, x, cond)
    x = shard(x, "batch", None, None)  # the image rows cut across the ranks' rows: gathered first
    img = like(x, local(x)[:, c.txt_len :])

    fin = params["final"]
    sh, sc = _mod(fin["adaln"], cond, 2)
    img = _linear(fin["proj"], L.modulate(L.layernorm(fin["ln"], img), sh, sc))
    return rows_like(img_lat, _unpatchify(img.to(torch.float32), p, H // p, W // p, c.in_ch))


def flux_train_loss(c: FluxConfig, params, x0, txt, vec, t, noise):
    """Rectified-flow v-prediction: x_t = (1-t) x0 + t eps, v* = eps - x0;
    over ranks on the local rows, the mean the global batch's."""
    tl, x0l, nl = local(t), local(x0), local(noise)
    tt = tl.to(torch.float32)[:, None, None, None]
    x_t = rows_like(x0, (1 - tt) * x0l + tt * nl)
    g = rows_like(t, torch.full(tl.shape, 4.0, dtype=torch.float32, device=tl.device)) if c.guidance else None
    v = flux_forward(c, params, x_t, txt, vec, t, g)
    return batch_mean((local(v) - (nl - x0l)) ** 2, x0), {}


@torch.no_grad()
def flux_sample_step(c: FluxConfig, params, x_t, txt, vec, t, dt, guidance):
    """One rectified-flow Euler step: x_{t-dt} = x_t - dt * v(x_t, t)."""
    v = flux_forward(c, params, x_t, txt, vec, t, guidance)
    return like(x_t, local(x_t) - local(dt)[:, None, None, None] * local(v))
