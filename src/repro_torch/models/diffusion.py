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
does.  The reference's sharding hints (``shard``, ``_pin_replicated``) are
identities on one card and are left out.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from . import layers as L
from .common import checkpointed, spec, stack_specs, unstack_tree


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


def _dit_block(c: DiTConfig, p, x, cond):
    mod = cond @ p["adaln"]["w"].to(cond.dtype) + p["adaln"]["b"].to(cond.dtype)
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)
    h = L.modulate(L.layernorm(p["ln1"], x), sh1, sc1)
    a, _ = L.attention(c.attn_cfg(), p["attn"], h)
    x = x + g1[:, None, :] * a
    h = L.modulate(L.layernorm(p["ln2"], x), sh2, sc2)
    f = L.mlp(p["mlp"], h)
    return x + g2[:, None, :] * f


def dit_forward(c: DiTConfig, params, x_t, t, y):
    """x_t: [B, L, L, C] latent; t: [B]; y: [B] int labels.
    Returns [B, L, L, 2C] f32 (noise prediction + sigma channels)."""
    B, H, W, _ = x_t.shape
    p = c.patch
    x = _patchify(x_t.to(torch.bfloat16), p)
    x = x @ params["x_embed"]["w"].to(x.dtype) + params["x_embed"]["b"].to(x.dtype)
    x = x + _pos_embed(c.d_model, H // p, W // p, x.device).to(x.dtype)

    temb = L.mlp(params["t_embed"], timestep_embedding(t, 256).to(torch.bfloat16), act=F.silu)
    yemb = params["y_embed"].to(torch.bfloat16)[y]
    cond = F.silu(temb + yemb)

    block = checkpointed(c.remat, _dit_block)
    for blk in unstack_tree(params["blocks"]):
        x = block(c, blk, x, cond)

    fin = params["final"]
    mod = cond @ fin["adaln"]["w"].to(cond.dtype) + fin["adaln"]["b"].to(cond.dtype)
    sh, sc = torch.chunk(mod, 2, dim=-1)
    x = L.modulate(L.layernorm(fin["ln"], x), sh, sc)
    x = x @ fin["proj"]["w"].to(x.dtype) + fin["proj"]["b"].to(x.dtype)
    return _unpatchify(x.to(torch.float32), p, H // p, W // p, 2 * c.in_ch)


def dit_train_loss(c: DiTConfig, params, x0, t, y, noise):
    """DDPM eps-prediction MSE at cosine-schedule timestep t in [0,1]."""
    a = torch.cos(0.5 * math.pi * t).to(torch.float32)[:, None, None, None]
    s = torch.sin(0.5 * math.pi * t).to(torch.float32)[:, None, None, None]
    x_t = a * x0 + s * noise
    pred = dit_forward(c, params, x_t, t * 1000.0, y)
    eps = pred[..., : c.in_ch]
    return torch.mean((eps - noise) ** 2), {}


@torch.no_grad()
def dit_sample_step(c: DiTConfig, params, x_t, t, dt, y):
    """One DDIM-style step from t to t - dt (cosine schedule)."""
    pred = dit_forward(c, params, x_t, t * 1000.0, y)
    eps = pred[..., : c.in_ch].to(torch.float32)
    a_t = torch.cos(0.5 * math.pi * t)[:, None, None, None]
    s_t = torch.sin(0.5 * math.pi * t)[:, None, None, None]
    x0 = (x_t - s_t * eps) / torch.clamp(a_t, min=1e-4)
    t2 = torch.clamp(t - dt, min=0.0)
    a2 = torch.cos(0.5 * math.pi * t2)[:, None, None, None]
    s2 = torch.sin(0.5 * math.pi * t2)[:, None, None, None]
    return a2 * x0 + s2 * eps


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


def _mod(p, vec, n):
    m = vec @ p["w"].to(vec.dtype) + p["b"].to(vec.dtype)
    return torch.chunk(m, n, dim=-1)


def _joint_attention(c: FluxConfig, p_img, p_txt, img, txt):
    """Compute q/k/v per stream, attend jointly over [txt; img]."""
    ac = c.attn_cfg()
    qi, ki, vi = L._qkv(ac, p_img, img, None)  # no rope: positions unused
    qt, kt, vt = L._qkv(ac, p_txt, txt, None)
    q = torch.cat([qt, qi], dim=1)
    k = torch.cat([kt, ki], dim=1)
    v = torch.cat([vt, vi], dim=1)
    out = L._attend(ac, q, k, v)
    ot, oi = out[:, : txt.shape[1]], out[:, txt.shape[1] :]
    yi = torch.einsum("bshk,hkd->bsd", oi, p_img["wo"].to(img.dtype)) + p_img["bo"].to(img.dtype)
    yt = torch.einsum("bshk,hkd->bsd", ot, p_txt["wo"].to(txt.dtype)) + p_txt["bo"].to(txt.dtype)
    return yi, yt


def _double_block(c: FluxConfig, p, img, txt, vec):
    mi = _mod(p["img"]["mod"], vec, 6)
    mt = _mod(p["txt"]["mod"], vec, 6)
    hi = L.modulate(L.layernorm(p["img"]["ln1"], img), mi[0], mi[1])
    ht = L.modulate(L.layernorm(p["txt"]["ln1"], txt), mt[0], mt[1])
    ai, at = _joint_attention(c, p["img"]["attn"], p["txt"]["attn"], hi, ht)
    img = img + mi[2][:, None] * ai
    txt = txt + mt[2][:, None] * at
    hi2 = L.modulate(L.layernorm(p["img"]["ln2"], img), mi[3], mi[4])
    fi = L.mlp(p["img"]["mlp"], hi2)
    ft = L.mlp(p["txt"]["mlp"], L.modulate(L.layernorm(p["txt"]["ln2"], txt), mt[3], mt[4]))
    img = img + mi[5][:, None] * fi
    txt = txt + mt[5][:, None] * ft
    return img, txt


def _single_block(c: FluxConfig, p, x, vec):
    sh, sc, g = _mod(p["mod"], vec, 3)
    h = L.modulate(L.layernorm(p["ln"], x), sh, sc)
    ac = c.attn_cfg()
    q, k, v = L._qkv(ac, p["attn"], h, None)
    o = L._attend(ac, q, k, v)
    a = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"].to(x.dtype)) + p["attn"]["bo"].to(x.dtype)
    f = L._gelu(h @ p["mlp_in"].to(h.dtype)) @ p["mlp_out"].to(h.dtype)
    # attn and MLP share the residual
    return x + g[:, None] * (a + f)


def flux_forward(c: FluxConfig, params, img_lat, txt, vec, t, guidance=None):
    """img_lat: [B, R, R, C]; txt: [B, T, txt_dim]; vec: [B, vec_dim];
    t: [B] in [0,1]; guidance: [B] scale.  Returns velocity [B, R, R, C] f32."""
    B, H, W, _ = img_lat.shape
    p = c.patch
    img = _patchify(img_lat.to(torch.bfloat16), p)
    img = img @ params["img_in"]["w"].to(img.dtype) + params["img_in"]["b"].to(img.dtype)
    img = img + _pos_embed(c.d_model, H // p, W // p, img.device).to(img.dtype)
    txt = txt.to(torch.bfloat16) @ params["txt_in"]["w"].to(torch.bfloat16) + params["txt_in"]["b"].to(
        torch.bfloat16
    )

    cond = L.mlp(params["t_embed"], timestep_embedding(t * 1000.0, 256).to(torch.bfloat16), act=F.silu)
    cond = cond + L.mlp(params["vec_in"], vec.to(torch.bfloat16), act=F.silu)
    if c.guidance and guidance is not None:
        cond = cond + L.mlp(
            params["g_embed"], timestep_embedding(guidance * 1000.0, 256).to(torch.bfloat16), act=F.silu
        )
    cond = F.silu(cond)

    double, single = checkpointed(c.remat, _double_block), checkpointed(c.remat, _single_block)
    for blk in unstack_tree(params["double"]):
        img, txt = double(c, blk, img, txt, cond)

    x = torch.cat([txt, img], dim=1)
    for blk in unstack_tree(params["single"]):
        x = single(c, blk, x, cond)
    img = x[:, c.txt_len :]

    fin = params["final"]
    sh, sc = _mod(fin["adaln"], cond, 2)
    img = L.modulate(L.layernorm(fin["ln"], img), sh, sc)
    img = img @ fin["proj"]["w"].to(img.dtype) + fin["proj"]["b"].to(img.dtype)
    return _unpatchify(img.to(torch.float32), p, H // p, W // p, c.in_ch)


def flux_train_loss(c: FluxConfig, params, x0, txt, vec, t, noise):
    """Rectified-flow v-prediction: x_t = (1-t) x0 + t eps, v* = eps - x0."""
    tt = t.to(torch.float32)[:, None, None, None]
    x_t = (1 - tt) * x0 + tt * noise
    g = torch.full(t.shape, 4.0, dtype=torch.float32, device=t.device) if c.guidance else None
    v = flux_forward(c, params, x_t, txt, vec, t, g)
    return torch.mean((v - (noise - x0)) ** 2), {}


@torch.no_grad()
def flux_sample_step(c: FluxConfig, params, x_t, txt, vec, t, dt, guidance):
    """One rectified-flow Euler step: x_{t-dt} = x_t - dt * v(x_t, t)."""
    v = flux_forward(c, params, x_t, txt, vec, t, guidance)
    return x_t - dt[:, None, None, None] * v
