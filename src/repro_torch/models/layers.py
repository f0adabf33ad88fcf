"""Shared transformer layers: norms, RoPE, GQA attention and the GELU MLP —
what ViT needs of the reference's ``models/layers.py``.

Everything is a plain function over (cfg-like args, params dict, inputs);
each layer's parameter layout comes from its ``*_specs()`` helper, key for
key the reference's, so ``interop.from_jax`` carries weights across unchanged.

``attention`` runs the flash kernel (``kernels/flash_attention``) whenever
no autograd graph is needed and no explicit mask is given: the CUDA kernel
on the card, its plain version on the CPU.  The TPU kernel is forward-only,
so a forward that must be differentiated takes the reference's own jnp
branches (``blockwise_sdpa`` above ``BLOCKWISE_THRESHOLD``, else ``_sdpa``),
as the reference's models do for training.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import NEG_INF, blockwise_sdpa
from .common import spec

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(dim: int, axis: str = "embed") -> dict:
    return {"scale": spec((dim,), (axis,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_specs(dim: int, axis: str = "embed") -> dict:
    return {"scale": spec((dim,), (axis,), init="ones"), "bias": spec((dim,), (axis,), init="zeros")}


def layernorm(params, x, eps: float = 1e-6):
    """Normalizes in f32 (population variance, as ``jnp.var``), casts back."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 1e6, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [D/2]
    ang = positions.to(torch.float32)[..., None] * freqs  # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm; full or causal)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    causal: bool = True
    rope: bool = True
    rope_theta: float = 1e6
    bias: bool = False


def attention_specs(c: AttnCfg) -> dict:
    d, H, KH, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
    s = {
        "wq": spec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": spec((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, KH, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if c.bias:
        s["bq"] = spec((H, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = spec((KH, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = spec((KH, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bo"] = spec((d,), ("embed",), init="zeros")
    if c.qk_norm:
        s["q_norm"] = rmsnorm_specs(c.head_dim, axis="head_dim")
        s["k_norm"] = rmsnorm_specs(c.head_dim, axis="head_dim")
    return s


def _qkv(c: AttnCfg, p, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if c.bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if c.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if c.rope:
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
    return q, k, v


def _sdpa(c: AttnCfg, q, k, v, mask=None):
    """q: [B,S,H,hd]; k/v: [B,T,KH,hd] — GQA via head grouping."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    q = q.reshape(B, S, KH, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32) / math.sqrt(hd)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, hd)


# Above this sequence length, a differentiated attention takes the blockwise
# path so long sequences never materialize an S x S score matrix.
BLOCKWISE_THRESHOLD = 4096


def attention(c: AttnCfg, p, x, *, positions=None, mask=None):
    """Full (training/prefill) attention. x: [B,S,D] -> (y [B,S,D], (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(c, p, x, positions)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if mask is None and not needs_grad:
        out = flash_ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=c.causal)
    elif S > BLOCKWISE_THRESHOLD and mask is None:
        out = blockwise_sdpa(q, k, v, causal=c.causal)
    else:
        if c.causal and mask is None:
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()[None, None, None]
        out = _sdpa(c, q, k, v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if c.bias:
        y = y + p["bo"].to(x.dtype)
    return y, (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(d_model: int, d_ff: int, out_dim: int | None = None) -> dict:
    out = out_dim or d_model
    return {
        "w1": spec((d_model, d_ff), ("embed", "mlp")),
        "b1": spec((d_ff,), ("mlp",), init="zeros"),
        "w2": spec((d_ff, out), ("mlp", "embed")),
        "b2": spec((out,), ("embed",), init="zeros"),
    }


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, act=_gelu):
    h = act(torch.einsum("...d,df->...f", x, p["w1"].to(x.dtype)) + p["b1"].to(x.dtype))
    return torch.einsum("...f,fd->...d", h, p["w2"].to(x.dtype)) + p["b2"].to(x.dtype)
