"""Vision transformers: ViT (plain) and Swin (shifted windows).

Encoder-only classifiers: ``vit_forward`` / ``swin_forward(cfg, params,
images) -> logits``.  The patch embedding is part of the model.  The
parameter layout is the reference's: blocks stacked on a leading ``[L]``
axis (``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``), and the patch-embedding
conv stored OIHW like every conv of the port.  The casts are the
reference's too: the patch-embedding conv and the activations in bf16,
norms in f32, logits returned in f32.

ViT's attention goes through ``layers.attention``, so an inference forward
runs the flash kernel once per block.  Swin's window attention is computed
inline, with its relative-position bias and shift mask, as in the
reference: it runs no kernel of the port, and none of its matmuls goes
through ``models.common.matmul``.

Under mesh rules (``launch/steps.build_cell(..., rules=)``, a
``classify_serve`` step over ``torch.distributed`` ranks) the images and
weights are DTensors and each rank computes on its local shards: the batch
on ``data``; attention on the rank's heads and the MLPs column- then
row-parallel on ``model`` (``models/layers``; a head count the ``model``
extent does not divide stays whole on every rank, the MLP split all the
same); Swin's window attention inline on the rank's heads, its
relative-position bias sliced with them, and its patch merging's
column-parallel output gathered whole for the next stage's norm.  The
logits come back split over ``vocab`` as the head's columns are.  A
training forward over ranks (``train_rules``) is the same code under
autograd, the weights' ``embed`` dims gathered (``common.used_on``).
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
from .common import (like, local, local_slice, mesh_of, on_mesh, plus, rows_like, shard, spec, stack_specs,
                     unstack_tree, used_on, weights)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000

    @property
    def n_patches(self) -> int:
        return (self.img_res // self.patch) ** 2

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


def _vit_block_specs(c: ViTConfig) -> dict:
    return {
        "ln1": L.layernorm_specs(c.d_model),
        "attn": L.attention_specs(c.attn_cfg()),
        "ln2": L.layernorm_specs(c.d_model),
        "mlp": L.mlp_specs(c.d_model, c.d_ff),
    }


def vit_abstract_params(c: ViTConfig) -> dict:
    return {
        "patch_embed": {
            "w": spec((c.d_model, 3, c.patch, c.patch), ("embed", "conv_in", None, None), init="conv"),
            "b": spec((c.d_model,), ("embed",), init="zeros"),
        },
        "cls": spec((1, 1, c.d_model), (None, None, "embed"), scale=0.02),
        "pos": spec((1, c.n_patches + 1, c.d_model), (None, None, "embed"), scale=0.02),
        "blocks": stack_specs(_vit_block_specs(c), c.n_layers),
        "ln_f": L.layernorm_specs(c.d_model),
        "head": {
            "w": spec((c.d_model, c.n_classes), ("embed", "vocab")),
            "b": spec((c.n_classes,), ("vocab",), init="zeros"),
        },
    }


def _vit_block(c: ViTConfig, p, x):
    a, _ = L.attention(c.attn_cfg(), p["attn"], L.layernorm(p["ln1"], x))
    x = shard(plus(x, a), "batch", None, None)
    f = L.mlp(p["mlp"], L.layernorm(p["ln2"], x))
    return shard(plus(x, f), "batch", None, None)


def _head(p, images, h):
    """Logits f32 of the pooled features ``h`` (local rows, whole): over
    ranks a DTensor of the rank's ``vocab`` columns."""
    mesh, vocab = mesh_of(p["w"]), local_slice(p["w"], 1)[1]
    w, b = used_on(p["w"]), used_on(p["b"])
    logits = (grad_sum(h, mesh, vocab) @ w.to(h.dtype) + b.to(h.dtype)).to(torch.float32)
    return on_mesh(logits, mesh_of(images), {0: local_slice(images, 0)[1], 1: vocab})


def vit_forward(c: ViTConfig, params, images):
    """images: [B, H, W, 3] -> logits [B, n_classes] f32."""
    pe, imgs = weights(params["patch_embed"]), local(images)
    B = imgs.shape[0]
    x = F.conv2d(imgs.to(torch.bfloat16).permute(0, 3, 1, 2), pe["w"].to(torch.bfloat16), stride=c.patch)  # VALID
    x = x.permute(0, 2, 3, 1).reshape(B, -1, c.d_model) + pe["b"].to(torch.bfloat16)
    cls = used_on(params["cls"]).to(x.dtype).expand(B, 1, c.d_model)
    x = torch.cat([cls, x], dim=1) + used_on(params["pos"]).to(x.dtype)
    x = shard(rows_like(images, x), "batch", None, None)
    for blk in unstack_tree(params["blocks"]):  # the reference's lax.scan over the stacked blocks
        x = _vit_block(c, blk, x)
    x = L.layernorm(params["ln_f"], x)
    return _head(params["head"], images, local(x)[:, 0])


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str
    img_res: int
    patch: int = 4
    window: int = 7
    depths: tuple[int, ...] = (2, 2, 18, 2)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    n_heads: tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: int = 4
    n_classes: int = 1000


def _swin_attn_cfg(dim: int, heads: int) -> L.AttnCfg:
    return L.AttnCfg(
        d_model=dim,
        n_heads=heads,
        n_kv_heads=heads,
        head_dim=dim // heads,
        causal=False,
        rope=False,
        bias=True,
    )


def _swin_block_specs(c: SwinConfig, dim: int, heads: int) -> dict:
    w = c.window
    return {
        "ln1": L.layernorm_specs(dim),
        "attn": L.attention_specs(_swin_attn_cfg(dim, heads)),
        "rel_bias": spec(((2 * w - 1) * (2 * w - 1), heads), (None, "heads"), scale=0.02),
        "ln2": L.layernorm_specs(dim),
        "mlp": L.mlp_specs(dim, dim * c.mlp_ratio),
    }


def swin_abstract_params(c: SwinConfig) -> dict:
    p: dict = {
        "patch_embed": {
            "w": spec((c.dims[0], 3, c.patch, c.patch), ("embed", "conv_in", None, None), init="conv"),
            "b": spec((c.dims[0],), ("embed",), init="zeros"),
            "ln": L.layernorm_specs(c.dims[0]),
        }
    }
    for i, (depth, dim, heads) in enumerate(zip(c.depths, c.dims, c.n_heads)):
        stage: dict = {"blocks": stack_specs(_swin_block_specs(c, dim, heads), depth)}
        if i < len(c.depths) - 1:
            stage["merge"] = {
                "ln": L.layernorm_specs(4 * dim),
                "w": spec((4 * dim, c.dims[i + 1]), ("embed", "mlp")),
            }
        p[f"stage{i}"] = stage
    p["ln_f"] = L.layernorm_specs(c.dims[-1])
    p["head"] = {
        "w": spec((c.dims[-1], c.n_classes), ("embed", "vocab")),
        "b": spec((c.n_classes,), ("vocab",), init="zeros"),
    }
    return p


def _rel_bias_index(w: int) -> np.ndarray:
    """[w*w, w*w] int64: row of ``rel_bias`` for each (query, key) pair of a
    window, by their relative offset (dy, dx) in [-(w-1), w-1]²."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"), 0).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """[nW, w*w, w*w] bool: which key each query of a shifted window may see —
    tokens of the same one of the 3x3 regions the cyclic shift brings
    together, cut by the reference's slices."""
    img_mask = np.zeros((H, W), np.int32)
    cnt = 0
    for hsl in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for wsl in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img_mask[hsl, wsl] = cnt
            cnt += 1
    nh, nw = H // w, W // w
    mw = img_mask.reshape(nh, w, nw, w).transpose(0, 2, 1, 3).reshape(nh * nw, w * w)
    return mw[:, None, :] == mw[:, :, None]


@functools.lru_cache(maxsize=64)
def _window_tables(H: int, W: int, w: int, shift: int, device: torch.device):
    """(relative-bias index, shift mask or None) on ``device``, made once per
    feature-map shape."""
    index = torch.as_tensor(_rel_bias_index(w).reshape(-1), device=device)
    mask = torch.as_tensor(_shift_mask(H, W, w, shift), device=device) if shift else None
    return index, mask


def _window_attention(c: SwinConfig, dim: int, heads: int, p, x, H: int, W: int, shift: int):
    """x: [B, H*W, dim] -> same, windowed MSA with optional cyclic shift.
    Over ranks on the local batch rows and the rank's heads (``wq``/``wk``/
    ``wv`` and ``rel_bias`` column slices, ``wo`` row-parallel: one sum)."""
    mesh, out_like, head_axes = mesh_of(x), x, local_slice(p["wq"], 1)[1]
    x, p = grad_sum(local(x), mesh, head_axes), weights(p, x)
    heads = p["wq"].shape[1]  # the rank's
    B = x.shape[0]
    w = c.window
    xs = x.reshape(B, H, W, dim)
    if shift:
        xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
    nh, nw = H // w, W // w  # windows in (b, row, column) order
    xw = xs.reshape(B, nh, w, nw, w, dim).permute(0, 1, 3, 2, 4, 5).reshape(B * nh * nw, w * w, dim)

    index, mask = _window_tables(H, W, w, shift, x.device)
    bias = p["rel_bias"][index].reshape(w * w, w * w, heads).permute(2, 0, 1)[None, :, None]  # [1, KH, 1, S, T]
    q, k, v = L._qkv(_swin_attn_cfg(dim, heads), p, xw, None)
    BW, S, _, hd = q.shape
    qg = q.reshape(BW, S, heads, 1, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) / math.sqrt(hd)
    logits = logits + bias.to(torch.float32)
    if mask is not None:  # [nW, S, T] -> [B*nW, 1, 1, S, T]
        logits = torch.where(mask.repeat(B, 1, 1)[:, None, None], logits, -1e30)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", attn, v).reshape(BW, S, heads, hd)
    y = L._summed(L._partial("bshk,hkd->bsd", out, p["wo"], head_axes), mesh, head_axes, xw.dtype)
    y = y + p["bo"].to(xw.dtype)

    ys = y.reshape(B, nh, nw, w, w, dim).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, dim)
    if shift:
        ys = torch.roll(ys, shifts=(shift, shift), dims=(1, 2))
    return like(out_like, ys.reshape(B, H * W, dim))


def _swin_block(c: SwinConfig, dim: int, heads: int, p, x, H: int, W: int, shift: int):
    a = _window_attention(c, dim, heads, {**p["attn"], "rel_bias": p["rel_bias"]},
                          L.layernorm(p["ln1"], x), H, W, shift)
    x = shard(plus(x, a), "batch", None, None)
    f = L.mlp(p["mlp"], L.layernorm(p["ln2"], x))
    return shard(plus(x, f), "batch", None, None)


def _patch_merge(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, H/2*W/2, 4C]: each 2x2 neighbourhood concatenated
    in the reference's order, (row, column) offsets (0,0), (0,1), (1,0), (1,1)."""
    B, C = x.shape[0], x.shape[-1]
    xs = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(B, (H // 2) * (W // 2), 4 * C)


def swin_forward(c: SwinConfig, params, images):
    """images: [B, H, W, 3] -> logits [B, n_classes] f32."""
    pe, imgs = weights(params["patch_embed"]), local(images)
    B = imgs.shape[0]
    x = F.conv2d(imgs.to(torch.bfloat16).permute(0, 3, 1, 2), pe["w"].to(torch.bfloat16), stride=c.patch)  # VALID
    H = W = c.img_res // c.patch
    x = x.permute(0, 2, 3, 1).reshape(B, H * W, c.dims[0]) + pe["b"].to(torch.bfloat16)
    x = rows_like(images, L.layernorm(pe["ln"], x))

    for i, (depth, dim, heads) in enumerate(zip(c.depths, c.dims, c.n_heads)):
        stage = params[f"stage{i}"]
        # Canonical Swin: no shift when one window covers the feature map.
        shift_amt = c.window // 2 if H > c.window else 0
        for idx, blk in enumerate(unstack_tree(stage["blocks"])):  # the reference's lax.scan; odd blocks shift
            x = _swin_block(c, dim, heads, blk, x, H, W, shift_amt if idx % 2 else 0)
        if i < len(c.depths) - 1:
            # Patch merging: 2x2 neighbourhood concat + linear down-projection,
            # its columns (split over mlp on ranks) gathered whole for the next norm.
            mw = stage["merge"]["w"]
            mesh, cols = mesh_of(mw), local_slice(mw, 1)[1]
            xs = L.layernorm(stage["merge"]["ln"], _patch_merge(local(x), H, W))
            y = torch.einsum("bsd,dk->bsk", grad_sum(xs, mesh, cols), used_on(mw).to(xs.dtype))
            x = rows_like(images, all_gather(y, 2, mesh, cols))
            H, W = H // 2, W // 2

    x = L.layernorm(params["ln_f"], x)
    return _head(params["head"], images, local(x).mean(dim=1))
