"""Vision transformers: ViT (plain).  Swin is not ported yet.

An encoder-only classifier: ``vit_forward(cfg, params, images) -> logits``.
The patch embedding is part of the model.  The parameter layout is the
reference's: blocks stacked on a leading ``[L]`` axis (``wq [L, d, H, hd]``,
``wo [L, H, hd, d]``), and the patch-embedding conv stored OIHW like every
conv of the port.  The casts are the reference's too: the patch-embedding
conv and the activations in bf16, norms in f32, logits returned in f32.
Attention goes through ``layers.attention``, so an inference forward runs
the flash kernel once per block.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import layers as L
from .common import index_tree, shard, spec, stack_specs


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
    x = shard(x + a, "batch", None, None)
    f = L.mlp(p["mlp"], L.layernorm(p["ln2"], x))
    return shard(x + f, "batch", None, None)


def vit_forward(c: ViTConfig, params, images):
    """images: [B, H, W, 3] -> logits [B, n_classes] f32."""
    B = images.shape[0]
    w = params["patch_embed"]["w"].to(torch.bfloat16)
    x = F.conv2d(images.to(torch.bfloat16).permute(0, 3, 1, 2), w, stride=c.patch)  # VALID
    x = x.permute(0, 2, 3, 1).reshape(B, -1, c.d_model) + params["patch_embed"]["b"].to(torch.bfloat16)
    cls = params["cls"].to(x.dtype).expand(B, 1, c.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype)
    x = shard(x, "batch", None, None)
    for layer in range(c.n_layers):  # the reference's lax.scan over the stacked blocks
        x = _vit_block(c, index_tree(params["blocks"], layer), x)
    x = L.layernorm(params["ln_f"], x)
    h = x[:, 0]
    logits = h @ params["head"]["w"].to(h.dtype) + params["head"]["b"].to(h.dtype)
    return logits.to(torch.float32)
