"""Decoder-only LM family (dense + MoE): qwen3, command-r, qwen2-moe,
deepseek-moe.  Layers are stored stacked on a leading ``[L]`` axis, as the
reference scans over them; here each step is a loop over the layers
(``common.unstack_tree``).

Entry points:
  abstract_params(cfg)                      parameter ParamSpec tree
  forward(cfg, params, tokens)              hidden states + MoE aux loss
  train_loss(cfg, params, tokens, labels)   masked next-token CE + aux loss
  prefill(cfg, params, tokens)              logits[:, -1:] + stacked KV cache
  decode_step(cfg, params, token, cache)    one-token decode, cache in place

Under mesh rules (``launch/steps.build_cell(..., rules=)``, a step over
``torch.distributed`` ranks) the arguments are DTensors and the layers
compute on each rank's shards (``models/layers``); the reference's
sharding points are kept (``_res_shard``, ``_unshard_seq``, the logits on
``vocab``, the cache on its ``kv_seq_axis``), and each is a
``common.shard``: the identity on one card, an explicit redistribute over
ranks.  The embedding is looked up on the rank's ``embed_tp`` slice and
gathered by the first ``_res_shard``.  A training step over ranks
(``train_rules``: ``seq_shard_acts``, FSDP) runs the same code under
autograd: each sublayer's output reduced onto the residual's rows
(``onto``), the logits split on ``vocab`` into a vocab-parallel
cross-entropy (``layers.token_nll``), its masked mean the global batch's.

Prefill attention goes through ``layers.attention``, so on the card every
layer launches the flash kernel (causal); decode keeps the reference's
masked ``_sdpa`` over the whole cache.  A forward that builds an autograd
graph (training) takes the reference's differentiable attention instead
(``layers._attend``), and with ``cfg.remat`` checkpoints each block as the
reference's ``jax.checkpoint`` does: only the block's input is kept, and
the block is run again in the backward pass.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..sharding.rules import all_sum, grad_sum
from . import layers as L
from .common import (checkpointed, current_rules, like, local, local_slice, mesh_of, on_mesh, plus, shard, spec,
                     stack_specs, tree_map, unstack, unstack_tree, used_on)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    moe: L.MoECfg | None = None
    # Gradient rematerialization: each block is checkpointed while an autograd
    # graph is built (``forward``); no effect without one.
    remat: bool = True
    # Shard the sequence dim of residual activations over "model" between
    # blocks (Megatron-SP style; set per shape for training), and the KV
    # cache's sequence-dim logical axis ("kv_seq" or "long_kv_seq").  Both
    # act only under mesh rules.
    seq_shard_acts: bool = False
    kv_seq_axis: str = "kv_seq"
    # int8 KV cache (per-token/head scales): halves the decode memory term.
    kv_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self) -> L.AttnCfg:
        return L.AttnCfg(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.hd,
            qk_norm=self.qk_norm,
            causal=True,
            rope=True,
            rope_theta=self.rope_theta,
        )


def _block_specs(c: LMConfig) -> dict:
    s = {
        "ln1": L.rmsnorm_specs(c.d_model),
        "attn": L.attention_specs(c.attn_cfg()),
        "ln2": L.rmsnorm_specs(c.d_model),
    }
    if c.moe is not None:
        s["moe"] = L.moe_specs(c.moe)
    else:
        s["ffn"] = L.swiglu_specs(c.d_model, c.d_ff)
    return s


def abstract_params(c: LMConfig) -> dict:
    return {
        "embed": spec((c.vocab, c.d_model), (None, "embed_tp"), init="embed", scale=0.02),
        "blocks": stack_specs(_block_specs(c), c.n_layers),
        "ln_f": L.rmsnorm_specs(c.d_model),
        "head": spec((c.d_model, c.vocab), ("embed", "vocab"), scale=0.02),
    }


def _ffn(c: LMConfig, blk, h, onto=None):
    """The block's second sublayer: (output, MoE aux loss or 0), onto the
    rows of ``onto`` (``layers.mlp``)."""
    if c.moe is not None:
        return L.moe(c.moe, blk["moe"], h, onto)
    return L.swiglu(blk["ffn"], h, onto), 0.0


def _embed(params, tokens):
    """The rows of ``tokens``; over ranks, of the rank's ``embed_tp`` slice
    (the lookup stays local), laid out batch as ``tokens``."""
    emb = params["embed"]
    x = used_on(emb).to(torch.bfloat16)[local(tokens)]
    return on_mesh(x, mesh_of(emb), {0: local_slice(tokens, 0)[1], 2: local_slice(emb, 1)[1]})


def _res_shard(c: LMConfig, x):
    return shard(x, "batch", "act_seq" if c.seq_shard_acts else "seq", None)


def _unshard_seq(c: LMConfig, h):
    """Megatron-SP gather point: with seq-sharded residuals, the full
    sequence once per sublayer.  The reference gathers x here where that is
    cheaper than gathering K and V (2 * n_kv * head_dim >= d_model) and
    otherwise leaves its partitioner to gather K and V inside the attention
    (and the tokens inside the MoE's routing, which needs whole rows); the
    port gathers x at every sublayer, so that each rank computes on its own
    heads, MLP columns or experts over the whole sequence.  The values are
    the same either way."""
    if c.seq_shard_acts:
        return shard(h, "batch", None, None)
    return h


def _block(c: LMConfig, blk, x):
    """One layer over the whole sequence: (x, its (k, v), MoE aux loss).
    Each sublayer's output lands on the residual's rows."""
    a, kv = L.attention(c.attn_cfg(), blk["attn"], _unshard_seq(c, L.rmsnorm(blk["ln1"], x, c.norm_eps)), onto=x)
    x = _res_shard(c, plus(x, a))
    f, aux = _ffn(c, blk, _unshard_seq(c, L.rmsnorm(blk["ln2"], x, c.norm_eps)), onto=x)
    return _res_shard(c, plus(x, f)), kv, aux


def _block_train(c: LMConfig, blk, x):
    """``_block`` without its (k, v): (x, MoE aux loss)."""
    x, _kv, aux = _block(c, blk, x)
    return x, aux


def forward(c: LMConfig, params, tokens):
    """tokens [B,S] -> (hidden [B,S,D], aux loss)."""
    x = _res_shard(c, _embed(params, tokens))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = checkpointed(c.remat, _block_train)
    for blk in unstack_tree(params["blocks"]):
        x, a_aux = block(c, blk, x)
        aux = aux + a_aux
    return L.rmsnorm(params["ln_f"], x, c.norm_eps), aux


def logits_fn(c: LMConfig, params, hidden):
    """Over ranks each rank's ``vocab`` slice, the head column-parallel on
    the whole sequence (a training forward's hidden states, split over it,
    gathered first)."""
    head = params["head"]
    hidden = shard(hidden, "batch", None, None)
    mesh, vocab = mesh_of(hidden), local_slice(head, 1)[1]
    h = grad_sum(local(hidden), mesh, vocab)
    out = torch.einsum("bsd,dv->bsv", h, used_on(head).to(h.dtype))
    out = on_mesh(out, mesh, {0: local_slice(hidden, 0)[1], 2: vocab})
    return shard(out, "batch", None, "vocab")


def train_loss(c: LMConfig, params, tokens, labels):
    """Mean next-token cross-entropy; labels = tokens shifted by the pipeline.
    A label id < 0 masks its position out.  Returns (ce + aux, {"ce", "aux"}).
    Over ranks the logits stay split on ``vocab`` (``layers.token_nll``) and
    the masked mean is the global batch's: its sum and count summed over the
    batch's mesh axes."""
    hidden, aux = forward(c, params, tokens)
    nll = L.token_nll(logits_fn(c, params, hidden), labels)
    mask = (local(labels) >= 0).to(torch.float32)
    mesh, rows = mesh_of(tokens), local_slice(tokens, 0)[1]
    total, count = all_sum(torch.sum(nll * mask), mesh, rows), all_sum(mask.sum(), mesh, rows)
    ce = total / torch.clamp(count, min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with stacked KV cache
# ---------------------------------------------------------------------------


def _cache_shape(c: LMConfig, batch: int, max_len: int) -> tuple[int, ...]:
    return (c.n_layers, batch, max_len, c.n_kv_heads, c.hd)


def make_cache(c: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device: torch.device | str = "cuda") -> dict:
    """An empty cache (int8: 0 with scale 1); under rules over ranks, each
    rank's slice of it as DTensors laid out as ``cache_specs`` resolve."""
    device = resolve_device(device)
    rules = current_rules()
    if rules is not None and rules.mesh.device_mesh is not None:
        return tree_map(lambda s: rules.constant(s, device), cache_specs(c, batch, max_len, dtype))
    shape = _cache_shape(c, batch, max_len)
    length = torch.zeros((), dtype=torch.int32, device=device)
    if c.kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
            "len": length,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": length,
    }


def cache_specs(c: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    shape = _cache_shape(c, batch, max_len)
    axes = ("layers", "batch", c.kv_seq_axis, "kv_heads", "head_dim")
    if c.kv_quant:
        return {
            "k": spec(shape, axes, dtype=torch.int8, init="zeros"),
            "v": spec(shape, axes, dtype=torch.int8, init="zeros"),
            "k_scale": spec(shape[:-1], axes[:-1], dtype=torch.float32, init="ones"),
            "v_scale": spec(shape[:-1], axes[:-1], dtype=torch.float32, init="ones"),
            "len": spec((), (), dtype=torch.int32, init="zeros"),
        }
    return {
        "k": spec(shape, axes, dtype=dtype, init="zeros"),
        "v": spec(shape, axes, dtype=dtype, init="zeros"),
        "len": spec((), (), dtype=torch.int32, init="zeros"),
    }


def _write_kv(c: LMConfig, cache: dict, layer: int, k, v, max_len: int) -> None:
    """Layer ``layer``'s K/V into the cache, laid out as the cache is (the
    reference's constraint on its stacked K/V; over ranks a redistribute of
    the rank's KV heads to its slots, after padding to ``max_len``)."""
    for name, t in (("k", k), ("v", v)):
        if mesh_of(t) is not None and t.shape[1] < max_len:
            t = like(t, F.pad(local(t), (0, 0, 0, 0, 0, max_len - t.shape[1])))
        t = local(shard(t, "batch", c.kv_seq_axis, "kv_heads", "head_dim"))
        n = t.shape[1]  # one card: the prompt (the slots past it stay empty); over ranks: the rank's slots
        if c.kv_quant:
            local(cache[name])[layer, :, :n], local(cache[f"{name}_scale"])[layer, :, :n] = L.quantize_kv(t)
        else:
            local(cache[name])[layer, :, :n] = t


@torch.no_grad()
def prefill(c: LMConfig, params, tokens, max_len: int | None = None):
    """Full forward over the prompt; returns (last-token logits [B,1,V], cache).

    The cache is allocated at ``max_len`` (default S) and each layer's K/V
    written into it as the layer runs, so no stacked copy is made; positions
    past S stay zero (int8: 0 with scale 1), as the reference's padding."""
    B, S = tokens.shape
    max_len = max_len or S
    x = _res_shard(c, _embed(params, tokens))
    cache = make_cache(c, B, max_len, x.dtype, device=x.device)  # bf16, the embedding's cast
    for layer, blk in enumerate(unstack_tree(params["blocks"])):
        x, (k, v), _ = _block(c, blk, x)
        _write_kv(c, cache, layer, k, v, max_len)
    x = L.rmsnorm(params["ln_f"], like(x, local(x)[:, -1:, :]), c.norm_eps)
    local(cache["len"]).fill_(S)
    return logits_fn(c, params, x), cache


@torch.no_grad()
def decode_step(c: LMConfig, params, token, cache):
    """token [B,1] int; cache from make_cache/prefill.  Returns (logits
    [B,1,V], cache): the cache's tensors are updated in place (the reference
    donates them) and the returned dict holds them with ``len`` + 1."""
    x = shard(_embed(params, token), "batch", None, None)
    layers = {k: unstack(cache[k]) for k in ("k", "v", "k_scale", "v_scale") if k in cache}
    for layer, blk in enumerate(unstack_tree(params["blocks"])):
        h = L.rmsnorm(blk["ln1"], x, c.norm_eps)
        scales = {"k_scale": layers["k_scale"][layer], "v_scale": layers["v_scale"][layer]} if c.kv_quant else {}
        a = L.attention_decode(c.attn_cfg(), blk["attn"], h, layers["k"][layer], layers["v"][layer], cache["len"],
                               kv_seq_axis=c.kv_seq_axis, **scales)[0]
        x = x + a
        f, _ = _ffn(c, blk, L.rmsnorm(blk["ln2"], x, c.norm_eps))
        x = x + f
    x = L.rmsnorm(params["ln_f"], x, c.norm_eps)
    return logits_fn(c, params, x), {**cache, "len": cache["len"] + 1}
