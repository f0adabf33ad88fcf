"""Shared transformer layers: norms, adaLN modulation, RoPE, GQA attention
(prefill and one-token decode against a KV cache, bf16 or int8), the GELU
and SwiGLU MLPs and the capacity-dispatched MoE — what ViT, the decoder LMs
and the diffusion backbones need of the reference's ``models/layers.py``.

Everything is a plain function over (cfg-like args, params dict, inputs);
each layer's parameter layout comes from its ``*_specs()`` helper, key for
key the reference's, so ``interop.from_jax`` carries weights across unchanged.

``_attend`` (called by ``attention`` and by the diffusion models' joint and
single-stream attention) runs the flash kernel (``kernels/flash_attention``)
whenever no autograd graph is needed and no explicit mask is given: the
CUDA kernel on the card, its plain version on the CPU.  The TPU kernel is
forward-only, so a forward that must be differentiated takes the
reference's own jnp branches (``blockwise_sdpa`` above
``BLOCKWISE_THRESHOLD``, else ``_sdpa``), as the reference's models do for
training.

``attention_decode`` keeps the reference's own route, ``_sdpa`` over the
whole cache with a validity mask: the flash kernel takes its lengths from
the host, and a decode step's length lives on the device.  The cache is
written in place (the reference donates it) at a tensor index, so a decode
step makes no host read.
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


def modulate(x, shift, scale):
    """adaLN modulation (DiT): x [B,S,D], shift/scale [B,D]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


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


def _attend(c: AttnCfg, q, k, v, mask=None):
    """softmax(q·kᵀ/√hd, mask)·v, q [B,S,H,hd], k/v [B,T,KH,hd] -> [B,S,H,hd].
    The flash kernel where no mask is given and no autograd graph is
    needed (reached through the module attribute ``flash_ops.attention``);
    otherwise the reference's branches."""
    S = q.shape[1]
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if mask is None and not needs_grad:
        return flash_ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=c.causal)
    if S > BLOCKWISE_THRESHOLD and mask is None:
        return blockwise_sdpa(q, k, v, causal=c.causal)
    if c.causal and mask is None:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[None, None, None]
    return _sdpa(c, q, k, v, mask)


def attention(c: AttnCfg, p, x, *, positions=None, mask=None):
    """Full (training/prefill) attention. x: [B,S,D] -> (y [B,S,D], (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(c, p, x, positions)
    out = _attend(c, q, k, v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if c.bias:
        y = y + p["bo"].to(x.dtype)
    return y, (k, v)


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization of K/V [..., KH, hd].
    ``t32 / scale`` is a true division and ``torch.round`` rounds half to
    even, as the reference: the int8 values come out bit-equal."""
    t32 = t.to(torch.float32)
    amax = t32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def attention_decode(
    c: AttnCfg, p, x, cache_k, cache_v, cache_len, *, kv_seq_axis="kv_seq",
    k_scale=None, v_scale=None,
):
    """One-token decode against a KV cache.

    x: [B,1,D]; cache_k/v: [B,T,KH,hd] (filled up to cache_len); cache_len: a
    scalar int tensor (or one of a single element) — the new token writes at
    cache_len, clamped to [0, T-1] as ``jax.lax.dynamic_update_slice`` clamps,
    while the validity mask uses the unclamped length.  With k_scale/v_scale
    [B,T,KH] the cache is int8.  The caches (and scales) are updated in place
    and returned: (y [B,1,D], cache_k, cache_v[, k_scale, v_scale]).
    ``kv_seq_axis`` names the reference's sharding axis; one card has none.
    """
    del kv_seq_axis
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"attention_decode takes one token, got x of shape {tuple(x.shape)}")
    T = cache_k.shape[1]
    quantized = k_scale is not None
    length = cache_len.reshape(())
    q, k_new, v_new = _qkv(c, p, x, length.reshape(1, 1).expand(B, 1))
    idx = length.to(torch.int64).clamp(0, T - 1).reshape(1)
    if quantized:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for buf, new in ((cache_k, kq), (cache_v, vq), (k_scale, ks), (v_scale, vs)):
            buf.index_copy_(1, idx, new)
        k_full = dequantize_kv(cache_k, k_scale, q.dtype)
        v_full = dequantize_kv(cache_v, v_scale, q.dtype)
    else:
        cache_k.index_copy_(1, idx, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, idx, v_new.to(cache_v.dtype))
        k_full, v_full = cache_k.to(q.dtype), cache_v.to(q.dtype)
    valid = (torch.arange(T, device=x.device) <= length).reshape(1, 1, 1, 1, T)
    out = _sdpa(c, q, k_full, v_full, valid)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if c.bias:
        y = y + p["bo"].to(x.dtype)
    if quantized:
        return y, cache_k, cache_v, k_scale, v_scale
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_specs(d_model: int, d_ff: int, embed_axis: str = "embed") -> dict:
    return {
        "w_gate": spec((d_model, d_ff), (embed_axis, "mlp")),
        "w_up": spec((d_model, d_ff), (embed_axis, "mlp")),
        "w_down": spec((d_ff, d_model), ("mlp", embed_axis)),
    }


def swiglu(p, x):
    g = torch.einsum("...d,df->...f", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("...d,df->...f", x, p["w_up"].to(x.dtype))
    return torch.einsum("...f,fd->...d", F.silu(g) * u, p["w_down"].to(x.dtype))


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


# ---------------------------------------------------------------------------
# Mixture of Experts — gather-based capacity dispatch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff_expert: int
    n_experts: int  # routed experts (padded to a shardable count by config)
    top_k: int
    n_shared: int = 0
    d_ff_shared: int = 0  # total shared width (already multiplied)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


def moe_specs(c: MoECfg) -> dict:
    s = {
        "router": spec((c.d_model, c.n_experts), ("embed", "expert"), scale=0.02),
        "experts": {
            "w_gate": spec((c.n_experts, c.d_model, c.d_ff_expert), ("expert", "embed", "mlp")),
            "w_up": spec((c.n_experts, c.d_model, c.d_ff_expert), ("expert", "embed", "mlp")),
            "w_down": spec((c.n_experts, c.d_ff_expert, c.d_model), ("expert", "mlp", "embed")),
        },
    }
    if c.n_shared > 0:
        s["shared"] = swiglu_specs(c.d_model, c.d_ff_shared)
    return s


def _dispatch_indices(eid_flat: torch.Tensor, n_experts: int, capacity: int):
    """Per-row dispatch plan from flat expert assignments.

    eid_flat: [..., N] integer expert ids (token-major: token t's k-th choice
    at t*K+k); leading axes are independent rows (the reference vmaps over
    them).  Returns (token_idx [..., E, C], slot_valid [..., E, C], pos
    [..., N], kept [..., N]): slot (e, c) reads flat token token_idx[e, c];
    token n lands in slot (eid[n], pos[n]) iff kept[n].  Index outputs are
    int64.
    """
    N = eid_flat.shape[-1]
    lead = eid_flat.shape[:-1]
    dev = eid_flat.device
    order = torch.argsort(eid_flat, dim=-1, stable=True)
    sorted_eid = eid_flat.gather(-1, order)
    arange = torch.arange(N, device=dev)
    is_start = torch.ones(eid_flat.shape, dtype=torch.bool, device=dev)
    is_start[..., 1:] = sorted_eid[..., 1:] != sorted_eid[..., :-1]
    group_start = torch.cummax(torch.where(is_start, arange, 0), dim=-1).values
    pos_sorted = arange - group_start  # position within expert group
    inv = torch.argsort(order, dim=-1, stable=True)
    pos = pos_sorted.gather(-1, inv)
    kept = pos < capacity
    experts = torch.arange(n_experts, dtype=eid_flat.dtype, device=dev).expand(*lead, n_experts).contiguous()
    group_offset = torch.searchsorted(sorted_eid, experts)
    counts = torch.searchsorted(sorted_eid, experts, right=True) - group_offset
    slot_c = torch.arange(capacity, device=dev)
    gather_pos = torch.clamp(group_offset[..., None] + slot_c, 0, N - 1)  # [..., E, C]
    token_idx = order.gather(-1, gather_pos.reshape(*lead, -1)).reshape(gather_pos.shape)
    slot_valid = slot_c < counts[..., None]
    return token_idx, slot_valid, pos, kept


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(c: MoECfg, p, x):
    """x: [B, S, D] -> ([B, S, D], aux loss).  Gather-based capacity dispatch:

      router -> top-k -> per-batch-row sort-derived slot plan -> gather tokens
      into an [E, B, C, D] buffer -> batched expert SwiGLU -> weighted
      scatter-add back onto the tokens.

    Overflow tokens (slot >= capacity) drop, standard capacity semantics.  The
    combine is an ``index_add_`` in the activation dtype: on CUDA its adds are
    atomic and unordered, so a bf16 output may differ between runs in the
    last bits.
    """
    B, S, D = x.shape
    K, E = c.top_k, c.n_experts
    N = S * K
    capacity = int(max(1, round(N / E * c.capacity_factor)))

    logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, K)  # [B, S, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    eid_flat = top_e.reshape(B, N)
    token_idx, slot_valid, _pos, _kept = _dispatch_indices(eid_flat, E, capacity)
    # token_idx: [B, E, C] flat indices into S*K; the source token is i // K.
    src_tok = (token_idx // K).reshape(B, E * capacity)
    buf = x.gather(1, src_tok[..., None].expand(B, E * capacity, D)).reshape(B, E, capacity, D)
    buf = buf.masked_fill(~slot_valid[..., None], 0.0).transpose(0, 1)  # [E, B, C, D]

    w = p["experts"]
    g = torch.einsum("ebcd,edf->ebcf", buf, w["w_gate"].to(buf.dtype))
    u = torch.einsum("ebcd,edf->ebcf", buf, w["w_up"].to(buf.dtype))
    out_buf = torch.einsum("ebcf,efd->ebcd", F.silu(g) * u, w["w_down"].to(buf.dtype))

    # slot weight: the routing weight of the token occupying slot (b, e, c).
    slot_w = top_w.reshape(B, N).gather(1, token_idx.reshape(B, -1)).reshape(B, E, capacity)
    slot_w = torch.where(slot_valid, slot_w, 0.0)
    upd = out_buf.transpose(0, 1) * slot_w[..., None].to(out_buf.dtype)  # [B, E, C, D]
    rows = (torch.arange(B, device=x.device)[:, None] * S + src_tok).reshape(-1)
    y = torch.zeros(B * S, D, dtype=upd.dtype, device=x.device)
    y = y.index_add_(0, rows, upd.reshape(-1, D)).reshape(B, S, D)

    if c.n_shared > 0:
        y = y + swiglu(p["shared"], x)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    me = probs.mean(dim=(0, 1))  # mean router prob per expert
    ones = torch.ones(B * N, dtype=torch.float32, device=x.device)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(0, eid_flat.reshape(-1), ones) / float(B * N)
    aux = c.router_aux_weight * E * torch.sum(me * ce)
    return y, aux
