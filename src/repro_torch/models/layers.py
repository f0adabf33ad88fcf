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

Over ranks (``launch/steps.build_cell`` with mesh rules) the layers take
DTensors and compute on each rank's local shards, as the reference's GSPMD
partitions them: ``layernorm``, ``modulate`` and ``_qkv`` on the local
rows; ``attention`` and ``swiglu`` / ``mlp`` column-parallel in,
row-parallel out, with one explicit sum over the ``model`` axis (of which
``mlp`` keeps the rows of a residual split over its sequence, ``onto``); the
flash kernel on the rank's own heads; ``attention_decode`` over the rank's cache
slots, merged across the slots' axes (``_sdpa_split``); ``moe`` on the
rank's experts.  Every collective goes through ``sharding.rules``.  On
plain tensors the helpers of ``models.common`` are identities, so the same
code runs on one card.  Under autograd (a training step over ranks) the
collectives carry their adjoints (``sharding.rules``), a weight's FSDP dims
are gathered for use (``common.used_on``), and where an input held whole
feeds the rank's heads, MLP columns or experts its gradient is summed over
their axes (``rules.grad_sum``).

On ``meta`` tensors (``launch/dryrun`` sizing a step) ``_attend`` takes the
reference's branches, the program without the kernel; under
``flash_accounting`` both attentions return ``_flash_stub`` instead, which
stands for the kernel's HBM bytes as the reference's stub does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import NEG_INF, blockwise_sdpa
from ..sharding.rules import all_gather, all_max, all_sum, grad_sum
from .common import like, local, local_slice, mesh_of, on_mesh, spec, tree_map, used_on, weights

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(dim: int, axis: str = "embed") -> dict:
    return {"scale": spec((dim,), (axis,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    """Over ranks (a DTensor ``x``, its last dim whole) on the local rows,
    the scale as ``common.used_on`` gives it."""
    xl = local(x)
    x32 = xl.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return like(x, (y * used_on(params["scale"], x).to(torch.float32)).to(xl.dtype))


def layernorm_specs(dim: int, axis: str = "embed") -> dict:
    return {"scale": spec((dim,), (axis,), init="ones"), "bias": spec((dim,), (axis,), init="zeros")}


def layernorm(params, x, eps: float = 1e-6):
    """Normalizes in f32 (population variance, as ``jnp.var``), casts back.
    A DTensor ``x`` (its last dim whole) is normalized on its local rows."""
    xl, lp = local(x), weights(params, x)
    x32 = xl.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return like(x, (y * lp["scale"].to(torch.float32) + lp["bias"].to(torch.float32)).to(xl.dtype))


def modulate(x, shift, scale):
    """adaLN modulation (DiT): x [B,S,D], shift/scale [B,D] (over ranks:
    the rows of x's local batch, whole on D)."""
    return like(x, local(x) * (1.0 + used_on(scale, x)[:, None, :]) + used_on(shift, x)[:, None, :])


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


def _qkv(c: AttnCfg, p, x, positions, xkv=None):
    """q, k, v [B,S,H,hd] of x [B,S,D] (k and v of ``xkv`` where given);
    over ranks (a DTensor x) the rank's heads of each, as DTensors split on
    batch as x and on heads as the weights."""
    if mesh_of(x) is not None:
        qkv = _heads_in(c, p, x, local(positions))
        batch = local_slice(x, 0)[1]
        return tuple(on_mesh(t, mesh_of(x), {0: batch, 2: local_slice(p[w], 1)[1]})
                     for t, w in zip(qkv, ("wq", "wk", "wv")))
    xkv = x if xkv is None else xkv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(x.dtype))
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


def _heads_in(c: AttnCfg, p, x, positions):
    """Local q, k, v of the rank's heads of ``x`` (whole on the heads' mesh
    axes), from the attention's weight leaves ``p`` (``wo``, ``bo`` unused)
    as ``common.used_on`` gives them.  Under autograd x's gradient is summed
    over the axes that split ``wq``'s heads (for q) and ``wk``'s (for k and
    v), the norms' scales over the same."""
    mesh, xl = mesh_of(x), local(x)
    lp = weights({k: t for k, t in p.items() if k not in ("wo", "bo")}, x)
    if mesh is None:
        return _qkv(c, lp, xl, positions)
    q_axes, kv_axes = local_slice(p["wq"], 1)[1], local_slice(p["wk"], 1)[1]
    for name, axes in (("q_norm", q_axes), ("k_norm", kv_axes)):
        if name in lp:
            lp[name] = {"scale": grad_sum(lp[name]["scale"], mesh, axes)}
    return _qkv(c, lp, grad_sum(xl, mesh, q_axes), positions, xkv=grad_sum(xl, mesh, kv_axes))


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


# --- flash-kernel accounting -------------------------------------------------
# The flash kernel keeps its scores and softmax on chip; their HBM bytes do
# not exist.  launch/analysis measures that by tracing the step again with
# the attention replaced by a phantom of the right shape and dtype (FLOPs
# come from the plain trace, only bytes and memory from this one), as the
# reference does for its TPU kernel.
_FLASH_ACCOUNTING: list[bool] = []


class flash_accounting:
    def __enter__(self):
        _FLASH_ACCOUNTING.append(True)
        return self

    def __exit__(self, *exc):
        _FLASH_ACCOUNTING.pop()


def _flash_stub(q, k, v):
    """Phantom attention: q's shape and dtype, a data dependence on k and v
    through one element each, and almost no intermediate bytes (the
    reference's arithmetic: one-element slices, times 0, plus 1, cast,
    times q)."""
    dep = (torch.sum(k[:, :1, :1, :1]) + torch.sum(v[:, :1, :1, :1])) * 0.0
    return q * (1.0 + dep).to(q.dtype)


def _attend(c: AttnCfg, q, k, v, mask=None):
    """softmax(q·kᵀ/√hd, mask)·v, q [B,S,H,hd], k/v [B,T,KH,hd] -> [B,S,H,hd].
    ``_flash_stub`` under ``flash_accounting``.  Otherwise the flash kernel
    where no mask is given, no autograd graph is needed and the tensors
    hold values (reached through the module attribute
    ``flash_ops.attention``); else the reference's branches."""
    if _FLASH_ACCOUNTING:
        return _flash_stub(q, k, v)
    S = q.shape[1]
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if mask is None and not needs_grad and q.device.type != "meta":
        return flash_ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=c.causal)
    if S > BLOCKWISE_THRESHOLD and mask is None:
        return blockwise_sdpa(q, k, v, causal=c.causal)
    if c.causal and mask is None:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[None, None, None]
    return _sdpa(c, q, k, v, mask)


def _kv_for_heads(k, v, heads: slice, kv_heads: slice, G: int):
    """The K/V heads that query heads ``heads`` read (head h reads KV head
    h // G), from k, v holding KV heads ``kv_heads``: a run of whole groups
    keeps the grouping; a rank whose query heads split a group (heads over
    ``model``, KV heads replicated) gives each query head its own KV head."""
    n = heads.stop - heads.start
    if heads.start % G == 0 and n % G == 0:
        a = heads.start // G - kv_heads.start
        return k[:, :, a:a + n // G], v[:, :, a:a + n // G]
    idx = torch.arange(heads.start, heads.stop, device=k.device) // G - kv_heads.start
    return k.index_select(2, idx), v.index_select(2, idx)


def _partial(eq: str, h, w, axes):
    """``einsum(eq, h, w)`` of a row-parallel weight: in f32 where its
    contracted rows split over the mesh ``axes`` (a partial sum, which
    ``_summed`` adds over the ranks and rounds once to the activations'
    dtype, as one card's matmul rounds its whole sum once), else in h's
    dtype."""
    if axes:
        return torch.einsum(eq, h.float(), w.float())
    return torch.einsum(eq, h, w.to(h.dtype))


def _summed(y, mesh, axes, dtype, onto=None):
    """The ranks' partials ``y`` summed over the mesh ``axes`` in ``y``'s
    dtype, then cast to ``dtype``; ``y`` itself where nothing splits.  With
    ``onto`` (a residual DTensor split over its sequence, dim 1) only this
    rank's rows of the sum along dim 1, as ``onto`` holds them (under
    autograd their gradient summed over the rows' axes before the cut)."""
    rows, row_axes = local_slice(onto, 1) if onto is not None else (None, ())
    y = all_sum(y, mesh, axes).to(dtype) if axes else y
    return grad_sum(y, mesh, row_axes)[:, rows] if row_axes else y


def attention(c: AttnCfg, p, x, *, positions=None, mask=None, onto=None):
    """Full (training/prefill) attention. x: [B,S,D] -> (y [B,S,D], (k, v)).

    Over ranks: each rank projects its own heads (``wq``/``wk``/``wv``
    column-parallel), attends over them, and ``wo``'s row-parallel partial
    sums meet in one sum over the heads' mesh axes (with ``onto``, a
    residual split over its sequence, cut to its rows and laid out as it);
    (k, v) come back as DTensors of the rank's KV heads."""
    mesh, xl = mesh_of(x), local(x)
    B, S, _ = xl.shape
    if positions is None:
        positions = torch.arange(S, device=xl.device)[None, :].expand(B, S)
    q, k, v = _heads_in(c, p, x, local(positions))
    heads, head_axes = local_slice(p["wq"], 1)
    kv_heads, kv_axes = local_slice(p["wk"], 1)
    # Where the query heads split over an axis the KV heads do not, each rank reads its own share of k and v.
    shared = tuple(a for a in head_axes if a not in kv_axes)
    kv = _kv_for_heads(grad_sum(k, mesh, shared), grad_sum(v, mesh, shared), heads, kv_heads,
                       c.n_heads // c.n_kv_heads)
    out = _attend(c, q, *kv, mask)
    y = _summed(_partial("bshk,hkd->bsd", out, used_on(p["wo"], x), head_axes), mesh, head_axes, xl.dtype, onto)
    if c.bias:
        y = y + used_on(p["bo"], x if onto is None else onto).to(xl.dtype)
    batch = local_slice(x, 0)[1]
    return like(x if onto is None else onto, y), tuple(on_mesh(t, mesh, {0: batch, 2: kv_axes}) for t in (k, v))


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


def _sdpa_split(q, k, v, valid, mesh, axes):
    """``_sdpa`` over KV slots split over the mesh ``axes``, in the flash
    kernel's arithmetic: this rank's scores in f32 with the reference's
    -1e30 masks, their max over the ranks, then exp and the local sums of
    p and p·v in f32, one sum over the ranks, and acc / l after it."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    q = q.to(torch.float32).reshape(B, S, KH, H // KH, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k.to(torch.float32)) / math.sqrt(hd)
    logits = logits.masked_fill(~valid, NEG_INF)
    p = torch.exp(logits - all_max(logits.amax(-1, keepdim=True), mesh, axes))
    acc = torch.einsum("bkgst,btkd->bkgsd", p, v.to(torch.float32))
    acc = all_sum(torch.cat([acc, p.sum(-1, keepdim=True)], -1), mesh, axes)
    out = acc[..., :hd] / acc[..., hd:]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


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

    Over ranks the cache is split as its placements say (``kv_seq_axis``,
    the reference's logical axis, resolved so when the cache was made): the
    rank holding the new token's slot writes it, every rank attends over its
    own slots for the query heads of the KV heads it holds, and where the
    slots are split the partials merge (``_sdpa_split``); ``wo`` is
    row-parallel, one sum.
    """
    del kv_seq_axis
    mesh, xl, lp = mesh_of(x), local(x), tree_map(local, p)
    B, S, _ = xl.shape
    if S != 1:
        raise ValueError(f"attention_decode takes one token, got x of shape {tuple(x.shape)}")
    T = cache_k.shape[1]
    quantized = k_scale is not None
    length = local(cache_len).reshape(())
    q, k_new, v_new = _qkv(c, lp, xl, length.reshape(1, 1).expand(B, 1))
    heads, head_axes = local_slice(p["wq"], 1)
    kv_heads, kv_axes = local_slice(p["wk"], 1)
    slots, slot_axes = local_slice(cache_k, 1)
    held = local_slice(cache_k, 2)[0]  # the KV heads this rank's cache holds
    if held != kv_heads:
        k_new, v_new = (all_gather(t, 2, mesh, kv_axes)[:, :, held] for t in (k_new, v_new))
    idx = length.to(torch.int64).clamp(0, T - 1) - slots.start
    at = idx.clamp(0, slots.stop - slots.start - 1).reshape(1)
    mine = (idx >= 0) & (idx < slots.stop - slots.start)
    ck, cv = local(cache_k), local(cache_v)

    def put(buf, new):
        new = new.to(buf.dtype)
        if slot_axes:  # another rank may hold the slot: this one writes back what it has
            new = torch.where(mine, new, buf.index_select(1, at))
        buf.index_copy_(1, at, new)

    if quantized:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for buf, new in ((ck, kq), (cv, vq), (local(k_scale), ks), (local(v_scale), vs)):
            put(buf, new)
    else:
        put(ck, k_new)
        put(cv, v_new)
    if _FLASH_ACCOUNTING:  # a kernel reads the cache at its stored width (int8 when quantized)
        out = _flash_stub(q, ck, cv)
    else:
        if quantized:
            k_full = dequantize_kv(ck, local(k_scale), q.dtype)
            v_full = dequantize_kv(cv, local(v_scale), q.dtype)
        else:
            k_full, v_full = ck.to(q.dtype), cv.to(q.dtype)
        G = c.n_heads // c.n_kv_heads
        qs = slice(held.start * G, held.stop * G)  # the query heads of the KV heads held here
        if qs != heads:
            q = all_gather(q, 2, mesh, head_axes)[:, :, qs]
        valid = (torch.arange(slots.start, slots.stop, device=xl.device) <= length).reshape(1, 1, 1, 1, -1)
        if slot_axes:
            out = _sdpa_split(q, k_full, v_full, valid, mesh, slot_axes).to(q.dtype)
        else:
            out = _sdpa(c, q, k_full, v_full, valid)
        out = out[:, :, heads.start - qs.start:heads.stop - qs.start]
    y = _summed(_partial("bshk,hkd->bsd", out, lp["wo"], head_axes), mesh, head_axes, xl.dtype)
    if c.bias:
        y = y + lp["bo"].to(xl.dtype)
    if quantized:
        return like(x, y), cache_k, cache_v, k_scale, v_scale
    return like(x, y), cache_k, cache_v


def token_nll(logits, labels):
    """-log softmax(logits)[label] in f32 for each row of ``logits`` [..., V]
    (``labels`` [...] int; a label < 0 reads class 0, for the caller to
    mask).  Over ranks ``logits`` is a DTensor that may split its classes
    (``vocab``): the logsumexp from the ranks' max and one sum, the gold
    logit from the rank that holds the label's class, one sum; the local
    rows of the result, whole on every rank of the classes' axes."""
    ll = local(logits).to(torch.float32)
    lab = local(labels).to(torch.int64).clamp(min=0)
    cols, axes = local_slice(logits, logits.dim() - 1)
    if not axes:
        return torch.logsumexp(ll, dim=-1) - torch.gather(ll, -1, lab[..., None])[..., 0]
    mesh = mesh_of(logits)
    m = all_max(ll.detach().amax(dim=-1, keepdim=True), mesh, axes)
    lse = m[..., 0] + torch.log(all_sum(torch.exp(ll - m).sum(dim=-1), mesh, axes))
    own = (lab >= cols.start) & (lab < cols.stop)
    gold = torch.gather(ll, -1, (lab - cols.start).clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
    return lse - all_sum(torch.where(own, gold, 0.0), mesh, axes)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_specs(d_model: int, d_ff: int, embed_axis: str = "embed") -> dict:
    return {
        "w_gate": spec((d_model, d_ff), (embed_axis, "mlp")),
        "w_up": spec((d_model, d_ff), (embed_axis, "mlp")),
        "w_down": spec((d_ff, d_model), ("mlp", embed_axis)),
    }


def _swiglu_hidden(p, x):
    g = torch.einsum("...d,df->...f", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("...d,df->...f", x, p["w_up"].to(x.dtype))
    return F.silu(g) * u


def swiglu(p, x, onto=None):
    """Over ranks: column-parallel ``w_gate``/``w_up``, row-parallel
    ``w_down`` on the rank's MLP slice, one sum (onto ``onto``'s rows, as
    ``mlp``)."""
    mesh, xl, lp, axes = mesh_of(x), local(x), weights(p, x), local_slice(p["w_gate"], 1)[1]
    y = _partial("...f,fd->...d", _swiglu_hidden(lp, grad_sum(xl, mesh, axes)), lp["w_down"], axes)
    return like(x if onto is None else onto, _summed(y, mesh, axes, xl.dtype, onto))


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


def mlp(p, x, act=_gelu, onto=None):
    """Over ranks: column-parallel ``w1``, row-parallel ``w2``, one sum,
    then ``b2``.  With ``onto`` (a residual split over its sequence) the
    sum lands on ``onto``'s rows and the output is laid out as ``onto``."""
    mesh, xl, axes = mesh_of(x), local(x), local_slice(p["w1"], 1)[1]
    lp = weights({k: p[k] for k in ("w1", "b1", "w2")}, x)
    h = act(torch.einsum("...d,df->...f", grad_sum(xl, mesh, axes), lp["w1"].to(xl.dtype)) + lp["b1"].to(xl.dtype))
    y = _summed(_partial("...f,fd->...d", h, lp["w2"], axes), mesh, axes, xl.dtype, onto)
    out = x if onto is None else onto
    return like(out, y + used_on(p["b2"], out).to(xl.dtype))


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


def moe(c: MoECfg, p, x, onto=None):
    """x: [B, S, D] -> ([B, S, D], aux loss).  Gather-based capacity dispatch:

      router -> top-k -> per-batch-row sort-derived slot plan -> gather tokens
      into an [E, B, C, D] buffer -> batched expert SwiGLU -> weighted
      scatter-add back onto the tokens.

    Overflow tokens (slot >= capacity) drop, standard capacity semantics.  The
    combine is an ``index_add_`` in the activation dtype: on CUDA its adds are
    atomic and unordered, so a bf16 output may differ between runs in the
    last bits.

    Over ranks the experts are split (EP, the reference's ``[E, B, C, D]``
    buffer sharded on E): the router's logits are gathered, every rank
    routes alike, runs its own experts' slots and scatter-adds them onto the
    tokens, and the partial outputs meet in one sum (the reference's psum
    formulation), the shared experts' row-parallel partials with them
    (onto ``onto``'s rows, as ``mlp``).  Under autograd the tokens' and
    routing weights' gradients are summed over the axes that split the
    experts (``layers.grad_sum``), and the aux loss's means are the global
    batch's.
    """
    mesh, xl, lp = mesh_of(x), local(x), weights(p, x)
    B, S, D = xl.shape
    K, E = c.top_k, c.n_experts
    N = S * K
    capacity = int(max(1, round(N / E * c.capacity_factor)))

    router_axes = local_slice(p["router"], 1)[1]
    logits = torch.einsum("bsd,de->bse", grad_sum(xl, mesh, router_axes), lp["router"].to(xl.dtype))
    logits = all_gather(logits.to(torch.float32), 2, mesh, router_axes)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, K)  # [B, S, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    eid_flat = top_e.reshape(B, N)
    token_idx, slot_valid, _pos, _kept = _dispatch_indices(eid_flat, E, capacity)
    # token_idx: [B, E, C] flat indices into S*K; the source token is i // K.
    # This rank runs the slots of its experts (all of them on one card).
    experts, expert_axes = local_slice(p["experts"]["w_gate"], 0)
    axes = expert_axes + local_slice(p["experts"]["w_gate"], 2)[1]  # an expert's MLP splits where E cannot
    token_idx, slot_valid = token_idx[:, experts], slot_valid[:, experts]
    n_local = token_idx.shape[1]
    src_tok = (token_idx // K).reshape(B, n_local * capacity)
    buf = grad_sum(xl, mesh, axes).gather(1, src_tok[..., None].expand(B, n_local * capacity, D))
    buf = buf.reshape(B, n_local, capacity, D).masked_fill(~slot_valid[..., None], 0.0).transpose(0, 1)  # [E, B, C, D]

    w = lp["experts"]
    g = torch.einsum("ebcd,edf->ebcf", buf, w["w_gate"].to(buf.dtype))
    u = torch.einsum("ebcd,edf->ebcf", buf, w["w_up"].to(buf.dtype))
    out_buf = _partial("ebcf,efd->ebcd", F.silu(g) * u, w["w_down"], axes)

    # slot weight: the routing weight of the token occupying slot (b, e, c).
    slot_w = grad_sum(top_w, mesh, axes).reshape(B, N).gather(1, token_idx.reshape(B, -1))
    slot_w = slot_w.reshape(B, n_local, capacity)
    slot_w = torch.where(slot_valid, slot_w, 0.0)
    upd = out_buf.transpose(0, 1) * slot_w[..., None].to(out_buf.dtype)  # [B, E, C, D]
    rows = (torch.arange(B, device=xl.device)[:, None] * S + src_tok).reshape(-1)
    y = torch.zeros(B * S, D, dtype=upd.dtype, device=xl.device)
    y = y.index_add_(0, rows, upd.reshape(-1, D)).reshape(B, S, D)

    if c.n_shared > 0:
        shared_axes = local_slice(p["shared"]["w_gate"], 1)[1]
        hidden = _swiglu_hidden(lp["shared"], grad_sum(xl, mesh, shared_axes))
        shared = _partial("...f,fd->...d", hidden, lp["shared"]["w_down"], shared_axes)
        if shared_axes != axes:
            y, shared = _summed(y, mesh, axes, xl.dtype), _summed(shared, mesh, shared_axes, xl.dtype)
            axes = ()
        y = y + shared
    y = _summed(y, mesh, axes, xl.dtype, onto)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    me = probs.mean(dim=(0, 1))  # mean router prob per expert
    ones = torch.ones(B * N, dtype=torch.float32, device=xl.device)
    ce = torch.zeros(E, dtype=torch.float32, device=xl.device).index_add_(0, eid_flat.reshape(-1), ones) / float(B * N)
    batch_axes = local_slice(x, 0)[1]
    if batch_axes:  # the global batch's means: the mean of the ranks' (equal batches)
        me, ce = (all_sum(torch.cat([me, ce]), mesh, batch_axes) / (x.shape[0] // B)).split(E)
    aux = c.router_aux_weight * E * torch.sum(me * ce)
    return like(x if onto is None else onto, y), aux
