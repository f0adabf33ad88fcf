"""Plain PyTorch versions of the flash attention kernel.

Two of them:
  * ``sdpa_ref`` — naive softmax attention over the whole score matrix, the
    ground truth the CUDA kernel is held against;
  * ``blockwise_sdpa`` — the online-softmax algorithm over Q and KV blocks,
    the kernel's own loop in plain torch (the reference's
    ``models.layers.blockwise_sdpa``), with an O(S · kv_block) workspace.

Layouts are the reference's: q ``[B, S, H, hd]``, k/v ``[B, T, KH, hd]``;
GQA groups the G = H / KH query heads of one KV head (head ``h`` reads KV
head ``h // G``).  Masked logits are ``-1e30``, never ``-inf``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q: [B,S,H,hd]; k/v: [B,T,KH,hd] (GQA when H > KH) -> [B,S,H,hd].
    The causal mask is bottom-right aligned: query ``s`` sees key
    ``t <= s + T - S``."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def blockwise_sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    q_block: int = 512, kv_block: int = 1024,
) -> torch.Tensor:
    """Online softmax over KV blocks inside a loop over Q blocks.  The causal
    mask is the reference's here: ``kv_pos <= q_pos`` (self-attention,
    S == T).  q: [B,S,H,hd]; k/v: [B,T,KH,hd]."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(hd)
    pad_q, pad_k = (-S) % q_block, (-T) % kv_block
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    Sq, Tk = S + pad_q, T + pad_k
    nq, nk = Sq // q_block, Tk // kv_block
    qp = qp.reshape(B, nq, q_block, KH, G, hd)
    kp = kp.reshape(B, nk, kv_block, KH, hd)
    vp = vp.reshape(B, nk, kv_block, KH, hd)
    dev = q.device

    outs = []
    for i in range(nq):
        qi = qp[:, i]  # [B, qb, KH, G, hd]
        q_pos = i * q_block + torch.arange(q_block, device=dev)
        acc = torch.zeros(B, KH, G, q_block, hd, dtype=torch.float32, device=dev)
        m = torch.full((B, KH, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        denom = torch.zeros(B, KH, G, q_block, dtype=torch.float32, device=dev)
        for j in range(nk):
            kj, vj = kp[:, j], vp[:, j]
            logits = torch.einsum("bqkgd,btkd->bkgqt", qi, kj).to(torch.float32) * scale
            kv_pos = j * kv_block + torch.arange(kv_block, device=dev)
            valid = (kv_pos[None, :] < T).expand(q_block, kv_block)
            if causal:
                valid = valid & (kv_pos[None, :] <= q_pos[:, None])
            logits = logits.masked_fill(~valid, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(logits - m_new[..., None])
            denom = denom * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", pexp.to(vj.dtype), vj
            ).to(torch.float32)
            m = m_new
        outs.append(acc / torch.clamp(denom[..., None], min=1e-30))  # [B,KH,G,qb,hd]
    out = torch.stack(outs, dim=3).reshape(B, KH, G, Sq, hd)[:, :, :, :S]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, KH * G, hd).to(q.dtype)
