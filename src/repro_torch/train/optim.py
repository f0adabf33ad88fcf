"""AdamW with linear warmup + cosine decay, on dicts of tensors.

Optimizer state mirrors the params tree: {"m": ..., "v": ...} in f32 plus an
integer step.  Unlike the reference's pure update, ``adamw_update`` writes the
new parameters and moments in place (the parameters are autograd leaves the
next step differentiates again), which saves a copy of every tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(c: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to min_lr_ratio * lr."""
    if step < c.warmup_steps:
        return c.lr * step / max(c.warmup_steps, 1)
    prog = min(max((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1), 0.0), 1.0)
    return c.lr * (c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(c: AdamWConfig, params: Any, grads: Any, opt: dict) -> dict:
    """One AdamW step in place; returns metrics {"grad_norm", "lr"}."""
    opt["step"] += 1
    step = opt["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) if c.grad_clip else 1.0
    lr = lr_at(c, step)
    b1t = 1 - c.b1**step
    b2t = 1 - c.b2**step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        g = g.to(torch.float32) * scale
        m.mul_(c.b1).add_((1 - c.b1) * g)
        v.mul_(c.b2).add_((1 - c.b2) * g * g)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * ((m / b1t) / (torch.sqrt(v / b2t) + c.eps) + c.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
