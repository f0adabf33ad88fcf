"""AdamW with linear warmup + cosine decay, on dicts of tensors.

Optimizer state mirrors the params tree: {"m": ..., "v": ...} in f32 plus a
0-d int32 ``step`` tensor on the parameters' device, as the reference's, so a
checkpoint holds it as a leaf.  Unlike the reference's pure update,
``adamw_update`` writes the new parameters, moments and step in place, which
saves a copy of every tensor.  The schedule and bias corrections are
computed from the step tensor in f32, as the reference computes them, so a
step on the card reads nothing back to the host.

Over ranks (a ruled train step) every leaf is a DTensor and the update runs
on each rank's local shards in place, with no DTensor op: the global norm
sums each leaf's squares over the mesh axes that split it (one sum for all
the leaves split alike), so an element held whole on many ranks counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.common import is_dtensor, local, tree_leaves, tree_map


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


def lr_at(c: AdamWConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    prog = torch.clamp((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """The 2-norm of every element of the tree in f32; over ranks from the
    local shards, their squares summed over the axes that split each leaf."""
    leaves = tree_leaves(tree)
    if not any(is_dtensor(x) for x in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))
    from ..sharding.rules import all_sum

    groups: dict = {}
    for x in leaves:
        names = x.device_mesh.mesh_dim_names
        axes = tuple(names[i] for i, p in enumerate(x.placements) if p.is_shard())
        square = torch.sum(torch.square(local(x).to(torch.float32)))
        groups[axes] = (x.device_mesh, groups[axes][1] + square if axes in groups else square)
    return torch.sqrt(sum(all_sum(sq, mesh, axes) for axes, (mesh, sq) in sorted(groups.items())))


@torch.no_grad()
def adamw_update(c: AdamWConfig, params: Any, grads: Any, opt: dict) -> dict:
    """One AdamW step in place; returns metrics {"grad_norm", "lr"} (0-d f32
    tensors)."""
    local(opt["step"]).add_(1)
    step = local(opt["step"]).to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) if c.grad_clip else 1.0
    lr = lr_at(c, step)
    b1t = 1 - c.b1**step
    b2t = 1 - c.b2**step
    for p, g, m, v in zip(*(map(local, tree_leaves(t)) for t in (params, grads, opt["m"], opt["v"]))):
        g = g.to(torch.float32) * scale
        m.mul_(c.b1).add_((1 - c.b1) * g)
        v.mul_(c.b2).add_((1 - c.b2) * g * g)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * ((m / b1t) / (torch.sqrt(v / b2t) + c.eps) + c.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
