"""The "NPU variant" factory: int8 fake-quantization of model weights.

FastVA's phone NPU runs CNNs in 8/16-bit and loses accuracy in a
model-dependent way (paper §III.A).  Every classifier gets a quantized
variant whose error is real int8 round-off — symmetric per output channel,
the scheme of the int8 kernel's weight operand — so the scheduler's
accuracy/latency tradeoff rests on actual arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.common import ParamSpec, tree_leaves, tree_map


@dataclasses.dataclass
class QuantStats:
    leaves_quantized: int = 0
    leaves_kept: int = 0
    mean_rel_err: float = 0.0
    max_rel_err: float = 0.0


def _out_axis(w: torch.Tensor, spec: ParamSpec) -> int:
    """Output-channel axis, decided by the leaf's spec: O of a conv weight
    ``[..., O, I, KH, KW]`` (a leading axis stacks repeated blocks; a
    depthwise ``[L, C, 1, k, k]`` is per C), and the last axis of every other
    leaf, whatever its rank (ViT's stacked ``wq [L, d, H, hd]`` per ``hd``,
    Swin's ``rel_bias [L, (2w-1)², heads]`` per head, a stacked BN scale or
    SE bias ``[L, C]`` per C), as in the reference."""
    return w.dim() - 4 if spec.init == "conv" else w.dim() - 1


def _fake_quant(w: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
    """Symmetric per-output-channel int8 quantize-dequantize.  The amax runs
    over every other axis, stacked layers included — the same values the
    reference reduces over in its HWIO layout, so the scales are identical."""
    w32 = w.to(torch.float32)
    ax = _out_axis(w, spec)
    amax = w32.abs().amax(dim=[d for d in range(w.dim()) if d != ax], keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return (q * scale).to(w.dtype)


def fake_quant_tree(params: Any, specs: Any, *, min_ndim: int = 2) -> Any:
    """Quantize every floating leaf with ndim >= min_ndim (weights); biases and
    norm scales stay exact, matching real NPU toolchains.  ``specs`` is the
    params' spec tree (``arch.abstract_params(arch)[0]``): it says which
    leaves are convolutions."""

    def q(x, s):
        if x.is_floating_point() and x.dim() >= min_ndim:
            return _fake_quant(x, s)
        return x

    with torch.no_grad():
        return tree_map(q, params, specs)


def quant_error_stats(params: Any, qparams: Any) -> QuantStats:
    stats = QuantStats()
    rels = []
    for a, b in zip(tree_leaves(params), tree_leaves(qparams)):
        if not a.is_floating_point():
            stats.leaves_kept += 1  # int/bool leaves pass through unquantized
            continue
        if a.shape == b.shape and bool(torch.any(a != b)):
            denom = float(torch.linalg.norm(a.to(torch.float32))) or 1.0
            rels.append(float(torch.linalg.norm((a - b).to(torch.float32))) / denom)
            stats.leaves_quantized += 1
        else:
            stats.leaves_kept += 1
    if rels:
        stats.mean_rel_err = sum(rels) / len(rels)
        stats.max_rel_err = max(rels)
    return stats


def npu_variant(params: Any, specs: Any) -> tuple[Any, QuantStats]:
    """The deployable NPU-path weights: int8 fake-quant + stats."""
    q = fake_quant_tree(params, specs)
    return q, quant_error_stats(params, q)


@torch.no_grad()
def agreement(
    forward: Callable[[Any, torch.Tensor], torch.Tensor],
    params_fp: Any,
    params_q: Any,
    inputs: torch.Tensor,
) -> float:
    """Top-1 agreement between full-precision and quantized variants — the
    measurable analogue of the paper's NPU accuracy drop (Fig. 1b)."""
    a = torch.argmax(forward(params_fp, inputs), dim=-1)
    b = torch.argmax(forward(params_q, inputs), dim=-1)
    return float((a == b).to(torch.float32).mean())
