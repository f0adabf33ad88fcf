"""Convolutional classifiers: ResNet-50 and SqueezeNet.

Layouts: images come in NHWC ``[B, H, W, 3]`` (the reference's public layout);
activations run NCHW inside, and conv weights are OIHW.  Both forwards cast
images to bf16 as the reference does, so the full-precision "edge" variant
computes in bf16 and BatchNorm normalizes in f32 and casts back.

BatchNorm models carry a separate ``state`` tree (running mean/var);
``forward(..., train=True)`` returns (logits, new_state).  Repeated identical
blocks keep the reference's stacked ``*_rest`` parameters (leading "layers"
axis) and loop over that axis in place of ``lax.scan``.

Padding follows XLA's ``SAME`` rule, which is asymmetric under stride 2
(the 7x7/2 stem on 224 pads 2 before and 3 after), so every conv and pool
pads explicitly with ``F.pad`` and then runs unpadded.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import current_matmul, matmul, shard, spec

BN_MOMENTUM = 0.9


def conv_spec(kh, kw, cin, cout, name_in="conv_in", name_out="conv_out"):
    return spec((cout, cin, kh, kw), (name_out, name_in, None, None), init="conv")


def _stack(specs, n: int):
    """Add a leading 'layers' dim to every spec in the tree."""
    if isinstance(specs, dict):
        return {k: _stack(v, n) for k, v in specs.items()}
    return dataclasses.replace(specs, shape=(n, *specs.shape), axes=("layers", *specs.axes))


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's SAME rule along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int, value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with OIHW ``w`` (cast to x's dtype)."""
    if current_matmul() is not None:
        return _conv_via_matmul(w, x, stride)
    kh, kw = w.shape[2:]
    return F.conv2d(_pad_same(x, kh, kw, stride), w.to(x.dtype), stride=stride)


def _conv_via_matmul(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """im2col lowering: the conv as ONE [B*H'*W', Cin*KH*KW] x [., Cout] GEMM
    through the active matmul backend — how NPUs (and the int8 kernel path)
    execute convolutions.  Rows are ordered (b, h', w') and patch columns
    (cin, kh, kw) with Cin slowest, the reference's patch order; the stride-2
    1x1 projection takes the patches branch, as in the reference."""
    cout, cin, kh, kw = w.shape
    w = w.to(x.dtype)
    B = x.shape[0]
    if (kh, kw) == (1, 1) and stride == 1:  # pointwise: a matmul over channels
        H, W = x.shape[2:]
        rows = x.permute(0, 2, 3, 1).reshape(-1, cin)
    else:
        xp = _pad_same(x, kh, kw, stride)
        H = (xp.shape[2] - kh) // stride + 1
        W = (xp.shape[3] - kw) // stride + 1
        cols = F.unfold(xp, (kh, kw), stride=stride)  # [B, Cin*KH*KW, H'*W']
        rows = cols.transpose(1, 2).reshape(-1, cin * kh * kw)
    out = matmul(rows, w.reshape(cout, -1).t())
    return out.reshape(B, H, W, cout).permute(0, 3, 1, 2)


def bn_specs(ch):
    return {
        "scale": spec((ch,), ("channels",), init="ones"),
        "bias": spec((ch,), ("channels",), init="zeros"),
    }


def bn_state_specs(ch):
    return {
        "mean": spec((ch,), ("channels",), init="zeros"),
        "var": spec((ch,), ("channels",), init="ones"),
    }


def batchnorm(p, s, x, train: bool, eps=1e-5):
    """Returns (y, new_state); statistics over (batch, H, W) in f32."""
    x32 = x.to(torch.float32)
    if train:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            new_s = {
                "mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var,
            }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    y = (x32 - mean[:, None, None]) * inv[:, None, None] + p["bias"].to(torch.float32)[:, None, None]
    return y.to(x.dtype), new_s


def maxpool(x, window=3, stride=2):
    return F.max_pool2d(_pad_same(x, window, window, stride, value=float("-inf")), window, stride)


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depths: tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    n_classes: int = 1000
    expansion: int = 4


def _bottleneck_specs(cin, cmid, cout, stride):
    s = {
        "conv1": conv_spec(1, 1, cin, cmid),
        "bn1": bn_specs(cmid),
        "conv2": conv_spec(3, 3, cmid, cmid),
        "bn2": bn_specs(cmid),
        "conv3": conv_spec(1, 1, cmid, cout),
        "bn3": bn_specs(cout),
    }
    if stride != 1 or cin != cout:
        s["proj"] = conv_spec(1, 1, cin, cout)
        s["bn_proj"] = bn_specs(cout)
    return s


def _bottleneck_state(cin, cmid, cout, stride):
    s = {"bn1": bn_state_specs(cmid), "bn2": bn_state_specs(cmid), "bn3": bn_state_specs(cout)}
    if stride != 1 or cin != cout:
        s["bn_proj"] = bn_state_specs(cout)
    return s


def resnet_abstract(c: ResNetConfig) -> tuple[dict, dict]:
    params: dict = {"stem": {"conv": conv_spec(7, 7, 3, c.width), "bn": bn_specs(c.width)}}
    state: dict = {"stem": {"bn": bn_state_specs(c.width)}}
    cin = c.width
    for i, depth in enumerate(c.depths):
        cmid = c.width * (2**i)
        cout = cmid * c.expansion
        stride = 1 if i == 0 else 2
        params[f"stage{i}_first"] = _bottleneck_specs(cin, cmid, cout, stride)
        state[f"stage{i}_first"] = _bottleneck_state(cin, cmid, cout, stride)
        if depth > 1:
            params[f"stage{i}_rest"] = _stack(_bottleneck_specs(cout, cmid, cout, 1), depth - 1)
            state[f"stage{i}_rest"] = _stack(_bottleneck_state(cout, cmid, cout, 1), depth - 1)
        cin = cout
    params["head"] = {
        "w": spec((cin, c.n_classes), ("embed", "vocab")),
        "b": spec((c.n_classes,), ("vocab",), init="zeros"),
    }
    return params, state


def _bottleneck(p, s, x, stride, train):
    ns = {}
    h, ns["bn1"] = batchnorm(p["bn1"], s["bn1"], conv(p["conv1"], x), train)
    h = F.relu(h)
    h, ns["bn2"] = batchnorm(p["bn2"], s["bn2"], conv(p["conv2"], h, stride=stride), train)
    h = F.relu(h)
    h, ns["bn3"] = batchnorm(p["bn3"], s["bn3"], conv(p["conv3"], h), train)
    if "proj" in p:
        sc, ns["bn_proj"] = batchnorm(p["bn_proj"], s["bn_proj"], conv(p["proj"], x, stride=stride), train)
    else:
        sc = x
    return F.relu(h + sc), ns


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _restack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _restack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def resnet_forward(c: ResNetConfig, params, state, images, *, train: bool = False):
    x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
    ns: dict = {"stem": {}}
    x = conv(params["stem"]["conv"], x, stride=2)
    x, ns["stem"]["bn"] = batchnorm(params["stem"]["bn"], state["stem"]["bn"], x, train)
    x = maxpool(F.relu(x))
    for i, depth in enumerate(c.depths):
        stride = 1 if i == 0 else 2
        x, ns[f"stage{i}_first"] = _bottleneck(
            params[f"stage{i}_first"], state[f"stage{i}_first"], x, stride, train
        )
        if depth > 1:
            rest_p, rest_s = params[f"stage{i}_rest"], state[f"stage{i}_rest"]
            new_states = []
            for layer in range(depth - 1):
                x, s2 = _bottleneck(_index(rest_p, layer), _index(rest_s, layer), x, 1, train)
                new_states.append(s2)
            ns[f"stage{i}_rest"] = _restack(new_states)
        x = shard(x, "batch", None, None, None)
    h = x.mean(dim=(2, 3))
    logits = matmul(h, params["head"]["w"].to(h.dtype)) + params["head"]["b"].to(h.dtype)
    return logits.to(torch.float32), ns


# ---------------------------------------------------------------------------
# SqueezeNet v1.1 (the paper's compact model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SqueezeNetConfig:
    name: str = "squeezenet"
    n_classes: int = 1000


FIRE_CFG = (  # (squeeze, expand) after each pool stage
    ((16, 64), (16, 64)),
    ((32, 128), (32, 128)),
    ((48, 192), (48, 192), (64, 256), (64, 256)),
)


def _fire_specs(cin, sq, ex):
    return {
        "squeeze": {"w": conv_spec(1, 1, cin, sq), "b": spec((sq,), (None,), init="zeros")},
        "e1": {"w": conv_spec(1, 1, sq, ex), "b": spec((ex,), (None,), init="zeros")},
        "e3": {"w": conv_spec(3, 3, sq, ex), "b": spec((ex,), (None,), init="zeros")},
    }


def squeezenet_abstract(c: SqueezeNetConfig) -> tuple[dict, dict]:
    params: dict = {
        "stem": {"w": conv_spec(3, 3, 3, 64), "b": spec((64,), (None,), init="zeros")}
    }
    cin = 64
    for gi, group in enumerate(FIRE_CFG):
        for fi, (sq, ex) in enumerate(group):
            params[f"fire{gi}_{fi}"] = _fire_specs(cin, sq, ex)
            cin = 2 * ex
    params["classifier"] = {
        "w": conv_spec(1, 1, cin, c.n_classes),
        "b": spec((c.n_classes,), (None,), init="zeros"),
    }
    return params, {}


def _bias(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return b.to(x.dtype)[:, None, None]


def _fire(p, x):
    s = F.relu(conv(p["squeeze"]["w"], x) + _bias(p["squeeze"]["b"], x))
    e1 = conv(p["e1"]["w"], s) + _bias(p["e1"]["b"], x)
    e3 = conv(p["e3"]["w"], s) + _bias(p["e3"]["b"], x)
    return F.relu(torch.cat([e1, e3], dim=1))


def squeezenet_forward(c: SqueezeNetConfig, params, state, images, *, train: bool = False):
    x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
    x = F.relu(conv(params["stem"]["w"], x, stride=2) + _bias(params["stem"]["b"], x))
    for gi, group in enumerate(FIRE_CFG):
        x = maxpool(x)
        for fi, _ in enumerate(group):
            x = _fire(params[f"fire{gi}_{fi}"], x)
    x = conv(params["classifier"]["w"], x) + _bias(params["classifier"]["b"], x)
    logits = F.relu(x).mean(dim=(2, 3))
    return logits.to(torch.float32), {}
