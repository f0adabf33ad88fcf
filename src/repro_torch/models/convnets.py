"""Convolutional classifiers: ResNet-50, EfficientNet and SqueezeNet.

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

Under an active matmul backend every conv with ``groups == 1`` lowers to one
GEMM (``_conv_via_matmul``); a depthwise conv stays a plain grouped conv in
both variants, as in the reference.

Under mesh rules (``launch/steps.build_cell(..., rules=)``, a
``classify_serve`` step over ``torch.distributed`` ranks) the images and
weights are DTensors and each rank computes on its local shards: the batch
on ``data``; each conv on the rank's output channels (``conv_out`` on
``model``: dim 0 of an OIHW leaf) over its whole input channels
(``conv_in`` is None), BatchNorm and the SE biases on the leaves' slices
of those channels, a depthwise conv on the rank's own channels; an
activation split on channels is gathered (``rules.all_gather``) where a
conv reads it whole.  A leaf whose width the ``model`` extent does not
divide stays whole, and the activations follow each leaf as it resolves
(``_laid``).  The logits come back split over ``vocab``.  A training
forward over ranks takes BatchNorm's statistics over the whole batch (one
sum of the ranks' sums over the batch's mesh axes for the mean, one for the
variance) and writes the running state whole on every rank; under autograd
a whole tensor cut to the rank's channels has its gradient summed over the
channels' axes (``rules.grad_sum``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..sharding.rules import all_gather, all_sum, grad_sum
from .common import (cast, current_matmul, kept, like, local, local_slice, matmul, mesh_of, on_mesh, rows_like, shard,
                     spec, stack_specs, tree_map, unstack_tree, used_on)

BN_MOMENTUM = 0.9


def conv_spec(kh, kw, cin, cout, name_in="conv_in", name_out="conv_out"):
    return spec((cout, cin, kh, kw), (name_out, name_in, None, None), init="conv")


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


def conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with OIHW ``w`` (cast to x's dtype); a
    depthwise conv has ``groups`` = channels and ``w`` [C, 1, KH, KW]."""
    if current_matmul() is not None and groups == 1:
        return _conv_via_matmul(w, x, stride)
    kh, kw = w.shape[2:]
    return F.conv2d(_pad_same(x, kh, kw, stride), cast(w, x.dtype), stride=stride, groups=groups)


def _conv_via_matmul(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """im2col lowering: the conv as ONE [B*H'*W', Cin*KH*KW] x [., Cout] GEMM
    through the active matmul backend — how NPUs (and the int8 kernel path)
    execute convolutions.  Rows are ordered (b, h', w') and patch columns
    (cin, kh, kw) with Cin slowest, the reference's patch order; the stride-2
    1x1 projection takes the patches branch, as in the reference."""
    cout, cin, kh, kw = w.shape
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
    out = matmul(rows, w.reshape(cout, -1).t())  # matmul casts w to x's dtype
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


def batchnorm(p, s, x, train: bool, eps=1e-5, rows: tuple = (None, ())):
    """Returns (y, new_state); statistics over (batch, H, W) in f32.  In
    eval the terms drawn from the leaves are ``kept``.  ``rows`` (a
    ``DeviceMesh`` and the mesh axes that split the batch) makes a training
    forward's statistics the whole batch's: the mean from the ranks' sums,
    then the biased variance from their sums of squared deviations from it
    (two passes, as ``jnp.var``)."""
    x32 = x.to(torch.float32)
    mesh, axes = rows
    if train and axes:
        n = x32.numel() // x32.shape[1] * math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)

        def total(t):  # the whole batch's sum, used on this rank's rows
            return grad_sum(all_sum(t.sum(dim=(0, 2, 3)), mesh, axes), mesh, axes)

        mean = total(x32) / n
        var = total(torch.square(x32 - mean[:, None, None])) / n
    elif train:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), unbiased=False)
    if train:
        with torch.no_grad():
            new_s = {
                "mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var,
            }
        shift, inv, bias = _bn_terms(p["scale"], p["bias"], mean, var, eps)
    else:
        new_s = s
        shift, inv, bias = kept(("bn", eps), lambda *t: _bn_terms(*t, eps, copy=True),
                                p["scale"], p["bias"], s["mean"], s["var"])
    y = (x32 - shift) * inv + bias
    return y.to(x.dtype), new_s


def _bn_terms(scale, bias, mean, var, eps, copy=False):
    """BatchNorm's (shift, scale, bias) in f32 as [C, 1, 1], y = (x - shift)
    * scale + bias; with ``copy`` none of them is a view of a leaf."""
    inv = torch.rsqrt(var + eps) * scale.to(torch.float32)
    return (mean.to(torch.float32, copy=copy)[:, None, None], inv[:, None, None],
            bias.to(torch.float32, copy=copy)[:, None, None])


def maxpool(x, window=3, stride=2):
    return F.max_pool2d(_pad_same(x, window, window, stride, value=float("-inf")), window, stride)


def _bias(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel bias as it adds to NCHW ``x``."""
    return cast(b, x.dtype)[:, None, None]


# ---------------------------------------------------------------------------
# Channels over ranks.  A layout is (slice of the channels held, mesh axes
# that split them, the DeviceMesh); ``()`` axes: the whole.  On one card
# every layout is whole and these helpers are identities.
# ---------------------------------------------------------------------------


def _out(w) -> tuple:
    """The layout of the output channels of OIHW conv weight ``w`` (dim 0)."""
    return *local_slice(w, 0), mesh_of(w)


def _whole(x: torch.Tensor) -> tuple:
    return slice(0, x.shape[1]), (), None


def _gathered(x: torch.Tensor, have) -> torch.Tensor:
    """``x`` (layout ``have``) with its channels whole."""
    return all_gather(x, 1, have[2], have[1])


def _laid(x: torch.Tensor, have, want) -> torch.Tensor:
    """NCHW ``x`` holding the channels of layout ``have``, as layout
    ``want``: gathered over ``have``'s axes, then cut to ``want``'s slice."""
    if have[:2] == want[:2]:
        return x
    x = _gathered(x, have)
    return grad_sum(x, want[2], want[1])[:, want[0]] if want[1] else x


def _take(t, part) -> torch.Tensor:
    """The local part of a per-channel leaf (replicated over ranks) at the
    channels of layout ``part`` (its gradient summed over their axes)."""
    return grad_sum(local(t), part[2], part[1])[part[0]] if part[1] else local(t)


def _bn(p, s, x, part, train):
    """``batchnorm`` of ``x`` holding the channels of layout ``part``; on
    one card (no mesh) the leaves as they are, with no walk of the trees.
    ``train``: False in eval; over ranks the batch's layout (``_train``),
    and the new running state is gathered whole, laid out as ``s``."""
    if part[2] is None:
        return batchnorm(p, s, x, bool(train))
    rows = train if isinstance(train, tuple) else (None, ())
    y, new = batchnorm(*(tree_map(lambda t: _take(t, part), tree) for tree in (p, s)), x, bool(train), rows=rows)
    if train:
        new = {k: like(s[k], all_gather(v, 0, part[2], part[1])) for k, v in new.items()}
    return y, new


def _train(images, train: bool):
    """``train`` as the blocks take it: over ranks in train mode, the
    batch's layout (its ``DeviceMesh`` and the mesh axes that split its
    rows), over which BatchNorm takes its statistics."""
    return (mesh_of(images), local_slice(images, 0)[1]) if train and mesh_of(images) is not None else train


def _conv(w, x, stride: int = 1):
    """(``conv`` of whole-channel ``x`` by the rank's output channels of
    ``w``, their layout)."""
    part = _out(w)
    return conv(used_on(w), grad_sum(x, part[2], part[1]), stride=stride), part


def _conv_bias(p, x, stride: int = 1):
    """``_conv`` by ``p["w"]`` plus ``p["b"]`` on the rank's output
    channels."""
    y, part = _conv(p["w"], x, stride)
    return y + _bias(_take(p["b"], part), x), part


def _inputs(images) -> torch.Tensor:
    """The local NCHW bf16 images."""
    return local(images).to(torch.bfloat16).permute(0, 3, 1, 2)


def _stage_end(x: torch.Tensor, images) -> torch.Tensor:
    """The reference's ``shard(x, "batch", None, None, None)`` at a stage's
    end, channels whole, on the local NCHW ``x``."""
    return local(shard(rows_like(images, x), "batch", None, None, None))


def _logits(p, images, h) -> torch.Tensor:
    """The head on pooled whole-channel features ``h``: f32 logits, over
    ranks a DTensor of the rank's ``vocab`` columns."""
    vocab = local_slice(p["w"], 1)[1]
    logits = matmul(grad_sum(h, mesh_of(p["w"]), vocab), used_on(p["w"])) + local(p["b"]).to(h.dtype)
    return on_mesh(logits.to(torch.float32), mesh_of(images), {0: local_slice(images, 0)[1], 1: vocab})


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
            params[f"stage{i}_rest"] = stack_specs(_bottleneck_specs(cout, cmid, cout, 1), depth - 1)
            state[f"stage{i}_rest"] = stack_specs(_bottleneck_state(cout, cmid, cout, 1), depth - 1)
        cin = cout
    params["head"] = {
        "w": spec((cin, c.n_classes), ("embed", "vocab")),
        "b": spec((c.n_classes,), ("vocab",), init="zeros"),
    }
    return params, state


def _bottleneck(p, s, x, stride, train):
    """x (channels whole) -> (output, channels whole; new state)."""
    ns = {}
    h, part = _conv(p["conv1"], x)
    h, ns["bn1"] = _bn(p["bn1"], s["bn1"], h, part, train)
    h, part = _conv(p["conv2"], _gathered(F.relu(h), part), stride)
    h, ns["bn2"] = _bn(p["bn2"], s["bn2"], h, part, train)
    h, part = _conv(p["conv3"], _gathered(F.relu(h), part))
    h, ns["bn3"] = _bn(p["bn3"], s["bn3"], h, part, train)
    if "proj" in p:
        sc, sc_part = _conv(p["proj"], x, stride)
        sc, ns["bn_proj"] = _bn(p["bn_proj"], s["bn_proj"], sc, sc_part, train)
        sc = _laid(sc, sc_part, part)
    else:
        sc = _laid(x, _whole(x), part)
    return _gathered(F.relu(h + sc), part), ns


def _restack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _restack([t[k] for t in trees]) for k in trees[0]}
    return like(trees[0], torch.stack([local(t) for t in trees]))


def resnet_forward(c: ResNetConfig, params, state, images, *, train: bool = False):
    x, train = _inputs(images), _train(images, train)
    ns: dict = {"stem": {}}
    x, part = _conv(params["stem"]["conv"], x, stride=2)
    x, ns["stem"]["bn"] = _bn(params["stem"]["bn"], state["stem"]["bn"], x, part, train)
    x = _gathered(maxpool(F.relu(x)), part)
    for i, depth in enumerate(c.depths):
        stride = 1 if i == 0 else 2
        x, ns[f"stage{i}_first"] = _bottleneck(
            params[f"stage{i}_first"], state[f"stage{i}_first"], x, stride, train
        )
        if depth > 1:
            rest_p, rest_s = params[f"stage{i}_rest"], state[f"stage{i}_rest"]
            new_states = []
            for blk_p, blk_s in zip(unstack_tree(rest_p), unstack_tree(rest_s)):
                x, s2 = _bottleneck(blk_p, blk_s, x, 1, train)
                new_states.append(s2)
            ns[f"stage{i}_rest"] = _restack(new_states)
        x = _stage_end(x, images)
    return _logits(params["head"], images, x.mean(dim=(2, 3))), ns


# ---------------------------------------------------------------------------
# EfficientNet (B0 base scaled by width/depth multipliers; B7 = 2.0 / 3.1)
# ---------------------------------------------------------------------------

EFFNET_B0_BLOCKS = (  # (expand, channels, repeats, stride, kernel)
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _round_filters(ch: float, mult: float, divisor: int = 8) -> int:
    ch *= mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return int(new)


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    name: str
    width_mult: float = 1.0
    depth_mult: float = 1.0
    n_classes: int = 1000
    se_ratio: float = 0.25

    def stages(self):
        """(expand, channels, repeats, stride, kernel) of each stage."""
        return [
            (expand, _round_filters(ch, self.width_mult), int(math.ceil(reps * self.depth_mult)), stride, k)
            for expand, ch, reps, stride, k in EFFNET_B0_BLOCKS
        ]

    @property
    def stem_ch(self) -> int:
        return _round_filters(32, self.width_mult)

    @property
    def head_ch(self) -> int:
        return _round_filters(1280, self.width_mult)


def _mbconv_specs(cin, cout, expand, k, se_ratio):
    cmid = cin * expand
    s: dict = {}
    if expand != 1:
        s["expand"] = conv_spec(1, 1, cin, cmid)
        s["bn_e"] = bn_specs(cmid)
    s["dw"] = spec((cmid, 1, k, k), ("conv_out", None, None, None), init="conv")
    s["bn_d"] = bn_specs(cmid)
    cse = max(1, int(cin * se_ratio))  # from the block's input width, as in the reference
    s["se_r"] = {"w": conv_spec(1, 1, cmid, cse), "b": spec((cse,), (None,), init="zeros")}
    s["se_e"] = {"w": conv_spec(1, 1, cse, cmid), "b": spec((cmid,), (None,), init="zeros")}
    s["project"] = conv_spec(1, 1, cmid, cout)
    s["bn_p"] = bn_specs(cout)
    return s


def _mbconv_state(cin, cout, expand):
    cmid = cin * expand
    s: dict = {"bn_d": bn_state_specs(cmid), "bn_p": bn_state_specs(cout)}
    if expand != 1:
        s["bn_e"] = bn_state_specs(cmid)
    return s


def effnet_abstract(c: EfficientNetConfig) -> tuple[dict, dict]:
    params: dict = {"stem": {"conv": conv_spec(3, 3, 3, c.stem_ch), "bn": bn_specs(c.stem_ch)}}
    state: dict = {"stem": {"bn": bn_state_specs(c.stem_ch)}}
    cin = c.stem_ch
    for i, (expand, cout, reps, stride, k) in enumerate(c.stages()):
        params[f"stage{i}_first"] = _mbconv_specs(cin, cout, expand, k, c.se_ratio)
        state[f"stage{i}_first"] = _mbconv_state(cin, cout, expand)
        if reps > 1:
            params[f"stage{i}_rest"] = stack_specs(_mbconv_specs(cout, cout, expand, k, c.se_ratio), reps - 1)
            state[f"stage{i}_rest"] = stack_specs(_mbconv_state(cout, cout, expand), reps - 1)
        cin = cout
    params["head_conv"] = {"conv": conv_spec(1, 1, cin, c.head_ch), "bn": bn_specs(c.head_ch)}
    state["head_conv"] = {"bn": bn_state_specs(c.head_ch)}
    params["head"] = {
        "w": spec((c.head_ch, c.n_classes), ("embed", "vocab")),
        "b": spec((c.n_classes,), ("vocab",), init="zeros"),
    }
    return params, state


def _mbconv(p, s, x, stride, train):
    """expand -> BN -> SiLU -> depthwise -> BN -> SiLU -> squeeze-excite ->
    project -> BN, plus the input where stride is 1 and the widths match.
    Each 1x1 SE conv acts on [B, C, 1, 1]: one M = B GEMM under a backend.
    Over ranks x comes and goes with its channels whole; the depthwise conv
    runs on the rank's channels of the expansion (``dw``'s slice)."""
    ns: dict = {}
    h, part = x, _whole(x)
    if "expand" in p:
        h, part = _conv(p["expand"], h)
        h, ns["bn_e"] = _bn(p["bn_e"], s["bn_e"], h, part, train)
        h = F.silu(h)
    dw = _out(p["dw"])
    h = _laid(h, part, dw)
    h = conv(local(p["dw"]), h, stride=stride, groups=h.shape[1])
    h, ns["bn_d"] = _bn(p["bn_d"], s["bn_d"], h, dw, train)
    h = F.silu(h)
    z = _gathered(h.mean(dim=(2, 3), keepdim=True), dw)  # squeeze-and-excitation
    z, part = _conv_bias(p["se_r"], z)
    z, part = _conv_bias(p["se_e"], _gathered(F.silu(z), part))
    h = _gathered(h * _laid(torch.sigmoid(z), part, dw), dw)
    h, part = _conv(p["project"], h)
    h, ns["bn_p"] = _bn(p["bn_p"], s["bn_p"], h, part, train)
    if stride == 1 and x.shape[1] == p["project"].shape[0]:
        h = h + _laid(x, _whole(x), part)
    return _gathered(h, part), ns


def effnet_forward(c: EfficientNetConfig, params, state, images, *, train: bool = False):
    x, train = _inputs(images), _train(images, train)
    ns: dict = {"stem": {}, "head_conv": {}}
    x, part = _conv(params["stem"]["conv"], x, stride=2)
    x, ns["stem"]["bn"] = _bn(params["stem"]["bn"], state["stem"]["bn"], x, part, train)
    x = _gathered(F.silu(x), part)
    for i, (_, _, reps, stride, _) in enumerate(c.stages()):
        x, ns[f"stage{i}_first"] = _mbconv(params[f"stage{i}_first"], state[f"stage{i}_first"], x, stride, train)
        if reps > 1:
            rest_p, rest_s = params[f"stage{i}_rest"], state[f"stage{i}_rest"]
            new_states = []
            for blk_p, blk_s in zip(unstack_tree(rest_p), unstack_tree(rest_s)):
                x, s2 = _mbconv(blk_p, blk_s, x, 1, train)
                new_states.append(s2)
            ns[f"stage{i}_rest"] = _restack(new_states)
        x = _stage_end(x, images)
    x, part = _conv(params["head_conv"]["conv"], x)
    x, ns["head_conv"]["bn"] = _bn(params["head_conv"]["bn"], state["head_conv"]["bn"], x, part, train)
    h = _gathered(F.silu(x).mean(dim=(2, 3)), part)
    return _logits(params["head"], images, h), ns


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


def _fire(p, x):
    s, part = _conv_bias(p["squeeze"], x)
    s = _gathered(F.relu(s), part)
    e1, e3 = (_gathered(*_conv_bias(p[k], s)) for k in ("e1", "e3"))
    return F.relu(torch.cat([e1, e3], dim=1))


def squeezenet_forward(c: SqueezeNetConfig, params, state, images, *, train: bool = False):
    x = _inputs(images)
    x, part = _conv_bias(params["stem"], x, stride=2)
    x = _gathered(F.relu(x), part)
    for gi, group in enumerate(FIRE_CFG):
        x = maxpool(x)
        for fi, _ in enumerate(group):
            x = _fire(params[f"fire{gi}_{fi}"], x)
    x, part = _conv_bias(params["classifier"], x)
    logits = F.relu(x).mean(dim=(2, 3)).to(torch.float32)  # over ranks: the rank's classes
    return on_mesh(logits, mesh_of(images), {0: local_slice(images, 0)[1], 1: part[1]}), {}
