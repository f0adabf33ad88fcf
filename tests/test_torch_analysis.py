"""The port's roofline analysis (``launch/analysis``: a counting
``TorchDispatchMode`` over a step run on ``meta`` tensors) against the
reference's jaxpr walk, test for test with ``tests/test_analysis.py``, on the
same shapes.

Matmul and convolution FLOPs are held exactly equal to the reference's
``dot_general`` and ``conv_general_dilated`` FLOPs (``_walk_sites``); totals
exactly where every op has one counterpart (a product and a ``tanh`` per
layer).  The helpers at the top are shared with the per-family dry-run
files, ``test_torch_dryrun_{lm,diffusion,vision}.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import sys

from test_torch_ref import CPU, REPO  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.utils.checkpoint import checkpoint

from repro import configs as jconfigs
from repro.launch import analysis as janalysis
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models.common import abstract_tree as jabstract_tree
from repro.train.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs
from repro_torch.arch import n_params as A_n_params
from repro_torch.launch import analysis, dryrun
from repro_torch.models import convnets
from repro_torch.models import layers as L

DOT_PRIMS = ("dot_general", "conv_general_dilated")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def ref_dot_flops(closed) -> float:
    """The reference's matmul and convolution FLOPs in a closed jaxpr."""
    sites: dict = {}
    janalysis._walk_sites(closed, 1.0, sites)
    return sum(f for (prim, _), (_, f, _) in sites.items() if prim in DOT_PRIMS)


@functools.cache
def ref_cell(name: str, shape: str, kv_quant: bool = False) -> tuple[float, janalysis.Costs]:
    """(matmul + conv FLOPs, traced costs) of the reference's SMOKE cell."""
    arch = jconfigs.get(name, smoke=True)
    if kv_quant:
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, kv_quant=True))
    prog = jsteps.build_cell(arch, shape, adamw=JAdamWConfig())
    closed = jax.make_jaxpr(prog.fn)(*prog.abstract_args())
    costs = janalysis.jaxpr_costs(closed)
    costs.bytes += sum(janalysis._bytes_of(v.aval) for v in closed.jaxpr.invars)
    return ref_dot_flops(closed), costs


@functools.cache
def port_cell(name: str, shape: str, kv_quant: bool = False) -> dict:
    """The port's dry-run record of its SMOKE cell."""
    return dryrun.run_cell(name, shape, out_dir=None, kv_quant=kv_quant, smoke=True)


def family_cells(families: tuple[str, ...]) -> list[tuple[str, str]]:
    return [(n, s) for n, s in configs.cells() if configs.get(n).family in families]


# Bands of the port's totals over the reference's, from all 40 SMOKE cells
# (min-max read there: FLOPs 0.902-0.993, bytes 0.431-1.269).  FLOPs: the
# matmuls and convolutions are equal, and the rest is one FLOP an output
# element on both sides, but a jaxpr spells softmax, the norms and GELU as
# several elementwise equations where aten has fewer ops: the port is never
# above.  Bytes: views count nothing in the port (aten's einsum wraps every
# product in several), while the reference counts its transposes,
# broadcasts and converts, which its autodiff adds many of: training cells
# read 0.43-0.55.  Decode reads above 1, up to 1.27: the port's einsum
# copies the permuted K and V cache of each layer (the copies chip_smoke
# measures), where a ``dot_general`` reads the cache in place.
FLOPS_BAND = (0.85, 1.0)
BYTES_BAND = (0.35, 1.5)
# Families whose steps reach the flash kernel's path (``layers._attend``,
# ``attention_decode``); Swin's window attention is inline, as the
# reference's, and the convnets have none.
KERNEL_ATTENTION = ("lm", "dit", "flux", "vit")


def check_dot_flops(name: str, shape: str, kv_quant: bool = False) -> None:
    """The port's matmul and convolution FLOPs equal the reference's."""
    ref_dot, _ = ref_cell(name, shape, kv_quant)
    got = port_cell(name, shape, kv_quant)["dot_flops"]
    assert ref_dot > 0
    assert abs(got - ref_dot) <= 1e-9 * ref_dot, (got, ref_dot)


def check_totals(name: str, shape: str) -> None:
    _, ref = ref_cell(name, shape, False)
    rec = port_cell(name, shape, False)
    flops, bytes_ = rec["flops_jaxpr"] / ref.flops, rec["bytes_jaxpr"] / ref.bytes
    print(f"{name}/{shape}: FLOPs port/reference {flops:.4f}, bytes {bytes_:.4f}")
    assert FLOPS_BAND[0] <= flops <= FLOPS_BAND[1], flops
    assert BYTES_BAND[0] <= bytes_ <= BYTES_BAND[1], bytes_
    assert rec["model_flops"] > 0 and rec["roofline"]["step_s_lower_bound"] > 0


def check_flash_bytes(name: str, shape: str, kv_quant: bool = False) -> None:
    """Flash accounting lowers the bytes of every cell whose step reaches the
    kernel's path and changes nothing elsewhere; FLOPs stay the plain trace's."""
    rec = port_cell(name, shape, kv_quant)
    m = rec["memory"]
    if configs.get(name).family in KERNEL_ATTENTION:
        assert rec["bytes_jaxpr_flash"] < rec["bytes_jaxpr"]
        assert m["flash_peak_per_device_gb"] <= m["peak_per_device_gb"]
    else:
        assert rec["bytes_jaxpr_flash"] == rec["bytes_jaxpr"]
        assert m["flash_peak_per_device_gb"] == m["peak_per_device_gb"]
    assert rec["roofline"]["compute_s"] == rec["roofline_no_flash_kernel"]["compute_s"]


REF_WORK_UNITS = """
import json, sys
sys.path[:0] = {paths!r}
import test_torch_ref  # the jax 0.9 shims
from repro import configs
from repro.arch import n_params
from repro.launch import analysis, dryrun  # sets XLA_FLAGS in this process only
out = {{}}
for name, shape in configs.cells():
    arch = configs.get(name)
    if arch.family not in {families!r}:
        continue
    s = arch.shape(shape)
    tokens, active = dryrun._tokens_of(arch, s), dryrun._active_params(arch)
    n = n_params(arch)
    out[name + "/" + shape] = [tokens, active, n, analysis.model_flops(s.kind, n, active, tokens)]
print(json.dumps(out))
"""


def reference_work_units(families: tuple[str, ...]) -> dict:
    """The reference's (tokens, active params, params, model FLOPs) of each
    full-size cell of ``families``, from one subprocess: importing its
    ``launch/dryrun`` sets ``XLA_FLAGS`` to 512 host devices."""
    code = REF_WORK_UNITS.format(paths=[str(REPO / "tests"), str(REPO / "src")], families=families)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_work_units(ref: dict, name: str, shape: str) -> None:
    arch = configs.get(name)
    s = arch.shape(shape)
    tokens, active = dryrun._tokens_of(arch, s), dryrun._active_params(arch)
    got = [tokens, active, A_n_params(arch), analysis.model_flops(s.kind, A_n_params(arch), active, tokens)]
    assert got == ref[f"{name}/{shape}"]


# ---------------------------------------------------------------------------
# tests/test_analysis.py's tests, on the port
# ---------------------------------------------------------------------------


def test_dot_flops_exact():
    c = analysis.traced_costs(lambda a, b: a @ b, meta(64, 128), meta(128, 32))
    ref = janalysis.traced_costs(lambda a, b: a @ b, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                                 jax.ShapeDtypeStruct((128, 32), jnp.float32))
    assert c.flops == 2 * 64 * 128 * 32 == ref.flops
    assert c.bytes == ref.bytes  # inputs + the product


def test_layer_loop_counts_every_layer():
    """The reference's scan over 7 layers is a loop over the stacked
    weights here: every layer's product and tanh are counted, FLOPs and
    bytes both equal to the reference's (the unbind is a view)."""

    def f(w, x):
        for wl in w.unbind(0):
            x = torch.tanh(x @ wl)
        return x

    def jf(w, x):
        h, _ = jax.lax.scan(lambda h, wl: (jnp.tanh(h @ wl), None), x, w)
        return h

    c = analysis.traced_costs(f, meta(7, 16, 16), meta(4, 16))
    ref = janalysis.traced_costs(jf, jax.ShapeDtypeStruct((7, 16, 16), jnp.float32),
                                 jax.ShapeDtypeStruct((4, 16), jnp.float32))
    assert c.flops == 7 * (2 * 4 * 16 * 16 + 4 * 16) == ref.flops
    assert c.bytes == ref.bytes


def test_remat_counts_recompute():
    """A checkpointed block's forward runs again in the backward pass and
    is counted there, as the reference counts its remat body."""

    def block(w, x):
        return torch.tanh(x @ w)

    def grad(remat):
        def fn(w, x):
            w = w.detach().requires_grad_(True)
            with torch.enable_grad():
                y = checkpoint(block, w, x, use_reentrant=False) if remat else block(w, x)
                return torch.autograd.grad(y.sum(), [w])[0]

        return analysis.trace(fn, meta(32, 32), meta(8, 32))

    g_plain, g_remat = grad(False), grad(True)
    assert g_remat.costs.flops > g_plain.costs.flops

    def jblock(w, x):
        return jnp.tanh(x @ w)

    w, x = jax.ShapeDtypeStruct((32, 32), jnp.float32), jax.ShapeDtypeStruct((8, 32), jnp.float32)
    for got, loss in ((g_plain, lambda w, x: jnp.sum(jblock(w, x))),
                      (g_remat, lambda w, x: jnp.sum(jax.checkpoint(jblock)(w, x)))):
        assert got.dot_flops == ref_dot_flops(jax.make_jaxpr(lambda w, x: jax.grad(loss)(w, x))(w, x))
    assert g_remat.dot_flops == 3 * 2 * 8 * 32 * 32  # forward, recompute, dw


def test_conv_flops():
    c = analysis.trace(lambda x, k: convnets.conv(k, x), meta(2, 3, 8, 8), meta(16, 3, 3, 3))
    closed = jax.make_jaxpr(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))(
        jax.ShapeDtypeStruct((2, 8, 8, 3), jnp.float32), jax.ShapeDtypeStruct((3, 3, 3, 16), jnp.float32))
    assert c.dot_flops == 2 * 2 * 8 * 8 * (3 * 3 * 3 * 16) == ref_dot_flops(closed)


@pytest.mark.parametrize("side", [8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_gradient_follows_reference_rule(side, stride):
    """Both gradients of a SAME conv: the weight's counts the forward's FLOPs,
    the input's counts them over the positions of the unpadded input (the
    reference's lhs-dilated transpose conv), so a stride-2 conv's input
    gradient counts about stride² the forward, at an odd side too."""

    def fn(x, k):
        x, k = (t.detach().requires_grad_(True) for t in (x, k))
        with torch.enable_grad():
            return torch.autograd.grad(convnets.conv(k, x, stride).sum(), [x, k])

    def jloss(x, k):
        return jnp.sum(jax.lax.conv_general_dilated(x, k, (stride, stride), "SAME",
                                                    dimension_numbers=("NHWC", "HWIO", "NHWC")))

    got = analysis.trace(fn, meta(2, 4, side, side), meta(8, 4, 3, 3))
    closed = jax.make_jaxpr(lambda x, k: jax.grad(jloss, argnums=(0, 1))(x, k))(
        jax.ShapeDtypeStruct((2, side, side, 4), jnp.float32), jax.ShapeDtypeStruct((3, 3, 4, 8), jnp.float32))
    assert got.dot_flops == ref_dot_flops(closed)
    out = -(-side // stride)
    forward = 2 * 2 * out * out * 3 * 3 * 4 * 8
    assert got.dot_flops == 2 * forward + 2 * 2 * side * side * 3 * 3 * 4 * 8


def test_roofline_bottleneck_classification():
    r = analysis.roofline(1e15, 1e9, {"est_seconds": 1e-6}, chips=1)
    assert r["bottleneck"] == "compute_s"
    assert r["roofline_fraction"] == 1.0
    assert r["step_s_lower_bound"] == r["compute_s"] == 1e15 / analysis.PEAK_FLOPS
    r = analysis.roofline(1e12, 1e15, {"est_seconds": 1e-6}, chips=1)
    assert r["bottleneck"] == "memory_s"
    assert r["memory_s"] == 1e15 / analysis.HBM_BW
    assert r["roofline_fraction"] < 0.1
    r = analysis.roofline(1e9, 1e9, {"est_seconds": 1.0}, chips=1)
    assert r["bottleneck"] == "collective_s"


def test_flash_accounting_reduces_bytes():
    cfg = L.AttnCfg(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    params = {k: meta(*s.shape) for k, s in L.attention_specs(cfg).items()}

    def f(p, x):
        return L.attention(cfg, p, x)[0]

    plain = analysis.trace(f, params, meta(2, 256, 64))
    with L.flash_accounting():
        flash = analysis.trace(f, params, meta(2, 256, 64))
    assert flash.costs.bytes < plain.costs.bytes * 0.8
    assert flash.peak_bytes < plain.peak_bytes

    jcfg = JL.AttnCfg(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    closed = jax.make_jaxpr(lambda p, x: JL.attention(jcfg, p, x)[0])(
        jabstract_tree(JL.attention_specs(jcfg)), jax.ShapeDtypeStruct((2, 256, 64), jnp.float32))
    assert plain.dot_flops == ref_dot_flops(closed)


def test_flash_stub_equals_reference():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 4, 8), (2, 7, 2, 8), (2, 7, 2, 8)))
    got = L._flash_stub(*(torch.tensor(a) for a in (q, k, v)))
    want = np.asarray(JL._flash_stub(*(jnp.asarray(a) for a in (q, k, v))))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_accounting_is_scoped():
    assert not L._FLASH_ACCOUNTING
    with L.flash_accounting(), L.flash_accounting():
        assert L._FLASH_ACCOUNTING == [True, True]
    assert not L._FLASH_ACCOUNTING


# ---------------------------------------------------------------------------
# What the port adds: memory, collectives, sites
# ---------------------------------------------------------------------------


def test_peak_counts_bytes_alive_at_once():
    """Arguments, then each op's output while its inputs still live; a value
    dropped is freed, so a loop holds two activations, not all of them."""

    def fn(x, w):
        y = x @ w
        z = torch.tanh(y)
        return z.sum()

    t = analysis.trace(fn, meta(256, 512), meta(512, 128))
    act = 256 * 128 * 4
    assert t.argument_bytes == (256 * 512 + 512 * 128) * 4
    assert t.peak_bytes == t.argument_bytes + 2 * act + 4
    assert t.output_bytes == 4 and t.alias_bytes == 0

    def loop(x):
        for _ in range(5):
            x = torch.tanh(x)
        return x

    t = analysis.trace(loop, meta(1024, 1024))
    assert t.peak_bytes == 3 * 1024 * 1024 * 4  # the argument, the last two activations
    assert t.output_bytes == 1024 * 1024 * 4


def test_peak_holds_saved_tensors_and_in_place_outputs():
    """Autograd's saved tensors stay live until the backward frees them; an
    output written in place into an argument is an alias, not new bytes."""

    def fn(w, x):
        w2 = w.detach().requires_grad_(True)
        with torch.enable_grad():
            h = torch.tanh(x @ w2)
            g = torch.autograd.grad(torch.tanh(h @ w2).sum(), [w2])[0]
        return w.sub_(g)

    t = analysis.trace(fn, meta(64, 64), meta(4096, 64))
    act = 4096 * 64 * 4
    assert t.peak_bytes >= t.argument_bytes + 2 * act  # both tanh outputs saved for the backward
    assert t.alias_bytes == 64 * 64 * 4 and t.output_bytes == 0


def test_one_card_counts_no_collectives():
    rec = port_cell("qwen3-0.6b", "decode_32k", False)
    for key in ("collectives", "collectives_flash"):
        assert rec[key] == {"by_kind": {}, "total_bytes": 0, "est_seconds": 0, "op_sites": 0}
    assert rec["roofline"]["collective_s"] == 0


def test_functional_collectives_are_counted():
    """In a process group of one (gloo, on the CPU) the ``_c10d_functional``
    ops are counted by kind, with the reference's ring factors."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        counter = analysis.CostCounter()
        t = torch.ones(64, 32, device=CPU)
        with counter:
            y = funcol.all_reduce(t, "sum", dist.group.WORLD) * 1.0
            g = funcol.all_gather_tensor(t, 0, dist.group.WORLD) + 0.0
        assert torch.equal(y, t) and torch.equal(g, t)
        got = counter.collective_summary()
    finally:
        dist.destroy_process_group()
    n = 64 * 32 * 4
    assert got["by_kind"] == {"all-reduce": n, "all-gather": n} and got["op_sites"] == 2
    assert got["est_seconds"] == pytest.approx((2.0 * n + n) / analysis.LINK_BW)


def test_top_cost_sites_key_by_op_and_shape():
    rows = analysis.top_cost_sites(lambda a, b: torch.tanh(a @ b), meta(64, 128), meta(128, 32), k=5)
    assert [r["prim"] for r in rows] == ["aten.mm", "aten.tanh"]
    assert rows[0] == {"prim": "aten.mm", "shape": [64, 32], "bytes": 64 * 32 * 4, "flops": 2 * 64 * 128 * 32,
                       "count": 1}
    assert rows[1]["flops"] == 0  # a site's FLOPs are its products' (the reference's rule)


def test_cached_outputs_equal_the_kernels():
    """A functional op repeated at the same argument metadata gets fresh
    outputs of the shape, strides and dtype its meta kernel gave."""
    outs = []

    def fn(x):
        for _ in range(3):
            outs.append(torch.softmax(x.transpose(0, 1), dim=-1).to(torch.bfloat16))
        return outs[-1]

    t = analysis.trace(fn, meta(8, 16))
    want = torch.softmax(meta(8, 16).transpose(0, 1), dim=-1).to(torch.bfloat16)
    for o in outs:
        assert (o.shape, o.stride(), o.dtype) == (want.shape, want.stride(), want.dtype)
    assert len({o.untyped_storage()._cdata for o in outs}) == 3
    assert t.sites[("aten._softmax", (16, 8))][2] == 3


def test_model_flops_rule():
    assert analysis.model_flops("train", 10, 0, 7) == 6 * 10 * 7 == janalysis.model_flops("train", 10, 0, 7)
    assert analysis.model_flops("decode", 10, 4, 7) == 2 * 4 * 7 == janalysis.model_flops("decode", 10, 4, 7)
    assert math.isclose(analysis.PEAK_FLOPS, 989e12) and math.isclose(analysis.HBM_BW, 3.35e12)


def test_conv_gradient_of_padded_input_is_found_through_remat():
    """A checkpointed strided conv (its input padded inside the block) counts
    its input gradient by the unpadded input after the recompute too."""

    def block(x, k):
        return F.relu(convnets.conv(k, x, 2))

    def fn(x, k, remat):
        x, k = (t.detach().requires_grad_(True) for t in (x, k))
        with torch.enable_grad():
            y = checkpoint(block, x, k, use_reentrant=False) if remat else block(x, k)
            return torch.autograd.grad(y.sum(), [x, k])

    plain = analysis.trace(lambda x, k: fn(x, k, False), meta(2, 4, 7, 7), meta(8, 4, 3, 3))
    remat = analysis.trace(lambda x, k: fn(x, k, True), meta(2, 4, 7, 7), meta(8, 4, 3, 3))
    forward = 2 * 2 * 4 * 4 * 3 * 3 * 4 * 8
    assert remat.dot_flops - plain.dot_flops == forward
