"""The port's step builder (``launch/steps.build_cell``) against the
reference's, on the CPU: prefill and decode cells of the four LMs' smoke
configs, denoise_step cells of DiT and Flux, classify_serve cells of the
five classifiers, and the argument specs of every full config's serving
cells (sized, never allocated).

Tolerances and why:
  * cache lengths, names, kinds, donated arguments and argument shapes and
    dtypes: exactly equal;
  * logits and denoised latents: both packages run the cells as built, in
    bf16 (serving params are drawn or cast to bf16), so they agree within
    ``LOGIT_RTOL`` = 2% of max|out|, the ViT and Swin tests' rule, on
    weights whose attention matrices have their own fan-in
    (``chip_smoke.own_fan_in``); a denoise step's change ``out - x`` is
    held to the same rule, since ``x`` alone would dominate ``out``.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.arch import ShapeSpec as JShapeSpec
from repro.launch import steps as jsteps
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.launch import steps
from repro_torch.models import common

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import own_fan_in  # noqa: E402

LOGIT_RTOL = 0.02
LMS = ("qwen3-0.6b", "command-r-35b", "qwen2-moe-a2.7b", "deepseek-moe-16b")
DIFFUSION = ("dit-xl2", "flux-dev")
CLASSIFIERS = ("resnet-50", "squeezenet", "vit-s16", "efficientnet-b7", "swin-b")
SMALL = (("prefill_s", "prefill", 2, 12, 0), ("decode_s", "decode", 2, 16, 0), ("serve_s", "classify_serve", 4, 0, 32),
         ("gen_s", "denoise_step", 3, 0, 64))
SERVING_KINDS = ("prefill", "decode", "denoise_step", "classify_serve")


def _small(arch, shape_cls):
    return dataclasses.replace(arch, shapes=tuple(shape_cls(n, k, batch=b, seq=s, img=i) for n, k, b, s, i in SMALL))


def _cells(name: str, shape: str, seed: int):
    """(reference program, bf16 params as jnp, state, port program, bf16
    params, state) on the smoke config's numpy weights, carried across."""
    arch_j, params_j, state_j = reference_params(name, seed)
    arch = configs.get(name, smoke=True)
    if arch.family in ("lm", "vit", "swin", "dit", "flux"):
        own_fan_in(params_j, arch.cfg)
    prog_j = jsteps.build_cell(_small(arch_j, JShapeSpec), shape)
    prog = steps.build_cell(_small(arch, A.ShapeSpec), shape)
    assert (prog.name, prog.kind, prog.donate) == (prog_j.name, prog_j.kind, prog_j.donate)
    params, state = interop.from_jax(arch, params_j, state_j, device=CPU)
    params = common.tree_map(lambda t: t.to(torch.bfloat16), params)
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params_j)
    return prog_j, pj, jax.tree.map(jnp.asarray, state_j), prog, params, state


def _close(got: torch.Tensor, want) -> float:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= LOGIT_RTOL * scale, (err, scale)
    return err / scale


@pytest.mark.parametrize("name", LMS)
def test_prefill_cell_matches_reference(name):
    prog_j, pj, _, prog, params, _ = _cells(name, "prefill_s", 11)
    batch = A.make_inputs(prog.meta["arch"], prog.meta["shape"], 3, device=CPU)
    lj, cj = jax.jit(prog_j.fn)(pj, {"tokens": jnp.asarray(batch["tokens"].numpy())})
    lt, ct = prog(params, batch)
    _close(lt, lj)
    assert int(ct["len"]) == int(cj["len"]) == 12
    for key in ("k", "v"):
        assert tuple(ct[key].shape) == cj[key].shape and ct[key].dtype == torch.bfloat16


@pytest.mark.parametrize("name", LMS)
def test_decode_cell_matches_reference(name):
    """Three decode steps from the cell's own (empty) cache; the port's cache
    is updated in place (argument 1 is donated)."""
    prog_j, pj, _, prog, params, _ = _cells(name, "decode_s", 12)
    cache_j = jax.tree.map(jnp.zeros_like, prog_j.abstract_args()[1])
    cache = prog.init_arg(1, 0, CPU)
    k = cache["k"]
    tokens = np.random.default_rng(4).integers(0, prog.meta["arch"].cfg.vocab, (3, 2, 1)).astype(np.int32)
    step = jax.jit(prog_j.fn)
    for tok in tokens:
        lj, cache_j = step(pj, cache_j, {"token": jnp.asarray(tok)})
        lt, cache = prog(params, cache, {"token": torch.tensor(tok)})
        _close(lt, lj)
    assert cache["k"] is k and int(cache["len"]) == int(cache_j["len"]) == 3


@pytest.mark.parametrize("name", DIFFUSION)
def test_denoise_step_cell_matches_reference(name):
    """One sampler step of each smoke config on the same numpy inputs
    (``make_inputs``' rules), on non-zero modulation weights."""
    prog_j, pj, _, prog, params, _ = _cells(name, "gen_s", 14)
    cfg = prog.meta["arch"].cfg
    rng = np.random.default_rng(6)
    batch = {"x": rng.standard_normal((3, 8, 8, cfg.in_ch)), "t": rng.uniform(0.02, 0.98, 3), "dt": np.full(3, 0.02)}
    if name == "dit-xl2":
        batch["y"] = rng.integers(0, cfg.n_classes, 3).astype(np.int32)
    else:
        batch |= {"txt": rng.standard_normal((3, cfg.txt_len, cfg.txt_dim)), "vec": rng.standard_normal((3, cfg.vec_dim)),
                  "guidance": np.full(3, 4.0)}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}
    want = jax.jit(prog_j.fn)(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    got = prog(params, {k: torch.tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and not got.requires_grad
    _close(got, want)
    _close(got - torch.tensor(batch["x"]), np.asarray(want) - batch["x"])


@pytest.mark.parametrize("name", CLASSIFIERS)
def test_classify_serve_cell_matches_reference(name):
    prog_j, pj, sj, prog, params, state = _cells(name, "serve_s", 13)
    images = np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(np.float32)
    want = jax.jit(prog_j.fn)(pj, sj, {"images": jnp.asarray(images)})
    got = prog(params, state, {"images": torch.tensor(images)})
    assert got.dtype == torch.float32
    _close(got, want)


def _reference_layout(spec, shape: tuple) -> tuple:
    """A port shape in the reference's layout: conv weights OIHW -> HWIO."""
    if spec.init != "conv":
        return shape
    *lead, o, i, kh, kw = shape
    return (*lead, kh, kw, i, o)


@pytest.mark.parametrize("name", LMS + DIFFUSION + CLASSIFIERS)
def test_full_config_cells_sized_like_reference(name):
    """Every serving cell of the full config: the same argument shapes and
    dtypes as the reference's, from specs alone (meta tensors); floating
    params in bf16, BatchNorm state in f32."""
    arch, arch_j = configs.get(name), jconfigs.get(name)
    for shape in arch_j.shapes:
        if shape.kind not in SERVING_KINDS:
            continue
        prog, prog_j = steps.build_cell(arch, shape.name), jsteps.build_cell(arch_j, shape.name)
        assert (prog.name, prog.kind, prog.donate) == (prog_j.name, prog_j.kind, prog_j.donate)
        want = [jax.tree.leaves(a) for a in prog_j.abstract_args()]
        for specs, w_arg in zip(prog.arg_specs, want, strict=True):
            g_arg = common.tree_leaves(common.abstract_tree(specs))
            assert all(t.device.type == "meta" for t in g_arg)
            assert [(_reference_layout(s, tuple(t.shape)), str(t.dtype).removeprefix("torch."))
                    for s, t in zip(common.tree_leaves(specs), g_arg)] == [(tuple(s.shape), str(s.dtype)) for s in w_arg]


def test_shape_overrides():
    lm_cell = steps.build_cell(configs.get("qwen3-0.6b"), "long_500k")
    assert lm_cell.meta["arch"].cfg.kv_seq_axis == "long_kv_seq"
    assert lm_cell.arg_specs[1]["k"].axes[2] == "long_kv_seq" and lm_cell.arg_specs[1]["k"].shape[2] == 524288
    assert steps.build_cell(configs.get("qwen3-0.6b"), "decode_32k").meta["arch"].cfg.kv_seq_axis == "kv_seq"
    serve_384 = A.ShapeSpec("serve_384", "classify_serve", 1, img=384)
    for name, want in (("vit-s16", {"img_res": 384}), ("swin-b", {"img_res": 384, "window": 12})):
        arch = configs.get(name)
        cfg = steps._shape_cfg(arch, serve_384).cfg
        assert {k: getattr(cfg, k) for k in want} == want


# Train state under TRAIN_POLICY: 16 bytes a parameter with the gradients (f32
# params, grads, m, v), in GB: ROADMAP §1's fit table.  Classifiers: at most 1.4.
TRAIN_GB = {"qwen3-0.6b": 12.0, "command-r-35b": 518.1, "qwen2-moe-a2.7b": 242.3, "deepseek-moe-16b": 270.1,
            "dit-xl2": 10.8, "flux-dev": 190.4}
TRAIN_CELLS = [("qwen3-0.6b", "train_4k"), ("deepseek-moe-16b", "train_4k"), ("vit-s16", "cls_224"),
               ("resnet-50", "cls_384"), ("dit-xl2", "train_256"), ("flux-dev", "train_1024")]


def _train_state_bytes(prog) -> tuple[int, int]:
    """(bytes of the train state ``ts`` from its specs, parameters)."""
    ts = prog.arg_specs[0]
    assert set(ts) == {"params", "state", "opt"} and set(ts["opt"]) == {"m", "v", "step"}
    assert ts["opt"]["step"].shape == () and ts["opt"]["step"].dtype == torch.int32
    n = common.param_count(ts["params"])
    assert all(s.dtype == torch.float32 for s in common.tree_leaves(ts["params"]))
    assert common.param_bytes(ts["opt"]["m"]) == common.param_bytes(ts["opt"]["v"]) == 4 * n
    return common.param_bytes(ts), n


@pytest.mark.parametrize("name,shape", TRAIN_CELLS)
def test_training_kinds_build(name, shape):
    """Each training kind builds at full width from specs alone (meta
    tensors): the reference's argument shapes and dtypes, 12 bytes a
    parameter of train state (16 with the gradients, ROADMAP's fit table),
    and the reference's byte count."""
    arch, arch_j = configs.get(name), jconfigs.get(name)
    prog, prog_j = steps.build_cell(arch, shape), jsteps.build_cell(arch_j, shape)
    assert (prog.name, prog.kind, prog.donate) == (prog_j.name, prog_j.kind, prog_j.donate)
    assert prog.kind in ("train", "denoise_train", "classify_train") and prog.donate == (0,)
    want = [jax.tree.leaves(a) for a in prog_j.abstract_args()]
    ts = prog.arg_specs[0]
    layout = ({**ts, "opt": {**ts["opt"], "m": ts["params"], "v": ts["params"]}}, prog.arg_specs[1])  # m, v: as params
    for specs, like, w_arg in zip(prog.arg_specs, layout, want, strict=True):
        g_arg = common.tree_leaves(common.abstract_tree(specs))
        assert all(t.device.type == "meta" for t in g_arg)
        assert [(_reference_layout(s, tuple(t.shape)), str(t.dtype).removeprefix("torch."))
                for s, t in zip(common.tree_leaves(like), g_arg)] == [(tuple(s.shape), str(s.dtype)) for s in w_arg]
    ts_bytes, n = _train_state_bytes(prog)
    assert ts_bytes == sum(math.prod(s.shape) * s.dtype.itemsize for s in want[0])
    assert ts_bytes == 12 * n + common.param_bytes(prog.arg_specs[0]["state"]) + 4
    gb = 16 * n / 1e9
    assert (round(gb, 1) <= 1.4) if name not in TRAIN_GB else gb == pytest.approx(TRAIN_GB[name], abs=0.05)


@pytest.mark.parametrize("name", ["command-r-35b", "qwen2-moe-a2.7b", "efficientnet-b7", "swin-b", "squeezenet"])
def test_train_state_bytes_fit_table(name):
    """The archs the six cells above leave out, at their first training
    shape: ROADMAP's fit table."""
    arch = configs.get(name)
    shape = next(s.name for s in arch.shapes if s.kind in ("train", "classify_train"))
    _, n = _train_state_bytes(steps.build_cell(arch, shape))
    gb = 16 * n / 1e9
    assert (round(gb, 1) <= 1.4) if name not in TRAIN_GB else gb == pytest.approx(TRAIN_GB[name], abs=0.05)


def test_unported_families_and_rules_raise():
    """Under mesh rules every kind builds (ROADMAP items 8.1-8.3: the LMs'
    prefill and decode, denoise_step, classify_serve, and the training kinds
    under train_rules), each keeping its rules, with a spec for every
    argument leaf; a training cell whose microbatch does not split over the
    batch axes raises; a family no config registers and an arch no registry
    holds raise."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import MeshRules, serve_rules, train_rules

    mesh = make_host_mesh(2, 2)  # no process group: a descriptor
    rules = MeshRules(mesh, serve_rules(mesh))
    for name, shape in (("qwen3-0.6b", "prefill_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
                        ("command-r-35b", "long_500k"), ("dit-xl2", "gen_fast"), ("flux-dev", "gen_1024"),
                        ("resnet-50", "serve_b1"), ("efficientnet-b7", "serve_b128"), ("vit-s16", "serve_b1"),
                        ("swin-b", "serve_b128")):
        prog = steps.build_cell(configs.get(name), shape, rules=rules)
        assert prog.rules is rules and prog.kind in ("prefill", "decode", "denoise_step", "classify_serve")
        assert [len(common.tree_leaves(s)) for s in prog.shardings()] == [
            len(common.tree_leaves(s)) for s in prog.arg_specs]
    assert steps.build_cell(configs.get("qwen3-0.6b"), "decode_32k").shardings() is None
    assert not hasattr(steps, "RULES_ENTRY")
    train = MeshRules(mesh, train_rules(mesh))
    for name, shape in (("qwen3-0.6b", "train_4k"), ("dit-xl2", "train_256"), ("resnet-50", "cls_224")):
        prog = steps.build_cell(configs.get(name), shape, rules=train)
        assert prog.rules is train and prog.kind in ("train", "denoise_train", "classify_train")
        assert [len(common.tree_leaves(s)) for s in prog.shardings()] == [
            len(common.tree_leaves(s)) for s in prog.arg_specs]
    odd = dataclasses.replace(configs.get("resnet-50"), shapes=(A.ShapeSpec("t", "classify_train", 6, img=224),))
    with pytest.raises(ValueError, match="does not split evenly"):
        steps.build_cell(odd, "t", rules=train, accum_steps=2)
    unet = A.Arch("unet", "unet", None, shapes=(A.ShapeSpec("gen_fast", "denoise_step", 16, img=512),))
    for fn in (A.abstract_params, lambda a: A.input_specs(a, a.shapes[0])):
        with pytest.raises(ValueError):
            fn(unet)
    with pytest.raises(KeyError):
        configs.get("unet")


def test_init_args_on_the_card_by_default(monkeypatch):
    prog = steps.build_cell(_small(configs.get("qwen3-0.6b", smoke=True), A.ShapeSpec), "decode_s")
    params, cache, batch = prog.init_args(5, CPU)
    for a, b in zip(common.tree_leaves(prog.init_arg(0, 5, CPU)), common.tree_leaves(params)):
        assert torch.equal(a, b)
    assert all(t.dtype == torch.bfloat16 for t in common.tree_leaves(params))
    assert cache["k"].shape == (2, 2, 16, 2, 16) and cache["len"].dtype == torch.int32 and int(cache["len"]) == 0
    assert batch["token"].shape == (2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        prog.init_args(5)
