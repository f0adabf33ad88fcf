"""The diffusion models' sampling steps under mesh rules on real ranks:
DiT-XL/2 and Flux-dev, SMOKE configs in f32, through
``launch/steps.build_cell(..., rules=MeshRules(mesh, serve_rules(mesh)))``
(``denoise_step``) on 4 gloo ranks (``torch_ranks.serve_rule_steps``),
against the reference's ``build_cell`` under
``jax.jit(in_shardings=prog.shardings())`` on 4 forced host devices (a
subprocess) and against the port's step without rules.

Meshes (2, 2), (1, 4) and (4, 1) for both models, at batch 4 on an 8 x 8
latent.  On ``model`` the attention splits its heads and the MLPs their
hidden width; the adaLN modulation's columns split and are gathered before
they are chunked; Flux's image residual and its joint sequence split over
``act_seq`` between sublayers.  For every case: the ranks' next latents put
together equal the reference's and the one-card step's (max|Δ| / max|ref|
<= 1e-5); the ranks cover the mesh; the specs of ``prog.shardings()`` equal
the reference's on every leaf (a conv weight's dims in the port's OIHW
order); and ``CommDebugMode`` sees no collective outside
``sharding.rules``' helpers, and some inside them wherever ``model`` splits.
The classifiers' file (``test_torch_classify_rules.py``) runs its cases
through the same helpers.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

from test_torch_ref import REPO, reference_params  # installs the jax 0.9 shims first

import numpy as np
import pytest
import torch
from test_torch_rules import port_order
from torch_ranks import F32, run_ranks, serve_case_arch

from repro import arch as JA
from repro import configs as jconfigs
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.launch import steps
from repro_torch.models import common, convnets, diffusion, vision

sys.path.insert(0, str(REPO))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

RTOL = 1e-5
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1}}
GEN = ("gen", "denoise_step", 4, 0, 64)  # an 8 x 8 latent, as the SMOKE configs' own


def case(arch: str, shape: tuple, mesh: str, **cfg) -> dict:
    return {"arch": arch, "shape": shape, "mesh": MESHES[mesh], "cfg": cfg}


CASES = {f"{name}/{mesh}": case(arch, GEN, mesh) for name, arch in (("dit", "dit-xl2"), ("flux", "flux-dev"))
         for mesh in MESHES}

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = {paths!r}
import pickle
import test_torch_ref  # the jax 0.9 shims
import jax
import jax.numpy as jnp
import numpy as np
from repro import arch as JA, configs
from repro.launch import steps
from repro.launch.mesh import make_host_mesh
from repro.models import convnets, diffusion, vision
from repro.sharding.rules import MeshRules, serve_rules
from torch_ranks import F32, serve_case_arch
assert jax.device_count() == 4
for mod in (diffusion, vision, convnets):
    mod.jnp = F32(jnp, jnp.float32)
cases = pickle.load(open(sys.argv[1], "rb"))
out = {{}}
for key, case in cases.items():
    mesh = make_host_mesh(**case["mesh"])
    prog = steps.build_cell(serve_case_arch(JA, configs, case), case["shape"][0],
                            rules=MeshRules(mesh, serve_rules(mesh)))
    y = prog.jit()(*case["ref_args"])
    specs = [[[[] if e is None else [e] if isinstance(e, str) else list(e) for e in sh.spec]
              for sh in jax.tree.leaves(s)] for s in prog.shardings()]
    out[key] = {{"shardings": specs, "out": np.asarray(y)}}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def batch_args(prog, rng) -> dict:
    """A step's inputs as numpy arrays, by the rules of ``arch.make_inputs``
    but for ``dt``: ``t`` uniform in [0.02, 0.98], ``dt`` 0.25 (a sampler
    takes 0.02; a larger step weighs Flux's velocity more in the next
    latents), ``guidance`` 4.0, labels below the class count, every other
    float standard normal."""
    arch = prog.meta["arch"]
    out = {}
    for name, s in sorted(prog.arg_specs[-1].items()):
        if name == "t":
            out[name] = rng.uniform(0.02, 0.98, s.shape).astype(np.float32)
        elif name in ("dt", "guidance"):
            out[name] = np.full(s.shape, 0.25 if name == "dt" else 4.0, np.float32)
        elif s.dtype == torch.int32:
            out[name] = rng.integers(0, arch.cfg.n_classes, s.shape).astype(np.int32)
        else:
            out[name] = rng.standard_normal(s.shape).astype(np.float32)
    return out


def case_args(c: dict, seed: int) -> tuple:
    """(the reference's arguments, the port's): the reference's random
    SMOKE weights (f32; its zero-init leaves drawn too) and state, carried
    to the port's layout by ``interop.from_jax``, and the same inputs.  A
    model's attention matrices get their own fan-in
    (``chip_smoke.own_fan_in``): on the reference's fan-in rule, which reads
    H as wq's fan-in, the SMOKE Swin's softmax is near one-hot, and the
    reference's jitted and eager forwards differ by 3.3e-5 of max|logit|
    (3.4e-7 at their own fan-in)."""
    jarch, arch = serve_case_arch(JA, jconfigs, c), serve_case_arch(A, configs, c)
    _, params, state = reference_params(c["arch"], seed, arch=jarch)
    if arch.family in ("dit", "flux", "vit", "swin"):
        params = chip_smoke.own_fan_in(params, jarch.cfg)
    prog = steps.build_cell(arch, c["shape"][0])
    batch = batch_args(prog, np.random.default_rng(seed + 1))
    pp, ps = (common.tree_map(lambda t: t.numpy(), t) for t in interop.from_jax(arch, params, state, device="cpu"))
    if prog.kind == "classify_serve":
        return (params, state, batch), (pp, ps, batch)
    return (params, batch), (pp, batch)


def one_card(c: dict, args: tuple) -> np.ndarray:
    """The port's step without rules on the same arguments, in f32."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (diffusion, vision, convnets):
            mp.setattr(mod, "torch", F32(torch, torch.float32))
        prog = steps.build_cell(serve_case_arch(A, configs, c), c["shape"][0])
        return prog(*(common.tree_map(torch.from_numpy, a) for a in args)).numpy()


def run_cases(tmp_path, cases: dict, seed: int) -> dict:
    """Every case on 4 port ranks (one launch) and on the reference's 4
    host devices, at once; the port without rules beside.  Returns per case
    (ranks, reference, one card, the port's arg specs, the mesh's extents)."""
    cases = {k: dict(c, **dict(zip(("ref_args", "args"), case_args(c, seed + i)))) for i, (k, c) in
             enumerate(cases.items())}
    job, result = tmp_path / "ref_cases.pkl", tmp_path / "ref_out.pkl"
    job.write_bytes(pickle.dumps({k: {n: v for n, v in c.items() if n != "args"} for k, c in cases.items()}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    code = REFERENCE.format(paths=[str(REPO / "tests"), str(REPO / "src")])
    ref = subprocess.Popen([sys.executable, "-c", code, str(job), str(result)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = {k: {n: v for n, v in c.items() if n != "ref_args"} for k, c in cases.items()}
        ranks = run_ranks(tmp_path, 4, "torch_ranks:serve_rule_steps", port, timeout=150)
        plain = {k: one_card(c, c["args"]) for k, c in cases.items()}
        _, err = ref.communicate(timeout=240)
        assert ref.returncode == 0, err[-4000:]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    want = pickle.loads(result.read_bytes())
    specs = {k: steps.build_cell(serve_case_arch(A, configs, c), c["shape"][0]).arg_specs for k, c in cases.items()}
    return {k: ([r[k] for r in ranks], want[k], plain[k], specs[k], tuple(c["mesh"].values()))
            for k, c in cases.items()}


def rel(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max()) / max(float(np.abs(want).max()), 1e-30)


def in_port_order(arg_specs, ref_specs: list) -> list:
    """The reference's resolved specs (lists of axes per dim), each leaf's
    dims in the port's order (a conv weight HWIO -> OIHW)."""
    out = []
    for tree, ref in zip(arg_specs, ref_specs):
        leaves = common.tree_leaves(tree)
        assert len(leaves) == len(ref)
        entries = (port_order(s, [tuple(e) if e else None for e in r]) for s, r in zip(leaves, ref))
        out.append([[[] if e is None else list(e) for e in full] for full in entries])
    return out


def check_case(key: str, result: tuple) -> None:
    """The module docstring's checks on one case's results."""
    ranks, want, plain, arg_specs, (data, model) = result
    assert sorted(tuple(r["coord"]) for r in ranks) == [(i, j) for i in range(data) for j in range(model)]
    for r in ranks:
        assert r["shardings"] == in_port_order(arg_specs, want["shardings"])
        comms = r["comms"]
        assert comms["inside"] == comms["total"] == comms["tally"], comms
        assert (comms["total"] > 0) == (model > 1), comms
    full, covered = np.zeros(want["out"].shape, np.float32), np.zeros(want["out"].shape, bool)
    for r in ranks:
        local, where = r["out"]
        at = tuple(slice(a, b) for a, b in where)
        full[at], covered[at] = local, True
    assert covered.all(), key
    assert rel(full, want["out"]) <= RTOL, (key, rel(full, want["out"]))
    assert rel(full, plain) <= RTOL, (key, "against one card", rel(full, plain))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("diffusion_rules"), CASES, seed=21)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_denoise_step_equals_reference_on_ranks(results, key):
    check_case(key, results[key])
