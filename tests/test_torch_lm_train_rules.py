"""The LMs' training step under mesh rules on real ranks: qwen3-0.6b,
command-r-35b and qwen2-moe-a2.7b, SMOKE configs in f32, through
``launch/steps.build_cell(..., rules=MeshRules(mesh, train_rules(mesh)))``
(``train``) on 4 gloo ranks (``torch_ranks.train_rule_steps``), against the
reference's ``build_cell`` under ``jax.jit(in_shardings=prog.shardings())``
on 4 forced host devices (a subprocess) and against the port's step without
rules.

Under ``train_rules`` the leaves' ``embed`` dim splits over ``data``
(FSDP), the residual's sequence over ``model`` between sublayers
(``seq_shard_acts``), and the logits stay split on ``vocab``.  Meshes (2,
2), (1, 4) and (4, 1) for qwen3; command-r on (1, 4), where the reference
does not gather x before the attention (``lm._unshard_seq``); qwen2-moe on
(2, 2) (its experts split over ``model``); qwen3 with ``remat`` (each block
run again in the backward pass, its collectives with it); qwen3 with
``accum_steps`` 2, whose microbatches are rows of the global batch.

Every case is held to ``tests/test_torch_train_step.py``'s contract for one
step (``step`` equal; lr to 1e-6; ``m``, ``v``, BatchNorm state and the loss
metrics within ``RTOL`` of max|·| plus ``ATOL``; ``grad_norm`` to rtol
``RTOL``; params within 2·lr and a mean |Δ| below ``MEAN_PARAM``·lr),
against the reference and against one card.  Beside it: ``value_and_grad``'s
gradients put together from the ranks within ``GRAD_RTOL`` (‖Δ‖ / ‖·‖ over
every leaf) of ``jax.grad`` under the same ``in_shardings``; the specs of
``prog.shardings()`` equal the reference's on every leaf; each rank's
updated shards keep their placements (the params and moments their
storage); and ``CommDebugMode`` sees every collective of the step, forward
and backward, inside ``sharding.rules``' primitives.  The diffusion and
classifier files run their cases through the same helpers.  Beside the
cases: every training cell of the ten archs builds under ``train_rules``,
and an elastic restart (ROADMAP item 8.5) resumes a ruled run on a smaller
mesh.
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
from test_torch_diffusion_rules import in_port_order
from torch_ranks import F32, run_ranks, train_case_arch

from repro import arch as JA
from repro import configs as jconfigs
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.data import DataSpec, SyntheticStream
from repro_torch.launch import steps
from repro_torch.models import common, convnets, diffusion, layers, lm, vision
from repro_torch.train import optim

sys.path.insert(0, str(REPO))  # chip_smoke.py, at the repo root
import chip_smoke  # noqa: E402

RTOL = 1e-4
ATOL = 1e-7
MEAN_PARAM = 0.01
GRAD_RTOL = 1e-4
MOMENT_FLOOR = 1e-6  # (1 - b1) * 1000 * eps: settled_elements
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1}}
TRAIN = ("train", 4, 16, 0)


def case(arch: str, shape: tuple, mesh: str, accum: int = 1, blockwise: bool = False, **cfg) -> dict:
    """A training case; ``blockwise``: every differentiated attention takes
    ``blockwise_sdpa`` (the threshold at 0 in both packages), as
    train_1024's 4352 tokens do."""
    return {"arch": arch, "shape": shape, "mesh": MESHES[mesh], "accum": accum, "adamw": ADAMW, "cfg": cfg,
            "blockwise": blockwise}


CASES = {
    "qwen3/2x2": case("qwen3-0.6b", TRAIN, "2x2"),
    "qwen3/1x4": case("qwen3-0.6b", TRAIN, "1x4"),
    "qwen3/4x1": case("qwen3-0.6b", TRAIN, "4x1"),
    "qwen3_remat/2x2": case("qwen3-0.6b", TRAIN, "2x2", remat=True),
    "qwen3_accum2/2x2": case("qwen3-0.6b", TRAIN, "2x2", accum=2),
    "command-r/1x4": case("command-r-35b", TRAIN, "1x4"),
    "qwen2-moe/2x2": case("qwen2-moe-a2.7b", TRAIN, "2x2"),
}

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
from repro.models import convnets, diffusion, lm, vision
from repro.models import layers as jlayers
from repro.models.common import activation_rules
from repro.sharding.rules import MeshRules, train_rules
from repro.train.optim import AdamWConfig
from torch_ranks import F32, train_case_arch
assert jax.device_count() == 4
for mod in (lm, diffusion, vision, convnets):
    mod.jnp = F32(jnp, jnp.float32)
cases = pickle.load(open(sys.argv[1], "rb"))


def loss_of(arch, kind):
    # The reference build_cell's loss_fn of each training kind, its loss alone.
    cfg = arch.cfg
    if kind == "train":
        return lambda p, s, b: lm.train_loss(cfg, p, b["tokens"], b["labels"])[0]
    if kind == "denoise_train" and arch.family == "dit":
        return lambda p, s, b: diffusion.dit_train_loss(cfg, p, b["x"], b["t"], b["y"], b["noise"])[0]
    if kind == "denoise_train":
        return lambda p, s, b: diffusion.flux_train_loss(cfg, p, b["x"], b["txt"], b["vec"], b["t"], b["noise"])[0]

    def classify(p, s, b):
        logits, _ = JA.classifier_forward(arch, p, s, b["images"], train=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, b["labels"][:, None], axis=-1))

    return classify


out = {{}}
for key, case in cases.items():
    mesh = make_host_mesh(**case["mesh"])
    rules = MeshRules(mesh, train_rules(mesh))
    prog = steps.build_cell(train_case_arch(JA, configs, case), "t", rules=rules,
                            adamw=AdamWConfig(**case["adamw"]), accum_steps=case["accum"])
    loss_fn = loss_of(prog.meta["arch"], prog.kind)
    ts, batch = case["ref_args"]
    sh_ts, sh_batch = prog.shardings()

    def both(ts, batch):
        with activation_rules(rules):
            loss, grads = jax.value_and_grad(loss_fn)(ts["params"], ts["state"], batch)
        return loss, grads, prog.fn(ts, batch)

    jlayers.BLOCKWISE_THRESHOLD = 0 if case["blockwise"] else 4096
    loss, grads, (new, metrics) = jax.jit(both, in_shardings=(sh_ts, sh_batch))(ts, batch)
    specs = [[[[] if e is None else [e] if isinstance(e, str) else list(e) for e in sh.spec]
              for sh in jax.tree.leaves(s)] for s in prog.shardings()]
    out[key] = {{"shardings": specs, "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
                 "ts": jax.tree.map(np.asarray, new), "metrics": {{k: float(v) for k, v in metrics.items()}}}}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def case_args(c: dict, seed: int) -> tuple:
    """(the reference's train state and batch, the port's): the reference's
    random SMOKE weights and BatchNorm statistics (f32; a diffusion or
    vision model's attention matrices at their own fan-in, as
    ``chip_smoke.own_fan_in`` gives them), zero moments, step 0, carried to
    the port's layout by ``interop.from_jax``; the batch from the port's
    ``SyntheticStream``."""
    jarch, arch = train_case_arch(JA, jconfigs, c), train_case_arch(A, configs, c)
    _, params, state = reference_params(c["arch"], seed, arch=jarch)
    if arch.family in ("dit", "flux", "vit", "swin"):
        params = chip_smoke.own_fan_in(params, jarch.cfg)
    batch = SyntheticStream(DataSpec(arch, arch.shape("t"), seed=seed + 1)).batch_at(0)
    zeros = lambda t: common.tree_map(lambda a: np.zeros(a.shape, np.float32), t)  # noqa: E731
    step = np.zeros((), np.int32)
    ref = {"params": params, "state": state, "opt": {"m": zeros(params), "v": zeros(params), "step": step}}
    pp, ps = (common.tree_map(lambda t: t.numpy(), t) for t in interop.from_jax(arch, params, state, device="cpu"))
    port = {"params": pp, "state": ps, "opt": {"m": zeros(pp), "v": zeros(pp), "step": step}}
    return (ref, batch), (port, batch)


def f32_modules(mp) -> None:
    for mod in (lm, diffusion, vision, convnets):
        mp.setattr(mod, "torch", F32(torch, torch.float32))


def one_card(c: dict, args: tuple) -> dict:
    """The port's step without rules on the same arguments, in f32: its
    ``value_and_grad`` and one step."""
    with pytest.MonkeyPatch.context() as mp:
        f32_modules(mp)
        if c["blockwise"]:
            mp.setattr(layers, "BLOCKWISE_THRESHOLD", 0)
        prog = steps.build_cell(train_case_arch(A, configs, c), "t", adamw=optim.AdamWConfig(**c["adamw"]),
                                accum_steps=c["accum"])
        ts, batch = (common.tree_map(lambda a: torch.from_numpy(np.array(a)), a) for a in args)
        (loss, _), grads = steps.value_and_grad(prog.meta["loss_fn"], ts["params"], ts["state"], batch)
        ts, metrics = prog(ts, batch)
    return {"loss": float(loss), "grads": [g.numpy() for g in grads],
            "ts": common.tree_map(lambda t: t.numpy(), ts), "metrics": {k: float(v) for k, v in metrics.items()}}


def run_cases(tmp_path, cases: dict, seed: int) -> dict:
    """Every case on 4 port ranks (one launch) and on the reference's 4 host
    devices (one subprocess), at once; the port without rules beside.
    Returns per case (ranks, reference, one card, the port's arg specs, the
    mesh's extents)."""
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
        ranks = run_ranks(tmp_path, 4, "torch_ranks:train_rule_steps", port, timeout=240)
        plain = {k: one_card(c, c["args"]) for k, c in cases.items()}
        _, err = ref.communicate(timeout=420)
        assert ref.returncode == 0, err[-4000:]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    want = pickle.loads(result.read_bytes())
    out = {}
    for k, c in cases.items():
        arch = train_case_arch(A, configs, c)
        specs = steps.build_cell(arch, "t").arg_specs
        out[k] = ([r[k] for r in ranks], carried(arch, want[k]), plain[k], specs, tuple(c["mesh"].values()))
    return out


def carried(arch, want: dict) -> dict:
    """The reference's results with its trees in the port's layout
    (``interop.from_jax``); the gradients as a list in leaf order."""
    ts = want["ts"]

    def port(params, state=ts["state"]):
        return [common.tree_map(lambda t: t.numpy(), t) for t in interop.from_jax(arch, params, state, device="cpu")]

    params, state = port(ts["params"])
    opt = {"m": port(ts["opt"]["m"])[0], "v": port(ts["opt"]["v"])[0], "step": ts["opt"]["step"]}
    return {**want, "grads": common.tree_leaves(port(want["grads"])[0]),
            "ts": {"params": params, "state": state, "opt": opt}}


def assemble(parts: list, shape: tuple) -> np.ndarray:
    """The global array from the ranks' ``laid_out`` parts; every element
    covered."""
    full, covered = np.zeros(shape, np.float64), np.zeros(shape, bool)
    for local, where in parts:
        at = tuple(slice(a, b) for a, b in where)
        full[at], covered[at] = local, True
    assert covered.all(), shape
    return full


def _paths(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}.{k}")]
    return [prefix]


def grad_distance(got: list, want: list) -> float:
    """‖got − want‖ / ‖want‖ over every leaf."""
    num = sum(float(np.sum((np.asarray(g, np.float64) - w) ** 2)) for g, w in zip(got, want))
    return (num / sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want)) ** 0.5


def close_step(got: dict, want: dict, what: str, settled: list) -> None:
    """``tests/test_torch_train_step.py``'s one-step contract of ``got``
    (metrics, train state) against ``want``.  The mean |Δ| of a leaf's
    params is taken over its ``settled`` elements (a boolean mask a leaf)."""
    assert set(got["metrics"]) == set(want["metrics"]), (what, sorted(got["metrics"]), sorted(want["metrics"]))
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, want["metrics"][k], rtol=RTOL if k != "lr" else 1e-6, atol=1e-9,
                                   err_msg=f"{what}: {k}")
    assert int(got["ts"]["opt"]["step"]) == int(want["ts"]["opt"]["step"]) == 1, what
    lr, masks = ADAMW["lr"], iter(settled)
    for part in ("params", "state", "m", "v"):
        tree_g = got["ts"]["opt"][part] if part in ("m", "v") else got["ts"][part]
        tree_w = want["ts"]["opt"][part] if part in ("m", "v") else want["ts"][part]
        for name, g, w in zip(_paths(tree_g, f"{what}: {part}"), common.tree_leaves(tree_g),
                              common.tree_leaves(tree_w)):
            assert np.shape(g) == np.shape(w), name
            d = np.abs(np.asarray(g, np.float64) - w)
            if part != "params":
                assert float(d.max()) <= RTOL * float(np.abs(w).max()) + ATOL, (name, float(d.max()))
            else:
                mask = next(masks)
                assert float(d.max()) <= 2 * lr, (name, float(d.max()))
                assert not mask.any() or float(d[mask].mean()) <= MEAN_PARAM * lr, (name, float(d[mask].mean()))


def settled_elements(runs: list) -> list:
    """Per params leaf, the elements on which Adam's first step is settled
    in every run: their first moments (the step's gradient, clipped, times
    1 - b1) share a sign and are at least ``MOMENT_FLOOR``.  The first step
    moves a weight by lr · g / (|g| + eps), which is lr · sign(g) within
    0.1% once |g| >= 1000 eps; a weight whose gradient is within f32 noise
    of zero (an attention key bias's, whose exact gradient is zero, or a
    BatchNorm bias's that feeds another BatchNorm in train mode) moves
    anywhere in ±lr, whichever order the f32 sums took.
    ``tests/test_torch_train_step.py`` leaves the key biases out by name."""
    moments = [[np.asarray(m) for m in common.tree_leaves(r["ts"]["opt"]["m"])] for r in runs]
    return [np.all(np.sign(np.stack([m[i] for m in moments])) == np.sign(moments[0][i]), axis=0)
            & (np.abs(moments[0][i]) >= MOMENT_FLOOR) for i in range(len(moments[0]))]


def check_case(key: str, result: tuple) -> None:
    """The module docstring's checks on one case's results."""
    ranks, want, plain, arg_specs, (data, model) = result
    assert sorted(tuple(r["coord"]) for r in ranks) == [(i, j) for i in range(data) for j in range(model)]
    ts_specs, batch_specs = arg_specs  # the moments' dims in their params' order (a conv weight's OIHW)
    laid = ({**ts_specs, "opt": {**ts_specs["opt"], "m": ts_specs["params"], "v": ts_specs["params"]}}, batch_specs)
    for r in ranks:
        assert r["shardings"] == in_port_order(laid, want["shardings"]), key
        assert all(r["kept"]), key
        n_params = 3 * len(common.tree_leaves(arg_specs[0]["params"]))  # params, m and v update in place
        held = [ok for ok, p in zip(r["in_place"], _paths(arg_specs[0])) if not p.startswith(".state")]
        assert len(held) == n_params + 1 and all(held), key
        comms = r["comms"]
        assert comms["inside"] == comms["total"] > 0, (key, comms)
        assert any(k.endswith("/backward") for k in comms["tally"]), (key, comms)
        assert len({r["loss"] for r in ranks}) == 1 and len({tuple(r["metrics"].items()) for r in ranks}) == 1
    leaves = common.tree_leaves(want["ts"])
    got_ts = [assemble([r["ts"][i] for r in ranks], np.shape(w)) for i, w in enumerate(leaves)]
    it = iter(got_ts)
    got = {"metrics": ranks[0]["metrics"], "ts": common.tree_map(lambda _: next(it), want["ts"])}
    settled = settled_elements([got, want, plain])
    close_step(got, want, f"{key} against the reference", settled)
    close_step(got, plain, f"{key} against one card", settled)
    grads = [assemble([r["grads"][i] for r in ranks], np.shape(w)) for i, w in enumerate(want["grads"])]
    np.testing.assert_allclose(ranks[0]["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(ranks[0]["loss"], plain["loss"], rtol=RTOL)
    assert grad_distance(grads, want["grads"]) <= GRAD_RTOL, (key, grad_distance(grads, want["grads"]))
    assert grad_distance(grads, plain["grads"]) <= GRAD_RTOL, (key, grad_distance(grads, plain["grads"]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_train_rules"), CASES, seed=61)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_train_step_equals_reference_on_ranks(results, key):
    check_case(key, results[key])


ELASTIC_RTOL = 1e-4


def test_elastic_restart_onto_a_ruled_step(tmp_path):
    """ROADMAP item 8.5: a SMOKE qwen3 trained 4 steps under ``train_rules``
    on 4 ranks at (2, 2) and saved; restored onto the re-planned (1, 2) mesh
    (``plan_elastic_remesh(3, model_axis=2, pod_size=4, prior_chips=4)``:
    ``data_parallel_scale`` 0.5) on 2 ranks with ``accum_steps`` 2, which
    keeps the global batch; steps 5-6 there end within ``ELASTIC_RTOL`` of
    the straight 6-step run's last loss.  Every rank's restored shards equal
    the saved arrays' slices, and some leaves are split."""
    ckpt = tmp_path / "ckpt"
    straight = run_ranks(tmp_path / "straight", 4, "torch_ranks:elastic_ruled", str(ckpt), False, timeout=120)
    after = run_ranks(tmp_path / "restart", 2, "torch_ranks:elastic_ruled", str(ckpt), True, timeout=120)
    assert all(r == straight[0] for r in straight)
    for r in after:
        assert (r["mesh"], r["scale"], r["accum"], r["restored"]) == ([1, 2], 0.5, 2, 4), r
        assert all(r["equal"]) and r["split"] > 0, r
        np.testing.assert_allclose(r["losses"][-1], straight[0]["losses"][-1], rtol=ELASTIC_RTOL)
    print(f"straight {straight[0]['losses']}, restarted {after[0]['losses']}")


def test_every_training_cell_builds_under_train_rules():
    """Every training cell of ``configs.cells()`` (the ten archs' train_4k,
    train_256 / train_1024 and cls_224 / cls_384) builds under
    ``train_rules`` on a (2, 2) mesh with its published batch, keeping its
    rules, with a spec for every leaf of its arguments, the moments laid out
    as their params."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import MeshRules, train_rules

    mesh = make_host_mesh(2, 2)  # no process group: a descriptor
    rules = MeshRules(mesh, train_rules(mesh))
    built = 0
    for name, shape in configs.cells():
        if configs.get(name).shape(shape).kind not in ("train", "denoise_train", "classify_train"):
            continue
        prog = steps.build_cell(configs.get(name), shape, rules=rules)
        ts, batch = prog.shardings()
        assert prog.rules is rules and len(common.tree_leaves(batch)) == len(common.tree_leaves(prog.arg_specs[1]))
        assert common.tree_leaves(ts["opt"]["m"]) == common.tree_leaves(ts["params"]) == common.tree_leaves(
            ts["opt"]["v"]), (name, shape)
        built += 1
    assert built == 16
