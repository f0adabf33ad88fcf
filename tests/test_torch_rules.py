"""The port's mesh descriptors (``launch/mesh``) and rule tables
(``sharding/rules``) against the reference's: ``MeshRules._resolve`` on every
param spec of every ASSIGNED config, SMOKE and full, under ``train_rules``
and ``serve_rules`` (and each with the config's own overrides, as the
reference's dry run applies them), on the meshes 1x1, 2x4, 2x2x2, 16x16 and
2x16x16.  The reference's ``_resolve`` reads only ``mesh.axis_names`` and
``mesh.shape``, so in this process it takes a plain stand-in; one subprocess
resolves the same specs over a real 8-device host mesh.  Equality is exact:
a spec is a tuple of ``None``, axis names and tuples of names.  A conv
weight is OIHW in the port and HWIO in the reference, so its dimensions are
compared in the port's order.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

from test_torch_ref import REPO  # installs the jax 0.9 shims first

import jax
import pytest
import torch
from torch_ranks import run_ranks

from repro import arch as JA
from repro import configs as jconfigs
from repro.models.common import ParamSpec as JParamSpec
from repro.sharding import rules as jrules
from repro_torch import arch as A
from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.models.common import tree_leaves
from repro_torch.sharding import MeshRules, serve_rules, train_rules
from repro_torch.sharding import rules as prules

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
TABLES = ("train", "serve")
ARCHS = [(name, smoke) for name in configs.ASSIGNED for smoke in (False, True)]


def port_mesh(key: str) -> M.Mesh:
    return M.Mesh(*MESHES[key])


def ref_mesh(key: str):
    names, sizes = MESHES[key]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def tables(arch, table: str, rules_mod, mesh) -> list[dict]:
    """The table, and the table with the config's overrides where it has any."""
    t = (rules_mod.train_rules if table == "train" else rules_mod.serve_rules)(mesh)
    return [t] + ([{**t, **arch.sharding_overrides}] if arch.sharding_overrides else [])


def spec_leaves(name: str, smoke: bool):
    """(port specs, reference specs) of the config's params and state."""
    params, state = A.abstract_params(configs.get(name, smoke=smoke))
    jparams, jstate = JA.abstract_params(jconfigs.get(name, smoke=smoke))
    is_spec = lambda x: isinstance(x, JParamSpec)  # noqa: E731
    return (tree_leaves(params) + tree_leaves(state),
            jax.tree.leaves(jparams, is_leaf=is_spec) + jax.tree.leaves(jstate, is_leaf=is_spec))


def as_spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def port_order(s, entries, *, strip: bool = True) -> tuple:
    """Per-dimension ``entries`` of the reference's spec matching the port's
    ``s``, in the port's order: [..., KH, KW, I, O] -> [..., O, I, KH, KW]
    for a conv weight; trailing ``None``s dropped where ``strip``."""
    full = list(entries) + [None] * (len(s.shape) - len(entries))
    if s.init == "conv":
        n = len(full) - 4
        full = full[:n] + [full[n + 3], full[n + 2], full[n], full[n + 1]]
    while strip and full and full[-1] is None:
        full.pop()
    return tuple(full)


@pytest.mark.parametrize("name,smoke", ARCHS)
def test_resolve_equals_reference(name, smoke):
    ours, theirs = spec_leaves(name, smoke)
    assert [(s.shape, s.axes) for s in ours] == [
        (port_order(s, js.shape, strip=False), port_order(s, js.axes, strip=False)) for s, js in zip(ours, theirs)]
    arch, jarch = configs.get(name, smoke=smoke), jconfigs.get(name, smoke=smoke)
    assert arch.sharding_overrides == jarch.sharding_overrides
    sharded = 0
    for key in MESHES:
        for table in TABLES:
            for t, jt in zip(tables(arch, table, prules, port_mesh(key)), tables(jarch, table, jrules, ref_mesh(key)),
                             strict=True):
                assert t == jt
                rules, jr = MeshRules(port_mesh(key), t), jrules.MeshRules(ref_mesh(key), jt)
                for s, js in zip(ours, theirs):
                    got = rules._resolve(s.shape, s.axes)
                    assert got == port_order(s, jr._resolve(js.shape, js.axes)), (key, table, s)
                    sharded += any(e is not None for e in got)
    assert sharded > 0


def test_resolve_guards():
    """tests/test_substrate.py's divisibility and reuse cases, on the port."""
    mesh = M.make_host_mesh(data=2, model=4)
    rules = MeshRules(mesh, train_rules(mesh))
    assert rules._resolve((8, 12), ("embed", "mlp")) == ("data", "model")
    assert rules._resolve((8, 10), ("embed", "mlp")) == ("data",)
    assert rules._resolve((8, 8, 4), ("mlp", "heads", "kv_heads")) == ("model",)
    one = M.make_host_mesh()
    assert MeshRules(one, {"a": "data", "b": "model", "c": ("data", "model")})._resolve((8, 8), ("a", "b")) == ()
    pods = M.make_production_mesh(multi_pod=True)
    r = MeshRules(pods, train_rules(pods))
    assert r.logical((64, 4096, 16), ("batch", "long_kv_seq", None)) == (("pod", "data"), "model")


def test_meshes_mirror_the_reference():
    assert (M.make_production_mesh().axis_names, M.make_production_mesh().shape) == (
        ("data", "model"), {"data": 16, "model": 16})
    assert M.make_production_mesh(multi_pod=True).size == 512
    assert M.make_host_mesh(data=2, model=4).shape == {"data": 2, "model": 4}
    assert M.make_host_mesh(2, 2, pod=2).axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError):
        M.Mesh(("data",), (1, 2))


def test_tree_shardings_and_constrain():
    mesh = port_mesh("2x4")
    rules = MeshRules(mesh, train_rules(mesh))
    specs = A.abstract_params(configs.get("qwen3-0.6b", smoke=True))[0]
    got = tree_leaves(rules.tree_shardings(specs))
    assert got == [rules._resolve(s.shape, s.axes) for s in tree_leaves(specs)]
    assert any(g for g in got)
    x = torch.ones(4, 8)
    one = M.make_host_mesh()
    assert MeshRules(one, train_rules(one)).constrain(x, ("batch", "embed")) is x
    with pytest.raises(ValueError, match="plain tensor"):
        rules.constrain(x, ("batch", "embed"))


def test_constrain_redistributes_a_dtensor(tmp_path):
    """On a real (2, 1) mesh of two gloo ranks: replicated -> ``Shard(0)``
    on data -> replicated, values unchanged at every step."""
    for steps in run_ranks(tmp_path, 2, "torch_ranks:constrain_roundtrip"):
        assert [(p, shape, same) for p, shape, _, same in steps] == [
            ("(Shard(dim=0), Replicate())", [8, 4], True), ("(Replicate(), Replicate())", [16, 4], True)]


HOST_MESH_CODE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = {paths!r}
import test_torch_ref  # the jax 0.9 shims
import jax
from repro import arch as JA, configs
from repro.launch.mesh import make_host_mesh
from repro.models.common import ParamSpec
from repro.sharding.rules import MeshRules, serve_rules, train_rules
out = {{}}
for key, mesh in (("2x4", make_host_mesh(data=2, model=4)), ("2x2x2", make_host_mesh(2, 2, pod=2))):
    assert mesh.devices.size == 8
    for name in configs.ASSIGNED:
        for smoke in (False, True):
            p, s = JA.abstract_params(configs.get(name, smoke=smoke))
            leaves = jax.tree.leaves((p, s), is_leaf=lambda x: isinstance(x, ParamSpec))
            for table, fn in (("train", train_rules), ("serve", serve_rules)):
                r = MeshRules(mesh, fn(mesh))
                out[f"{{key}}/{{name}}/{{smoke}}/{{table}}"] = [list(r.spec_sharding(x).spec) for x in leaves]
print(json.dumps(out))
"""


def test_resolve_equals_reference_on_a_host_mesh():
    """The reference's rules over a real 8-device host mesh (its
    NamedShardings' specs), against the port's descriptors."""
    code = HOST_MESH_CODE.format(paths=[str(REPO / "tests"), str(REPO / "src")])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-4000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(want) == 2 * len(configs.ASSIGNED) * 2 * 2
    for k, specs in want.items():
        key, name, smoke, table = k.split("/")
        mesh = port_mesh(key)
        rules = MeshRules(mesh, (train_rules if table == "train" else serve_rules)(mesh))
        params, state = A.abstract_params(configs.get(name, smoke=smoke == "True"))
        leaves = tree_leaves(params) + tree_leaves(state)
        want = [port_order(s, as_spec(js)) for s, js in zip(leaves, specs, strict=True)]
        assert [rules.spec_sharding(s) for s in leaves] == want, k
