"""The multi-device substrate on real ranks: ``launch/mesh`` meshes over a
gloo process group, ``sharding/rules`` placements and ``constrain``,
``models/common.shard`` under ``activation_rules``, and
``checkpoint/store.restore_resharded``, against the reference over forced
host devices.

Each mesh, (2, 2), (2, 4) and (2, 2, 2), runs as that many ranks of the
port (``torch_ranks``, one process a rank) beside a subprocess of the
reference over as many host devices.  Both restore one checkpoint's values
(the SMOKE qwen3-0.6b and resnet-50 params and state; a conv weight stored
OIHW by the port, HWIO by the reference) onto the mesh under
``train_rules``: each rank's local shard of every leaf must equal, byte for
byte, the reference's addressable shard at the same mesh coordinate (a
conv shard compared in the port's order).  ``shard`` of a DTensor must
land on the spec the reference's ``with_sharding_constraint`` gives, values
unchanged.  In this process (no group): the raises, and the descriptors.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from test_torch_ref import REPO  # installs the jax 0.9 shims first

import numpy as np
import pytest
import torch
from torch_ranks import run_ranks, spec_tree

from repro import checkpoint as jck
from repro_torch import arch as A
from repro_torch import checkpoint as ck
from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.models import common
from repro_torch.sharding import MeshRules, Sharding, sweep_rules, train_rules

MESHES = {"2x2": {"data": 2, "model": 2}, "2x4": {"data": 2, "model": 4}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
SHARD_CASES = {  # (shape, logical axes, the spec the DTensor starts on)
    "2x2": [((8, 4, 16), ("batch", "seq", "embed"), ()), ((8, 16), ("batch", "mlp"), ("model",)),
            ((4, 8, 16), ("batch", "act_seq", "heads"), (None, "data"))],
    "2x4": [((8, 4, 16), ("batch", "seq", "embed"), ()), ((6, 16), ("batch", "mlp"), (None, "model")),
            ((4, 8, 16), ("batch", "act_seq", "heads"), ("model",))],
    "2x2x2": [((8, 16, 4), ("batch", "long_kv_seq", None), ()), ((8, 16), ("embed", "mlp"), (("pod", "data"),)),
              ((16, 8), ("batch", "kv_heads"), (None, ("data", "model")))],
}
STEP = 3

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
sys.path[:0] = {paths!r}
import json
import test_torch_ref  # the jax 0.9 shims
import jax
import jax.numpy as jnp
import numpy as np
from repro import arch as JA, checkpoint as ck, configs
from repro.launch.mesh import make_host_mesh
from repro.models.common import ParamSpec, activation_rules, shard
from repro.sharding.rules import MeshRules, train_rules
from torch_ranks import digest, spec_tree
ckpt, mesh_args, cases = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
mesh = make_host_mesh(**mesh_args)
assert mesh.devices.size == {n}
rules = MeshRules(mesh, train_rules(mesh))
is_spec = lambda x: isinstance(x, ParamSpec)
specs = spec_tree(JA.abstract_params, configs.get)
like = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), specs, is_leaf=is_spec)
tree, _ = ck.restore_resharded(ckpt, {step}, like, rules.tree_shardings(specs))
coord = {{d.id: [int(i) for i in idx] for idx, d in np.ndenumerate(mesh.devices)}}
leaves = []
for arr, s in zip(jax.tree.leaves(tree), jax.tree.leaves(specs, is_leaf=is_spec)):
    per = {{}}
    for sh in arr.addressable_shards:
        a = np.asarray(sh.data)
        if s.init == "conv":  # HWIO -> the port's OIHW
            n = a.ndim - 4
            a = a.transpose(*range(n), n + 3, n + 2, n, n + 1)
        per[json.dumps(coord[sh.device.id])] = digest(a)
    leaves.append(per)
shards = []
for shape, axes, _ in cases:
    x = jnp.arange(int(np.prod(shape)), dtype=jnp.float32).reshape(shape)
    with activation_rules(rules):
        y = jax.jit(lambda v: shard(v, *axes))(x)
    spec = [[] if e is None else [e] if isinstance(e, str) else list(e) for e in y.sharding.spec]
    while spec and not spec[-1]:
        spec.pop()
    shards.append(spec)
print(json.dumps({{"leaves": leaves, "shards": shards}}))
"""


def write_checkpoints(tmp_path):
    """One draw of every leaf, saved by each package in its own layout."""
    rng = np.random.default_rng(7)
    specs = spec_tree(A.abstract_params, configs.get)
    port = common.tree_map(lambda s: torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32)), specs)

    def to_hwio(s, t):
        a = t.numpy()
        if s.init != "conv":
            return a
        n = a.ndim - 4
        return np.ascontiguousarray(a.transpose(*range(n), n + 2, n + 3, n + 1, n))  # OIHW -> HWIO

    ck.save(tmp_path / "port", STEP, port)
    jck.save(tmp_path / "ref", STEP, common.tree_map(to_hwio, specs, port))
    return tmp_path / "port", tmp_path / "ref"


def start_reference(key: str, ckpt) -> subprocess.Popen:
    n = int(np.prod(list(MESHES[key].values())))
    code = REFERENCE.format(n=n, step=STEP, paths=[str(REPO / "tests"), str(REPO / "src")])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    cases = [[list(s), list(a), list(st)] for s, a, st in SHARD_CASES[key]]
    return subprocess.Popen([sys.executable, "-c", code, str(ckpt), json.dumps(MESHES[key]), json.dumps(cases)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_restore_resharded_and_shard_equal_the_reference_on_real_ranks(tmp_path):
    assert any(s.init == "conv" for s in common.tree_leaves(spec_tree(A.abstract_params, configs.get)))
    port_ckpt, ref_ckpt = write_checkpoints(tmp_path)
    refs = {key: start_reference(key, ref_ckpt) for key in MESHES}
    try:
        got = {key: run_ranks(tmp_path / key, int(np.prod(list(m.values()))), "torch_ranks:mesh_checks",
                              str(port_ckpt), STEP, m, SHARD_CASES[key]) for key, m in MESHES.items()}
        want = {}
        for key, p in refs.items():
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-4000:]
            want[key] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for key, ranks in got.items():
        n = len(ranks)
        assert sorted(json.dumps(r["coord"]) for r in ranks) == sorted(want[key]["leaves"][0])
        split = 0
        for r in ranks:
            where = json.dumps(r["coord"])
            for i, (leaf, ref) in enumerate(zip(r["leaves"], want[key]["leaves"], strict=True)):
                assert leaf == ref[where], (key, where, i)
            split += sum(leaf[0] != full for leaf, full in zip(r["leaves"], ranks[0]["leaves"]))
            for (spec, local, same), ref_spec, (shape, _, _) in zip(r["shards"], want[key]["shards"],
                                                                   SHARD_CASES[key], strict=True):
                assert spec == ref_spec, (key, shape)
                assert same
                assert int(np.prod(local)) * int(np.prod([
                    np.prod([MESHES[key][a] for a in e]) for e in spec])) == int(np.prod(shape))
            assert f"has {n + 1} devices" in r["size_error"]
        assert any(len(spec) > 0 for spec, _, _ in ranks[0]["shards"])
        assert split > 0  # some leaf differs in shape between ranks: it is sharded


def test_elastic_restart_on_one_rank(tmp_path):
    """tests/test_elastic.py's story on a one-rank group: the restart
    restores with ``restore_resharded`` (no shardings) and ends on the
    straight run's loss."""
    ((straight, restarted, step, plan),) = run_ranks(tmp_path, 1, "torch_ranks:elastic_restart", str(tmp_path / "ck"))
    assert step == 4 and plan == [18, 16]
    assert restarted == straight


def test_placements_and_raises():
    """Without a process group meshes stay descriptors; placements follow
    the spec; a tuple out of mesh order and a plain tensor over a mesh of
    several devices raise."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = M.make_host_mesh(2, 2, pod=2)
    assert mesh.device_mesh is None and mesh.size == 8
    rules = MeshRules(mesh, train_rules(mesh))
    spec = rules.logical((8, 16, 4), ("batch", "long_kv_seq", None))
    assert isinstance(spec, Sharding) and spec == (("pod", "data"), "model") and spec.mesh is mesh
    assert rules.placements(spec) == [Shard(0), Shard(0), Shard(1)]
    assert rules.placements(()) == [Replicate()] * 3
    out_of_order = MeshRules(mesh, {"x": ("model", "data")})
    with pytest.raises(ValueError, match="not in mesh order"):
        out_of_order.placements(out_of_order.logical((8,), ("x",)))
    x = torch.ones(8, 16)
    with pytest.raises(ValueError, match=r"\('batch', 'mlp'\)"):
        rules.constrain(x, ("batch", "mlp"))
    with common.activation_rules(rules), pytest.raises(ValueError, match="plain tensor"):
        common.shard(x, "batch", "mlp")
    assert common.current_rules() is None and common.shard(x, "batch") is x
    one = M.make_host_mesh()
    with common.activation_rules(MeshRules(one, train_rules(one))) as r:
        assert common.current_rules() is r and common.shard(x, "batch", "mlp") is x


def test_sweep_mesh_and_rules_without_a_group():
    mesh = M.make_sweep_mesh()
    assert (mesh.axis_names, mesh.size, mesh.device_mesh) == (("scenario",), 1, None)
    assert sweep_rules(mesh) == {"scenario": ("scenario",)}
    prod = M.make_production_mesh(multi_pod=True)
    assert sweep_rules(prod) == {"scenario": ("pod", "data")}
    assert MeshRules(prod, sweep_rules(prod)).logical((96,), ("scenario",)) == (("pod", "data"),)
    assert MeshRules(prod, sweep_rules(prod)).logical((33,), ("scenario",)) == ()  # replicated, never mis-sharded


def test_resolve_device_gives_a_rank_its_card(monkeypatch):
    """Under a process group "cuda" is ``cuda:{LOCAL_RANK % device_count}``
    (the global rank where ``LOCAL_RANK`` is unset); a named card, the CPU
    and no group are left alone."""
    from repro_torch import device as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert D.resolve_device("cuda") == torch.device("cuda")
    monkeypatch.setattr(D.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(D.dist, "get_rank", lambda: 3)
    assert D.resolve_device("cuda") == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert D.resolve_device("cuda") == torch.device("cuda", 0)
    assert D.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert D.resolve_device("cpu") == torch.device("cpu")
