"""The dry run over meshes (``launch/dryrun`` with ``--mesh`` or
``--submesh``): each cell traced on ``meta`` as one rank of a fake process
group of the mesh's size, against the reference's compiles on 8 forced
host devices and against real ranks.

* Argument bytes: each rank's ``memory.argument_bytes`` ``==`` the
  reference's ``compiled.memory_analysis().argument_size_in_bytes`` on the
  (2, 2, 2) and (2, 4) meshes, SMOKE configs: the three cells of
  ``tests/test_system.py``'s 8-device dry run, DiT-XL/2's and Flux-dev's
  ``denoise_step``, ViT-S/16's ``classify_serve`` and qwen3-0.6b's
  ``prefill``.  Each cell's collectives by kind are printed beside the
  reference's ``parse_collectives`` (a reading; the programs differ: the
  reference's partitioner picks its own collectives), and both totals must
  be > 0.
* The count is the real count: the collectives ``sharding.rules`` issues a
  step on a ``meta`` rank ``==`` those 4 gloo ranks on the CPU issue
  running the same step (a serving LM, a diffusion and a training step).
* Invariants: a mesh record's global keys ``==`` the one-card record's;
  rank 0 and the last rank trace the same counts; at a fake world of one
  the ruled trace equals the unruled one, peak included; the reference's
  ``kv_gather_s_analytic`` appears where its condition holds and is counted
  once.
* The CLI: ``--mesh single``, ``--mesh multi`` and ``--submesh 4x4`` write
  the reference's record for a full-size decode cell; a dry run in a
  process with a real process group refuses.

Every process group, fake or gloo, lives in a subprocess.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

from test_torch_ref import REPO  # installs the jax 0.9 shims first

import pytest
from torch_ranks import run_ranks

from repro_torch.launch import analysis, dryrun

CELLS = {  # name -> (arch, ShapeSpec fields): SMOKE configs at small shapes
    "qwen2-moe/train": ("qwen2-moe-a2.7b", ("t", "train", 8, 64, 0)),
    "qwen3/decode": ("qwen3-0.6b", ("d", "decode", 8, 128, 0)),
    "resnet-50/classify_train": ("resnet-50", ("c", "classify_train", 8, 0, 32)),
    "dit/denoise_step": ("dit-xl2", ("g", "denoise_step", 8, 0, 64)),
    "flux/denoise_step": ("flux-dev", ("g", "denoise_step", 8, 0, 64)),
    "vit/classify_serve": ("vit-s16", ("s", "classify_serve", 8, 0, 32)),
    "qwen3/prefill": ("qwen3-0.6b", ("p", "prefill", 8, 64, 0)),
}
MESHES = {"2x2x2": {"pod": 2, "data": 2, "model": 2}, "2x4": {"data": 2, "model": 4}}
REAL = ("qwen3/decode", "dit/denoise_step", "qwen2-moe/train")  # held against 4 gloo ranks on (2, 2)
ALIKE = ("qwen3/decode", "resnet-50/classify_train", "flux/denoise_step")
GLOBAL_KEYS = ("flops_jaxpr", "dot_flops", "bytes_jaxpr", "bytes_jaxpr_flash", "model_flops", "useful_compute_ratio",
               "top_cost_sites", "n_params")
RECORD_KEYS = {"arch", "shape", "kind", "mesh", "chips", "lower_s", "compile_s", "memory", "fits", "flops_jaxpr",
               "bytes_jaxpr", "bytes_jaxpr_flash", "collectives", "collectives_flash", "top_collectives",
               "top_collectives_flash", "top_cost_sites", "roofline", "roofline_no_flash_kernel", "model_flops",
               "useful_compute_ratio", "n_params"}
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]), "OMP_NUM_THREADS": "1"}

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, pickle
import test_torch_ref  # the jax 0.9 shims
import jax
from repro import arch as JA, configs
from repro.launch import analysis, steps
from repro.launch.mesh import make_host_mesh
from repro.sharding.rules import MeshRules, serve_rules, train_rules
from repro.train.optim import AdamWConfig
assert jax.device_count() == 8
cells, meshes = pickle.load(open(sys.argv[1], "rb"))
out = {}
for key, (name, fields) in cells.items():
    spec = JA.ShapeSpec(*fields)
    arch = dataclasses.replace(configs.get(name, smoke=True), shapes=(spec,))
    for mesh_name, mesh_args in meshes.items():
        mesh = make_host_mesh(**mesh_args)
        table = (train_rules if "train" in spec.kind else serve_rules)(mesh)
        table.update(arch.sharding_overrides or {})
        prog = steps.build_cell(arch, spec.name, rules=MeshRules(mesh, table), adamw=AdamWConfig())
        with jax.set_mesh(mesh):
            compiled = prog.jit().lower(*prog.abstract_args()).compile()
        mem = compiled.memory_analysis()
        out[key, mesh_name] = {"argument_bytes": mem.argument_size_in_bytes,
                               "collectives": analysis.parse_collectives(compiled.as_text())}
pickle.dump(out, open(sys.argv[2], "wb"))
"""

PORT = """
import dataclasses, pickle, sys
from repro_torch import arch as A, configs
from repro_torch.launch import dryrun, steps
from repro_torch.models import lm
from repro_torch.models.common import local
cells, meshes, real, alike = pickle.load(open(sys.argv[1], "rb"))


def arch_of(name, fields):
    spec = A.ShapeSpec(*fields)
    return dataclasses.replace(configs.get(name, smoke=True), shapes=(spec,)), spec.name


def trace_fields(t):
    return {"flops": t.costs.flops, "bytes": t.costs.bytes, "dot_flops": t.dot_flops, "arguments": t.argument_bytes,
            "outputs": t.output_bytes, "alias": t.alias_bytes, "peak": t.peak_bytes, "collectives": t.collectives}


out = {"records": {}, "real": {}, "last": {}, "one": {}, "world1": {}, "kv": {}}
for key, (name, fields) in cells.items():
    arch, shape = arch_of(name, fields)
    traced = dryrun.global_traces(arch, shape)
    out["one"][key] = dryrun.record(arch, shape, global_=traced)
    for mesh in meshes:
        out["records"][key, mesh] = dryrun.record(arch, shape, mesh=mesh, global_=traced)
    if key in real:
        out["real"][key] = dryrun.record(arch, shape, mesh="2x2", global_=traced)["rules_collectives"]
    if key in alike:
        out["last"][key] = dryrun.record(arch, shape, mesh="2x4", rank=7, global_=traced)
        with dryrun.fake_rank("1x1") as mesh:
            plain, flash, issued = dryrun.traces(dryrun.rank_program(arch, shape, mesh))
        out["world1"][key] = {"ruled": [trace_fields(plain), trace_fields(flash), issued],
                              "unruled": [trace_fields(t) for t in traced]}

seen = []
real_unshard = lm._unshard_seq


def unshard(c, h):
    y = real_unshard(c, h)
    seen.append((tuple(local(h).shape), tuple(local(y).shape)))
    return y


lm._unshard_seq = unshard
for kind, fields in (("train", ("t", "train", 8, 64, 0)), ("prefill", ("p", "prefill", 8, 64, 0)),
                     ("decode", ("d", "decode", 8, 64, 0))):
    for name in ("command-r-35b", "qwen3-0.6b"):
        arch, shape = arch_of(name, fields)
        traced = dryrun.global_traces(arch, shape)
        seen.clear()
        rec = dryrun.record(arch, shape, mesh="2x2", global_=traced)  # the rank's traces: its _unshard_seq calls
        out["kv"][name, kind] = {"record": rec, "one": dryrun.record(arch, shape, global_=traced), "unshard": list(seen),
                                 "cfg": dataclasses.asdict(arch.cfg)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _run(tmp_path, name: str, code: str, payload, timeout: float = 300.0):
    job, result = tmp_path / f"{name}_in.pkl", tmp_path / f"{name}_out.pkl"
    job.write_bytes(pickle.dumps(payload))
    out = subprocess.run([sys.executable, "-c", code, str(job), str(result)], capture_output=True, text=True,
                         timeout=timeout, env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    return pickle.loads(result.read_bytes())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("ref"), "ref", REFERENCE, (CELLS, MESHES), timeout=600.0)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("port"), "port", PORT, (CELLS, list(MESHES), REAL, ALIKE))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_reference(reference, port, cell, mesh):
    got, want = port["records"][cell, mesh], reference[cell, mesh]
    print(f"{cell}@{mesh}: port {got['collectives']['by_kind']} ({got['collectives']['op_sites']} ops, "
          f"{got['rules_collectives']}); reference {want['collectives']['by_kind']} "
          f"({want['collectives']['op_sites']} ops)")
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    assert (got["mesh"], got["chips"]) == (mesh, 8)
    assert got["collectives"]["total_bytes"] > 0 and want["collectives"]["total_bytes"] > 0
    assert sum(got["rules_collectives"].values()) > 0
    assert got["memory"]["peak_bytes"] >= got["memory"]["argument_bytes"] > 0


@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    cases = {key: (CELLS[key][0], CELLS[key][1], {"data": 2, "model": 2}) for key in REAL}
    return run_ranks(tmp_path_factory.mktemp("real"), 4, "torch_ranks:ruled_collectives", cases, timeout=240.0)


@pytest.mark.parametrize("cell", REAL)
def test_meta_rank_counts_the_real_ranks_collectives(port, real_ranks, cell):
    """What a ``meta`` rank counts a step is what each of 4 gloo ranks
    issues running the step on values."""
    got = port["real"][cell]
    assert sum(got.values()) > 0
    for r, issued in enumerate(real_ranks):
        assert issued[cell] == got, (r, issued[cell], got)


@pytest.mark.parametrize("cell", CELLS)
def test_global_keys_equal_one_card_record(port, cell):
    one = port["one"][cell]
    assert one["collectives"]["total_bytes"] == 0 and (one["mesh"], one["chips"]) == ("1x1", 1)
    for mesh in MESHES:
        rec = port["records"][cell, mesh]
        assert {k: rec[k] for k in GLOBAL_KEYS} == {k: one[k] for k in GLOBAL_KEYS}
        assert rec["roofline"]["compute_s"] == pytest.approx(one["roofline"]["compute_s"] / 8, rel=1e-12)
        assert rec["roofline"]["collective_s"] == rec["collectives_flash"]["est_seconds"] > 0


@pytest.mark.parametrize("cell", ALIKE)
def test_first_and_last_rank_trace_alike(port, cell):
    first, last = port["records"][cell, "2x4"], port["last"][cell]
    assert last["rank"] == 7 and first["rank"] == 0
    for key in ("memory", "collectives", "collectives_flash", "rules_collectives", "top_collectives", "fits"):
        assert first[key] == last[key], key


@pytest.mark.parametrize("cell", ALIKE)
def test_world_of_one_equals_unruled_trace(port, cell):
    """Under rules on a mesh of one device every leaf is a DTensor holding
    the whole: the counts, the peak included, are one card's."""
    w = port["world1"][cell]
    plain, flash, issued = w["ruled"]
    assert issued == {}
    assert [plain, flash] == w["unruled"]


def test_kv_gather_analytic_counted_once(port):
    """The reference's analytic K/V gather: recorded for an LM prefill or
    train cell with 2·KH·hd < D (the SMOKE command-r: 2·2·8 < 64), at the
    reference's formula, never for qwen3 (2·2·16 = 64), a decode or a one-card
    record.  The port gathers each sublayer's input sequence
    (``lm._unshard_seq``) before it computes K and V, so a train rank's trace
    holds the gather (the same all-gathers with and without the flash stub:
    the stub drops none) and a prefill rank holds the whole sequence: the
    term is not added again."""
    for (name, kind), r in port["kv"].items():
        rec, cfg = r["record"], r["cfg"]
        flash = rec["collectives_flash"]
        assert "kv_gather_s_analytic" not in r["one"]["collectives_flash"]
        priced = sum(analysis._OP_FACTOR[k] * b / analysis.LINK_BW for k, b in flash["by_kind"].items())
        assert flash["est_seconds"] == pytest.approx(priced, rel=1e-12)
        regime = name == "command-r-35b" and kind != "decode"
        assert ("kv_gather_s_analytic" in flash) == regime, (name, kind)
        if regime:
            traversals = 3 if kind == "train" else 1
            want = 2 * 64 * cfg["n_kv_heads"] * (cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]) * 2 * \
                cfg["n_layers"] * traversals / analysis.LINK_BW
            assert flash["kv_gather_s_analytic"] == pytest.approx(want, rel=1e-12)
        if kind == "train":  # the rank gathers the whole sequence before each sublayer: 64 = 2 x 32 rows
            assert r["unshard"] and all(a[1] * 2 == b[1] == 64 for a, b in r["unshard"]), r["unshard"]
            assert flash["by_kind"]["all-gather"] == rec["collectives"]["by_kind"]["all-gather"]
        if kind == "prefill":  # the rank holds the whole sequence: nothing to gather
            assert all(a == b for a, b in r["unshard"])


def test_mesh_names():
    assert dryrun.mesh_axes("16x16") == (("data", "model"), (16, 16))
    assert dryrun.mesh_axes("2x16x16") == (("pod", "data", "model"), (2, 16, 16))
    assert dryrun.mesh_axes("4X4") == (("data", "model"), (4, 4))
    for bad in ("16", "2x2x2x2", "0x4", "axb"):
        with pytest.raises(ValueError):
            dryrun.mesh_axes(bad)
    assert dryrun.MESHES == {"single": ("16x16",), "multi": ("2x16x16",), "both": ("16x16", "2x16x16")}


@pytest.mark.parametrize("argv,mesh,chips", [(["--mesh", "single"], "16x16", 256),
                                             (["--mesh", "multi"], "2x16x16", 512),
                                             (["--submesh", "4x4"], "4x4", 16)])
def test_cli_writes_mesh_record(tmp_path, argv, mesh, chips):
    """The full-size qwen3-0.6b decode_32k on a mesh: the reference's record,
    one device's memory and collectives."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b", "--shape",
                          "decode_32k", "--out", str(tmp_path), *argv],
                         capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "1 cells OK, 0 failed" in out.stdout
    rec = json.loads((tmp_path / f"{mesh}__qwen3-0.6b__decode_32k.json").read_text())
    assert RECORD_KEYS <= rec.keys()
    assert (rec["mesh"], rec["chips"], rec["rank"]) == (mesh, chips, 0)
    cache = 2 * 28 * 128 * 32768 * 8 * 128 * 2  # k and v, bf16, split over data (batch) and model (slots)
    data, model = {"16x16": (16, 16), "2x16x16": (32, 16), "4x4": (4, 4)}[mesh]
    assert rec["memory"]["alias_bytes"] == cache // (data * model)  # the rank's slice, written in place
    assert rec["fits"] and rec["collectives"]["total_bytes"] > 0 and rec["top_collectives"]
    assert rec["roofline"]["bottleneck"] == "memory_s"
    assert "kv_gather_s_analytic" not in rec["collectives_flash"]


def test_refuses_a_real_process_group(tmp_path):
    code = ("import sys, torch.distributed as dist\n"
            "from repro_torch.launch import dryrun\n"
            "dist.init_process_group('gloo', store=dist.FileStore(sys.argv[1], 1), rank=0, world_size=1)\n"
            "try:\n"
            "    dryrun.run_cell('qwen3-0.6b', 'decode_32k', out_dir=None, smoke=True, mesh='2x2')\n"
            "except RuntimeError as e:\n"
            "    print('refused:', e)\n"
            "dist.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "store")], capture_output=True, text=True,
                         timeout=120, env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "refused: a dry run over 2x2 starts a fake process group of its own" in out.stdout
