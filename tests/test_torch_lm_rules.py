"""The dense LMs' serving steps under mesh rules on real ranks: qwen3-0.6b
(GQA 4 / 2) and command-r-35b (8 / 2), SMOKE configs in f32, through
``launch/steps.build_cell(..., rules=MeshRules(mesh, serve_rules(mesh)))``
on 4 gloo ranks (``torch_ranks.lm_rule_steps``), against the reference's
``build_cell`` under ``jax.jit(in_shardings=prog.shardings())`` on 4 forced
host devices (a subprocess) and against the port's step without rules.

Meshes (2, 2), (1, 4) and (4, 1); prefill and decode, a ``long_*`` decode
at batch 1 (the cache's slots on (``data``, ``model``)) and an int8-cache
decode.  A decode starts from a cache of random entries whose length
``len`` lies inside a rank's slots, so its valid slots span ranks.  For
every case: the ranks' outputs put together equal the reference's and the
one-card step's (max|Δ| / max|ref| <= 1e-5; int8 entries exactly); each
rank's local shard is the reference's addressable shard at the same mesh
coordinate (the same slices of the global array, the same values); the
specs of ``prog.shardings()`` equal the reference's on every leaf; the new
token's slot is written by exactly one rank of those holding its batch
rows, in place.
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
from torch_ranks import F32, lm_case_arch, run_ranks

from repro_torch import arch as A
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import common, lm

RTOL = 1e-5
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1}}
PREFILL = ("p", "prefill", 4, 8)
DECODE = ("d", "decode", 4, 16)
LONG = ("long_s", "decode", 1, 32)


def case(arch: str, shape: tuple, mesh: str, *, quant: bool = False, length: int = 9) -> dict:
    return {"arch": arch, "shape": shape, "mesh": MESHES[mesh], "quant": quant, "len": length}


CASES = {
    "qwen3/prefill/2x2": case("qwen3-0.6b", PREFILL, "2x2"),
    "qwen3/prefill/1x4": case("qwen3-0.6b", PREFILL, "1x4"),
    "qwen3/prefill/4x1": case("qwen3-0.6b", PREFILL, "4x1"),
    "qwen3/decode/2x2": case("qwen3-0.6b", DECODE, "2x2"),
    "qwen3/decode/1x4": case("qwen3-0.6b", DECODE, "1x4"),
    "qwen3/decode/4x1": case("qwen3-0.6b", DECODE, "4x1"),
    "qwen3/decode_int8/2x2": case("qwen3-0.6b", DECODE, "2x2", quant=True, length=6),
    "qwen3/long/2x2": case("qwen3-0.6b", LONG, "2x2", length=13),
    "command-r/prefill/1x4": case("command-r-35b", PREFILL, "1x4"),
    "command-r/prefill/2x2": case("command-r-35b", PREFILL, "2x2"),
    "command-r/decode/1x4": case("command-r-35b", DECODE, "1x4", length=15),
    "command-r/decode/2x2": case("command-r-35b", DECODE, "2x2", quant=True),
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
from repro.models import lm as jlm
from repro.sharding.rules import MeshRules, serve_rules
from torch_ranks import F32, lm_case_arch
assert jax.device_count() == 4
jlm.jnp = F32(jnp, jnp.float32)
cases = pickle.load(open(sys.argv[1], "rb"))


def laid_out(a):
    full = np.asarray(a)
    shards = {{}}
    for sh in a.addressable_shards:
        where = tuple(int(i) for i in coord[sh.device.id])
        shards[where] = (np.asarray(sh.data), [[s.start or 0, n if s.stop is None else s.stop]
                                               for s, n in zip(sh.index, full.shape)])
    return full, shards


out = {{}}
for key, case in cases.items():
    mesh = make_host_mesh(**case["mesh"])
    coord = {{d.id: idx for idx, d in np.ndenumerate(mesh.devices)}}
    prog = steps.build_cell(lm_case_arch(JA, configs, case), case["shape"][0],
                            rules=MeshRules(mesh, serve_rules(mesh)))
    logits, cache = prog.jit()(*case["args"])
    specs = [[[[] if e is None else [e] if isinstance(e, str) else list(e) for e in sh.spec]
              for sh in jax.tree.leaves(s)] for s in prog.shardings()]
    out[key] = {{"shardings": specs, "logits": laid_out(logits), "cache": {{k: laid_out(v) for k, v in cache.items()}}}}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def case_args(c: dict, seed: int) -> tuple:
    """The step's arguments as numpy trees: the reference's random SMOKE
    weights (f32), tokens, and for a decode a cache of random entries
    (int8 and scales where quantized) filled up to ``len``."""
    _, params, _ = reference_params(c["arch"], seed)
    prog = steps.build_cell(lm_case_arch(A, configs, c), c["shape"][0])
    rng = np.random.default_rng(seed + 1)
    vocab = prog.meta["arch"].cfg.vocab
    if prog.kind == "prefill":
        _, _, B, S = c["shape"]
        return params, {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}

    def entry(s):
        if s.dtype == torch.int8:
            return rng.integers(-127, 128, s.shape).astype(np.int8)
        if s.dtype == torch.int32:
            return np.asarray(c["len"], np.int32)
        if s.init == "ones":
            return rng.uniform(0.004, 0.012, s.shape).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    cache = common.tree_map(entry, prog.arg_specs[1])
    return params, cache, {"token": rng.integers(0, vocab, (c["shape"][2], 1)).astype(np.int32)}


def one_card(c: dict) -> tuple:
    """The port's step without rules on the same arguments, in f32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "torch", F32(torch, torch.float32))
        prog = steps.build_cell(lm_case_arch(A, configs, c), c["shape"][0])
        logits, cache = prog(*(common.tree_map(lambda a: torch.from_numpy(np.array(a)), a) for a in c["args"]))
    return logits.numpy(), {k: v.numpy() for k, v in cache.items()}


def run_cases(tmp_path, cases: dict, seed: int) -> dict:
    """Every case on 4 port ranks and on the reference's 4 host devices, at
    once; the port without rules beside.  Returns per case (ranks,
    reference, one card)."""
    cases = {k: {**c, "args": case_args(c, seed + i)} for i, (k, c) in enumerate(cases.items())}
    job, result = tmp_path / "ref_cases.pkl", tmp_path / "ref_out.pkl"
    job.write_bytes(pickle.dumps(cases))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    code = REFERENCE.format(paths=[str(REPO / "tests"), str(REPO / "src")])
    ref = subprocess.Popen([sys.executable, "-c", code, str(job), str(result)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(tmp_path, 4, "torch_ranks:lm_rule_steps", cases, timeout=150)
        plain = {k: one_card(c) for k, c in cases.items()}
        _, err = ref.communicate(timeout=240)
        assert ref.returncode == 0, err[-4000:]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    want = pickle.loads(result.read_bytes())
    return {k: ([r[k] for r in ranks], want[k], plain[k]) for k in cases}


def assert_close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype in (np.int8, np.int32):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.astype(np.float64) - want).max()) / scale <= RTOL, what


def check_case(result: tuple) -> None:
    """The module docstring's checks on one case's results."""
    ranks, want, plain = result
    assert sorted(tuple(r["coord"]) for r in ranks) == sorted(want["logits"][1])
    for r in ranks:
        assert r["shardings"] == want["shardings"]
    outputs = {"logits": (lambda r: r["logits"], want["logits"], plain[0])}
    outputs |= {f"cache/{k}": ((lambda r, k=k: r["cache"][k]), want["cache"][k], plain[1][k]) for k in want["cache"]}
    for name, (pick, (ref_full, ref_shards), one) in outputs.items():
        full, covered = np.zeros(ref_full.shape, pick(ranks[0])[0].dtype), np.zeros(ref_full.shape, bool)
        for r in ranks:
            local, where = pick(r)
            ref_local, ref_where = ref_shards[tuple(r["coord"])]
            assert where == ref_where, (name, r["coord"], where, ref_where)
            assert_close(local, np.asarray(ref_local), f"{name} at {r['coord']}")
            full[tuple(slice(a, b) for a, b in where)] = local
            covered[tuple(slice(a, b) for a, b in where)] = True
        assert covered.all(), name
        assert_close(full, ref_full, name)
        assert_close(full, one, f"{name} against one card")
    if ranks[0]["changed"]:  # a decode: the new slot written by one rank of each batch group, in place
        for leaf in ("k", "v"):
            groups: dict = {}
            for r in ranks:
                groups.setdefault(tuple(map(tuple, r["cache"][leaf][1][:2])), []).append(r["changed"][leaf])
            assert all(sum(g) == 1 for g in groups.values()), (leaf, groups)
        assert all(r["in_place"] for r in ranks)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_rules"), CASES, seed=11)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_step_equals_reference_on_ranks(results, key):
    check_case(results[key])


GUARDED = {"qwen3/decode/2x2": CASES["qwen3/decode/2x2"], "qwen3/prefill/1x4": CASES["qwen3/prefill/1x4"],
           "qwen2-moe/prefill/2x2": case("qwen2-moe-a2.7b", PREFILL, "2x2"),
           "deepseek/long/2x2": case("deepseek-moe-16b", LONG, "2x2", length=20)}


def test_no_implicit_collective(tmp_path):
    """Ruled prefill and decode steps under ``CommDebugMode`` on 4 CPU
    ranks: every collective they issue comes from ``sharding.rules``'
    helpers (none from DTensor's own dispatch), there are some, and the
    helpers' tally (``rules.COLLECTIVES``) counts each."""
    cases = {k: {**c, "args": case_args(c, 50 + i)} for i, (k, c) in enumerate(GUARDED.items())}
    for rank in run_ranks(tmp_path, 4, "torch_ranks:comm_guard", cases, timeout=150):
        for key, r in rank.items():
            assert r["total"] > 0 and r["inside"] == r["total"] == r["tally"], (key, r)


@pytest.mark.parametrize("name,mesh", [("qwen2-moe-a2.7b", "2x2"), ("qwen3-0.6b", "1x4")])
def test_init_args_under_rules_are_the_unsharded_draw(tmp_path, name, mesh):
    """``init_args`` of a ruled decode cell on 4 ranks: every rank's slice of
    every leaf (weights drawn, the empty cache made as slices) equals the
    same slice of the unsharded draw exactly, and some leaves split;
    ``interop.place`` of ``interop.from_jax``'s weights lays them out
    alike."""
    _, params_np, _ = reference_params(name, 3)
    for r in run_ranks(tmp_path, 4, "torch_ranks:ruled_init", name, DECODE, MESHES[mesh], 5, params_np, timeout=120):
        assert all(r["equal"]) and r["split"] > 0 and all(r["from_jax"]), r
