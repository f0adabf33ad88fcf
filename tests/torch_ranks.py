"""Run a function of the port on W ranks, each its own process, joined in a
gloo process group through a ``FileStore`` (no port to race for under
``pytest -n``), and hand back what each rank returned.  Also the rank
functions the multi-rank tests call: this module imports ``torch`` and
``repro_torch`` only, so a rank starts without JAX.

    results = run_ranks(tmp_path, 4, "torch_ranks:run_cases", cases)

Every rank gets ``OMP_NUM_THREADS=1`` (W ranks beside the test workers) and
a timeout: a rank that fails or hangs fails the test with its stderr.  A
rank that finished meets the others at a barrier, tears the group down and
leaves with ``os._exit``: gloo's teardown during interpreter exit aborts a
rank now and then (``terminate called without an active exception``; 11
of 30 runs of 4 ranks that build a ``DeviceMesh``, 1 of 30 with the
barrier, 0 of 30 with ``os._exit``, torch 2.13 on the CPU).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

RANK_MAIN = """
import faulthandler, os, pickle, sys
import torch.distributed as dist
faulthandler.enable()
rank, world, store, job, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
with open(job, "rb") as fh:
    target, args = pickle.load(fh)
module, name = target.split(":")
result = getattr(__import__(module, fromlist=[name]), name)(*args)
dist.barrier()
dist.destroy_process_group()
with open(out, "wb") as fh:
    pickle.dump(result, fh)
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)  # gloo's teardown during interpreter exit aborts a rank now and then
"""


def run_ranks(tmp: Path, world: int, target: str, *args, timeout: float = 120.0, env: dict | None = None) -> list:
    """``target`` ("module:function", importable with ``src`` and ``tests``
    on the path) called with ``args`` on each of ``world`` ranks; the
    results in rank order."""
    tmp = Path(tmp) / f"ranks_{target.replace(':', '_')}_{world}"
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pkl"
    job.write_bytes(pickle.dumps((target, args)))
    run_env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]),
               "OMP_NUM_THREADS": "1", **(env or {})}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        run_env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, str(r), str(world), str(tmp / "store"), str(job),
                               str(tmp / f"out{r}.pkl")], env=run_env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors, deadline = [], time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errors:
        raise AssertionError("\n".join(errors))
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes()) for r in range(world)]


# ---------------------------------------------------------------------------
# Rank functions.
# ---------------------------------------------------------------------------


def report_rows(report) -> list:
    """Every stream of every point: the deterministic stats ``run_sweep``
    reports, then the point's meta but for wall time (tests/test_sweep_scale.py's
    DET_FIELDS)."""
    rows = []
    for p in report.points:
        for s in p.streams:
            rows.append([s.frames_total, s.frames_processed, s.frames_missed_deadline, s.frames_offloaded,
                         s.accuracy_sum, s.elapsed, s.schedule_calls, s.npu_busy_s])
        rows.append({k: v for k, v in p.meta.items() if k not in ("schedule_time",)})
    return rows


def run_cases(cases: dict) -> dict:
    """Each case ``name -> (spec JSON, grid JSON, mode)`` through
    ``Session.run_sweep`` on the CPU: its rows and its groups' records."""
    from repro_torch.session import ScenarioSpec, Session, SweepGrid

    out = {}
    for name, (spec, grid, mode) in cases.items():
        report = Session(ScenarioSpec.from_json(spec), device="cpu").run_sweep(
            SweepGrid.from_json(grid), backend="batched", mode=mode)
        out[name] = (report_rows(report), report.meta.get("groups", []))
    return out


ARCHS = ("qwen3-0.6b", "resnet-50")


def spec_tree(abstract_params, get) -> dict:
    """Params and state of the SMOKE ``ARCHS``, as one tree; either
    package's ``arch.abstract_params`` and ``configs.get``."""
    return {name: dict(zip(("params", "state"), abstract_params(get(name, smoke=True)))) for name in ARCHS}


def digest(a) -> list:
    """Shape and a hash of the bytes of a C-ordered float32 array."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    return [list(a.shape), str(a.dtype), hashlib.sha256(a.tobytes()).hexdigest()]


def spec_of(placements, names) -> list:
    """Per tensor dim, the mesh axes that shard it (in mesh order): the
    reference's PartitionSpec entries, each a list, trailing empties cut."""
    out: list = []
    for i, p in enumerate(placements):
        if p.is_shard():
            out += [[] for _ in range(p.dim + 1 - len(out))]
            out[p.dim].append(names[i])
    while out and not out[-1]:
        out.pop()
    return out


def mesh_checks(ckpt: str, step: int, mesh_args: dict, shard_cases: list) -> dict:
    """On a real ``make_host_mesh(**mesh_args)``: this rank's coordinate;
    the digest of its local shard of every leaf of ``restore_resharded``
    under ``train_rules``; and for each ``(shape, axes, start)`` of
    ``shard_cases``, an ``arange`` placed as the spec ``start`` resolves,
    then ``shard(x, *axes)`` under ``activation_rules``: its spec, its local
    shape, and whether its values are unchanged."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import arch as A
    from repro_torch import checkpoint as ck
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh, world_size
    from repro_torch.models.common import activation_rules, shard, tree_leaves, tree_map
    from repro_torch.sharding import MeshRules, train_rules

    mesh = make_host_mesh(**mesh_args, device="cpu")
    rules = MeshRules(mesh, train_rules(mesh))
    specs = spec_tree(A.abstract_params, configs.get)
    like = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), specs)
    tree, _ = ck.restore_resharded(ckpt, step, like, rules.tree_shardings(specs))
    out = {"coord": list(mesh.device_mesh.get_coordinate()),
           "leaves": [digest(t.to_local().numpy()) for t in tree_leaves(tree)],
           "shards": []}
    for shape, axes, start in shard_cases:
        x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        dt = distribute_tensor(x, mesh.device_mesh, rules.placements(tuple(start)), src_data_rank=None)
        with activation_rules(rules):
            y = shard(dt, *axes)
        out["shards"].append((spec_of(y.placements, mesh.axis_names), list(y.to_local().shape),
                              bool(torch.equal(y.full_tensor(), x))))
    try:
        make_host_mesh(data=world_size() + 1, device="cpu")
    except ValueError as e:
        out["size_error"] = str(e)
    return out


def elastic_restart(ckpt: str) -> tuple:
    """tests/test_elastic.py on one rank: a smoke ResNet-50 trains 6 steps
    with a checkpoint after the 4th; the restart re-plans the mesh,
    ``restore_resharded`` with no shardings and runs steps 5-6 again.
    Returns (the straight run's last loss, the restarted run's, the step
    restored, the re-planned mesh)."""
    import dataclasses

    import torch

    from repro_torch import arch as A
    from repro_torch import checkpoint as ck
    from repro_torch import configs
    from repro_torch.data import DataSpec, SyntheticStream
    from repro_torch.launch import steps
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import plan_elastic_remesh
    from repro_torch.train.optim import AdamWConfig

    a = dataclasses.replace(configs.get("resnet-50", smoke=True),
                            shapes=(A.ShapeSpec("t", "classify_train", 4, img=32),))
    prog = steps.build_cell(a, "t", adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20))
    stream = SyntheticStream(DataSpec(a, a.shape("t"), seed=0))

    def batch(i):
        return {k: torch.as_tensor(v) for k, v in stream.batch_at(i).items()}

    ts = prog.init_arg(0, 0, "cpu")
    for i in range(6):
        ts, m = prog(ts, batch(i))
        if i == 3:
            ck.save(ckpt, 4, ts)
    straight = float(m["loss"])
    plan = plan_elastic_remesh(300)
    last = ck.latest_step(ckpt)
    like = prog.init_arg(0, 0, "cpu")
    ts2, _ = ck.restore_resharded(ckpt, last, like, tree_map(lambda x: None, like))
    restored = int(ts2["opt"]["step"])
    for i in range(4, 6):
        ts2, m = prog(ts2, batch(i))
    return straight, float(m["loss"]), restored, list(plan.mesh_shape)


def constrain_roundtrip(device: str = "cpu") -> list:
    """``MeshRules.constrain`` of a DTensor over ranks on a ``(data, model)``
    mesh of (world, 1) on ``device``: replicated -> ``Shard(0)`` on data ->
    replicated again.  Returns each step's placements (as text), local
    shape, and whether its values are still the tensor's."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, world_size
    from repro_torch.sharding import MeshRules, train_rules

    mesh = make_host_mesh(data=world_size(), model=1, device=device)
    rules = MeshRules(mesh, train_rules(mesh))
    x = torch.arange(8.0 * 4 * world_size(), device=resolve_device(device)).reshape(8 * world_size(), 4)
    dt = distribute_tensor(x, mesh.device_mesh, [Replicate(), Replicate()], src_data_rank=None)
    out = []
    for axes in (("batch", None), (None, None)):
        dt = rules.constrain(dt, axes)
        out.append((str(dt.placements), list(dt.to_local().shape), str(dt.device),
                    bool(torch.equal(dt.full_tensor(), x))))
    return out


class F32:
    """A stand-in for a module's ``torch`` whose ``bfloat16`` is float32, so
    a step that casts to bf16 computes in f32 (tests/test_torch_lm.py's)."""

    def __init__(self, mod, f32):
        self._mod, self.bfloat16 = mod, f32

    def __getattr__(self, name):
        return getattr(self._mod, name)


def lm_case_arch(A, configs, case: dict):
    """The SMOKE arch of ``case`` cut to its one shape, with its cache's
    quantization; either package's ``arch`` and ``configs``."""
    import dataclasses

    shape = A.ShapeSpec(*case["shape"])
    arch = dataclasses.replace(configs.get(case["arch"], smoke=True), shapes=(shape,))
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, kv_quant=case["quant"]))


def serve_case_arch(A, configs, case: dict):
    """The SMOKE arch of a diffusion or classifier ``case`` cut to its one
    shape, its config replaced by ``case["cfg"]`` where given; either
    package's ``arch`` and ``configs``."""
    import dataclasses

    shape = A.ShapeSpec(*case["shape"])
    arch = dataclasses.replace(configs.get(case["arch"], smoke=True), shapes=(shape,))
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **case.get("cfg", {})))


def case_arch(A, configs, case: dict):
    """An LM case's arch (it names its cache's quantization), else a
    diffusion or classifier case's."""
    return (lm_case_arch if "quant" in case else serve_case_arch)(A, configs, case)


def in_f32(torch) -> None:
    """Every model module of the port computes in f32 (``F32``)."""
    from repro_torch.models import convnets, diffusion, lm, vision

    for mod in (lm, diffusion, vision, convnets):
        mod.torch = F32(torch, torch.float32)


def laid_out(t) -> list:
    """A DTensor's local tensor as numpy, with the [start, stop) of each dim
    it holds of the global array."""
    from repro_torch.models.common import local, local_slice

    return [local(t).float().numpy() if t.is_floating_point() else local(t).numpy(),
            [[s.start, s.stop] for s in (local_slice(t, d)[0] for d in range(t.dim()))]]


def spec_lists(shardings) -> list:
    """Resolved specs as lists of lists (one per dim, its mesh axes)."""
    from repro_torch.models.common import tree_leaves

    return [[[] if e is None else [e] if isinstance(e, str) else list(e) for e in s] for s in tree_leaves(shardings)]


def lm_rule_steps(cases: dict) -> dict:
    """Each case of ``cases`` (arch, shape, mesh, quant, the step's numpy
    arguments) through ``build_cell(..., rules=MeshRules(mesh, serve_rules))``
    on this rank, in f32: the mesh coordinate, ``shardings()``, the local
    shard and its slices of every output leaf, which cache leaves the step
    changed on this rank, and the collectives ``sharding.rules`` issued."""
    import torch

    from repro_torch import arch as A
    from repro_torch import configs, interop
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import local
    from repro_torch.sharding import MeshRules, serve_rules
    from repro_torch.sharding import rules as R

    lm.torch = F32(torch, torch.float32)
    out = {}
    for key, case in cases.items():
        arch = lm_case_arch(A, configs, case)
        mesh = make_host_mesh(**case["mesh"], device="cpu")
        rules = MeshRules(mesh, serve_rules(mesh))
        prog = steps.build_cell(arch, case["shape"][0], rules=rules)
        args = tuple(interop.place(a, s, rules, device="cpu") for a, s in zip(case["args"], prog.arg_specs))
        before = {k: local(t).clone() for k, t in args[1].items()} if prog.kind == "decode" else {}
        issued = sum(R.COLLECTIVES.values())
        logits, cache = prog(*args)
        out[key] = {"coord": list(mesh.device_mesh.get_coordinate()),
                    "shardings": [spec_lists(s) for s in prog.shardings()],
                    "logits": laid_out(logits),
                    "cache": {k: laid_out(t) for k, t in cache.items()},
                    "changed": {k: not torch.equal(local(cache[k]), t) for k, t in before.items()},
                    "in_place": all(local(cache[k]).data_ptr() == local(args[1][k]).data_ptr() for k in before if k != "len"),
                    "collectives": sum(R.COLLECTIVES.values()) - issued}
    return out


def serve_rule_steps(cases: dict) -> dict:
    """Each diffusion or classifier case (arch, shape, mesh, the step's numpy
    arguments in the port's layout) through ``build_cell(...,
    rules=MeshRules(mesh, serve_rules(mesh)))`` on this rank, in f32: the
    mesh coordinate, ``shardings()``, the output's local shard and its
    slices, and the collectives it issued (:func:`guarded`)."""
    import torch

    from repro_torch import arch as A
    from repro_torch import configs, interop
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import MeshRules, serve_rules

    in_f32(torch)
    out = {}
    for key, case in cases.items():
        mesh = make_host_mesh(**case["mesh"], device="cpu")
        rules = MeshRules(mesh, serve_rules(mesh))
        prog = steps.build_cell(serve_case_arch(A, configs, case), case["shape"][0], rules=rules)
        args = tuple(interop.place(a, s, rules, device="cpu") for a, s in zip(case["args"], prog.arg_specs))
        y, comms = guarded(prog, args)
        out[key] = {"coord": list(mesh.device_mesh.get_coordinate()),
                    "shardings": [spec_lists(s) for s in prog.shardings()], "out": laid_out(y), "comms": comms}
    return out


HELPERS = ("all_sum", "all_max", "all_gather", "redistribute")


def guarded(prog, args) -> tuple:
    """``prog(*args)`` under ``CommDebugMode``, with ``sharding.rules``'
    helpers (``HELPERS``, wherever a model module holds them) counted by
    the same mode around each call: (the result, {every collective the step
    issued, those issued inside the helpers, by kind, the helpers' own
    tally ``rules.COLLECTIVES``})."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import convnets, diffusion, vision
    from repro_torch.models import layers as L
    from repro_torch.sharding import rules as R

    inside, tally = [0], sum(R.COLLECTIVES.values())
    with CommDebugMode() as mode:
        def counted(fn):
            def wrapped(*a, **kw):
                before = mode.get_total_counts()
                result = fn(*a, **kw)
                inside[0] += mode.get_total_counts() - before
                return result
            return wrapped

        saved = {(m, n): getattr(m, n) for m in (R, L, diffusion, vision, convnets) for n in HELPERS if hasattr(m, n)}
        for (m, n), fn in saved.items():
            setattr(m, n, counted(fn))
        try:
            result = prog(*args)
        finally:
            for (m, n), fn in saved.items():
                setattr(m, n, fn)
    return result, {"total": mode.get_total_counts(), "inside": inside[0],
                    "by_kind": {str(k): v for k, v in mode.get_comm_counts().items()},
                    "tally": sum(R.COLLECTIVES.values()) - tally}


def comm_guard(cases: dict) -> dict:
    """Each case's ruled step (an LM's or a diffusion or classifier one)
    through :func:`guarded`: its collective counts."""
    import torch

    from repro_torch import arch as A
    from repro_torch import configs, interop
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import MeshRules, serve_rules

    in_f32(torch)
    out = {}
    for key, case in cases.items():
        mesh = make_host_mesh(**case["mesh"], device="cpu")
        rules = MeshRules(mesh, serve_rules(mesh))
        prog = steps.build_cell(case_arch(A, configs, case), case["shape"][0], rules=rules)
        args = tuple(interop.place(a, s, rules, device="cpu") for a, s in zip(case["args"], prog.arg_specs))
        out[key] = guarded(prog, args)[1]
    return out


def ruled_init(name: str, shape: tuple, mesh_args: dict, seed: int, params_np: dict) -> dict:
    """On a ``make_host_mesh(**mesh_args)``: whether every rank's slice of
    every leaf of ``init_args(seed)`` under ``serve_rules`` equals the same
    slice of the unsharded draw, exactly, leaf by leaf; and whether
    ``interop.place`` of ``interop.from_jax`` of ``params_np`` lays out each
    leaf as ``init_args`` does."""
    import torch

    from repro_torch import arch as A
    from repro_torch import configs, interop
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import local, local_slice, tree_leaves
    from repro_torch.sharding import MeshRules, serve_rules

    arch = lm_case_arch(A, configs, {"arch": name, "shape": shape, "quant": False})
    mesh = make_host_mesh(**mesh_args, device="cpu")
    rules = MeshRules(mesh, serve_rules(mesh))
    prog = steps.build_cell(arch, shape[0], rules=rules)
    whole = steps.build_cell(arch, shape[0]).init_args(seed, "cpu")
    ruled = prog.init_args(seed, "cpu")
    equal, split = [], 0
    for got, want in ((g, w) for a, b in zip(ruled, whole) for g, w in zip(tree_leaves(a), tree_leaves(b))):
        part = want[tuple(local_slice(got, d)[0] for d in range(got.dim()))]
        equal.append(local(got).dtype == want.dtype and torch.equal(local(got), part))
        split += local(got).shape != want.shape
    params = interop.place(interop.from_jax(arch, params_np, {}, device="cpu")[0], prog.arg_specs[0], rules,
                           device="cpu")
    layout = [(p.placements, p.shape) == (q.placements, q.shape) for p, q in zip(tree_leaves(params),
                                                                                  tree_leaves(ruled[0]))]
    return {"equal": equal, "split": split, "from_jax": layout}


def train_case_arch(A, configs, case: dict):
    """The SMOKE arch of a training ``case`` cut to its one shape ``t``
    (``case["shape"]``: kind, batch, seq, image side), its config changed
    by ``case["cfg"]`` where given; either package's ``arch`` and
    ``configs``."""
    import dataclasses

    kind, batch, seq, img = case["shape"]
    arch = configs.get(case["arch"], smoke=True)
    arch = dataclasses.replace(arch, shapes=(A.ShapeSpec("t", kind, batch, seq=seq, img=img),))
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **case.get("cfg", {})))


PRIMITIVES = ("_reduce", "_gather", "_moved")


def train_guarded(fn, *args) -> tuple:
    """``fn(*args)`` under ``CommDebugMode``, with the primitives of
    ``sharding.rules`` that issue its every collective, forward and backward
    (``PRIMITIVES``), counted by the same mode around each call: (the
    result, {every collective issued, those inside the primitives, the
    helpers' tally ``rules.COLLECTIVES`` by kind})."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.sharding import rules as R

    inside, tally = [0], dict(R.COLLECTIVES)
    with CommDebugMode() as mode:
        def counted(real):
            def wrapped(*a, **kw):
                before = mode.get_total_counts()
                result = real(*a, **kw)
                inside[0] += mode.get_total_counts() - before
                return result
            return wrapped

        saved = {n: getattr(R, n) for n in PRIMITIVES}
        for n, real in saved.items():
            setattr(R, n, counted(real))
        try:
            result = fn(*args)
        finally:
            for n, real in saved.items():
                setattr(R, n, real)
    issued = {k: v - tally.get(k, 0) for k, v in R.COLLECTIVES.items() if v != tally.get(k, 0)}
    return result, {"total": mode.get_total_counts(), "inside": inside[0], "tally": issued}


def train_rule_steps(cases: dict) -> dict:
    """Each training case (arch, shape, mesh, accum_steps, AdamW settings,
    whether its attention is blockwise (``layers.BLOCKWISE_THRESHOLD`` 0),
    the train state and batch as numpy trees in the port's layout) through
    ``build_cell(..., rules=MeshRules(mesh, train_rules(mesh)))`` on this
    rank, in f32: the mesh coordinate, ``shardings()``; ``value_and_grad``
    of ``meta["loss_fn"]`` (its loss and every gradient's local shard and
    slices); then one step under :func:`train_guarded`: its metrics, every
    leaf of the updated state (local shard and slices), whether each leaf
    kept its placements and its storage, and the collectives."""
    import torch

    from repro_torch import arch as A
    from repro_torch import configs, interop
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models.common import local, tree_leaves
    from repro_torch.sharding import MeshRules, train_rules
    from repro_torch.train.optim import AdamWConfig

    in_f32(torch)
    out = {}
    threshold = layers.BLOCKWISE_THRESHOLD
    for key, case in cases.items():
        layers.BLOCKWISE_THRESHOLD = 0 if case.get("blockwise") else threshold
        mesh = make_host_mesh(**case["mesh"], device="cpu")
        rules = MeshRules(mesh, train_rules(mesh))
        prog = steps.build_cell(train_case_arch(A, configs, case), "t", rules=rules,
                                adamw=AdamWConfig(**case["adamw"]), accum_steps=case["accum"])
        ts, batch = (interop.place(a, s, rules, device="cpu") for a, s in zip(case["args"], prog.arg_specs))
        (loss, _), grads = steps.value_and_grad(prog.meta["loss_fn"], ts["params"], ts["state"], batch)
        placements = [t.placements for t in tree_leaves(ts)]
        storage = [local(t).data_ptr() for t in tree_leaves(ts)]
        (ts, metrics), comms = train_guarded(prog, ts, batch)
        leaves = tree_leaves(ts)
        out[key] = {"coord": list(mesh.device_mesh.get_coordinate()),
                    "shardings": [spec_lists(s) for s in prog.shardings()],
                    "loss": float(loss), "grads": [laid_out(g) for g in grads],
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "ts": [laid_out(t) for t in leaves],
                    "kept": [t.placements == p for t, p in zip(leaves, placements)],
                    "in_place": [local(t).data_ptr() == d for t, d in zip(leaves, storage)],
                    "comms": comms}
    layers.BLOCKWISE_THRESHOLD = threshold
    return out


ELASTIC_SHAPE = ("train", 4, 16, 0)  # a SMOKE qwen3 train cell: batch 4 of 16 tokens


def elastic_ruled(ckpt: str, restart: bool) -> dict:
    """Item 8.5 on ranks: a SMOKE qwen3-0.6b trained under ``train_rules``.
    Without ``restart``, on 4 ranks at (2, 2): 6 steps from the seed-0
    init, the train state saved after the 4th (``checkpoint.save``, every
    rank gathering, rank 0 writing); returns the losses.  With
    ``restart``, on the ranks of the re-planned mesh (3 survivors of 4 chips
    at model 2: (1, 2), ``data_parallel_scale`` 0.5): the state restored onto
    a ruled step with ``accum_steps`` 1 / scale (``restore_resharded`` with
    the new ``prog.shardings()``), whether each rank's shards equal the
    saved arrays' slices, and steps 5-6 from the same batches; returns the
    losses, the step restored and the plan."""
    import numpy as np
    import torch

    from repro_torch import arch as A
    from repro_torch import checkpoint as ck
    from repro_torch import configs, interop
    from repro_torch.data import DataSpec, SyntheticStream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import local, local_slice, tree_leaves, tree_map
    from repro_torch.runtime import plan_elastic_remesh
    from repro_torch.sharding import MeshRules, train_rules
    from repro_torch.train.optim import AdamWConfig

    plan = plan_elastic_remesh(3, model_axis=2, pod_size=4, prior_chips=4)
    shape, accum = (2, 2), 1
    if restart:
        shape, accum = plan.mesh_shape, round(1 / plan.data_parallel_scale)
    mesh = make_host_mesh(*shape, device="cpu")
    rules = MeshRules(mesh, train_rules(mesh))
    arch = train_case_arch(A, configs, {"arch": "qwen3-0.6b", "shape": ELASTIC_SHAPE})
    prog = steps.build_cell(arch, "t", rules=rules, adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20),
                            accum_steps=accum)
    stream = SyntheticStream(DataSpec(arch, arch.shape("t"), seed=0))

    def batch(i):
        return interop.place(stream.batch_at(i), prog.arg_specs[1], rules, device="cpu")

    losses = []
    if not restart:
        ts = prog.init_arg(0, 0, "cpu")
        for i in range(6):
            ts, m = prog(ts, batch(i))
            losses.append(float(m["loss"]))
            if i == 3:
                ck.save(ckpt, 4, ts)
        return {"losses": losses}
    like = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), prog.arg_specs[0])
    ts, _ = ck.restore_resharded(ckpt, ck.latest_step(ckpt), like, prog.shardings()[0])
    path = Path(ckpt) / f"step_{ck.latest_step(ckpt):08d}"
    names = [p[1:] for p in _dotted(prog.arg_specs[0])]
    equal = [bool(np.array_equal(local(t).numpy(), np.load(path / f"{n}.npy")[
        tuple(local_slice(t, d)[0] for d in range(t.dim()))])) for n, t in zip(names, tree_leaves(ts))]
    split = sum(local(t).shape != t.shape for t in tree_leaves(ts))
    restored = int(local(ts["opt"]["step"]))
    for i in range(4, 6):
        ts, m = prog(ts, batch(i))
        losses.append(float(m["loss"]))
    return {"losses": losses, "restored": restored, "equal": equal, "split": split,
            "mesh": list(plan.mesh_shape), "scale": plan.data_parallel_scale, "accum": accum}


def _dotted(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _dotted(tree[k], f"{prefix}.{k}")]
    return [prefix]


def ruled_collectives(cases: dict) -> dict:
    """Each case ``key -> (arch, ShapeSpec fields, make_host_mesh args)``:
    the SMOKE arch cut to that one shape, its step under the dry run's rule
    table (``dryrun.rank_program``) on this rank's CPU, on the seed's
    arguments: the collectives ``sharding.rules`` issued, by kind."""
    import dataclasses

    from repro_torch import arch as A
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules as R

    out = {}
    for key, (name, fields, mesh_args) in cases.items():
        spec = A.ShapeSpec(*fields)
        arch = dataclasses.replace(configs.get(name, smoke=True), shapes=(spec,))
        prog = dryrun.rank_program(arch, spec.name, make_host_mesh(**mesh_args, device="cpu"))
        args = prog.init_args(0, "cpu")
        before = dict(R.COLLECTIVES)
        prog(*args)
        out[key] = {k: v - before.get(k, 0) for k, v in R.COLLECTIVES.items() if v != before.get(k, 0)}
    return out
