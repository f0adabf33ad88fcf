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
