"""Multi-pod dry run: plan and run every (arch x shape) cell on the
production meshes without allocating, and read the roofline's inputs.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-mlperf --shape serve_p99 --multi-pod

The port of the JAX package's ``launch/dryrun.py``, with its CLI and its
record fields. Where JAX lowers and compiles each plan for 512 fake host
devices, this runs it: a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once, moving nothing) holds this process as rank 0 of a ``DeviceMesh``
of the production shape, the plan's arguments are meta DTensors placed by
its shardings (``specs.dtensor_args``: each local shard a meta tensor of
rank 0's block), and the step runs once on them under
``roofline.counts.count``. Meta tensors hold no values, so nothing is
allocated and the hand-written kernels' wrappers run their shape functions;
what DTensor runs on the local shards is rank 0's work, which the counter
reads (``counts.py``: per rank, with the collectives DTensor issues).

A multi-pod cell runs on the (pod x data, model) flattening of its mesh
(``PRODUCTION``); ``specs.plan_cell`` on ``AbstractMesh((2, 16, 16))`` is
the plan JAX's equals.

Per cell it records:
  - ``memory``: rank 0's argument and output bytes (its local shards),
    ``alias_bytes`` (the donated arguments' bytes, which an in-place
    update would reuse), ``peak_estimate_bytes`` (the most local bytes
    live at once during the step, arguments included, traced over the
    meta storages by ``LiveBytes``) and ``temp_bytes`` (the peak less the
    arguments);
  - ``counts`` (per rank) and ``roofline``, ``build_roofline``'s row at
    ``n_devices`` = the mesh's size;
  - ``meta``, ``lower_s`` (planning and placing), ``run_s`` (the counted
    step) and ``total_s``.

Eager execution runs every layer, so nothing is multiplied by the plan's
``default_trip``. A data-dependent op (``.item()``, ``nonzero``) cannot
run on meta tensors; a cell that reaches one fails, and a failing cell is
a report, not a crash. Records go to ``artifacts/dryrun_torch/`` (one
JSON a cell and mesh), never into the JAX package's ``artifacts/dryrun/``.

``--mesh 1x1`` (with ``--global-batch``) runs a cell at world size 1, on a
mesh of one rank, so that its counts can be held against the same step run
on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shapes, shape_applicable
from repro_torch.core.treepath import tree_leaves as leaves_of
from repro_torch.launch import specs
from repro_torch.roofline import counts as counts_lib
from repro_torch.roofline.analysis import build_roofline

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
#: multi_pod -> (the mesh a cell runs on, its axes, the record's mesh name).
#: The (2, 16, 16) production mesh runs as its (pod x data, model) = (32, 16)
#: flattening: every rule shards "pod" and "data" together, as one tuple in
#: mesh order, so each rank's blocks and each collective's group are the
#: same, and a collective over both is one over 32 ranks, as XLA issues it.
#: (DTensor would split a tensor dim over two mesh dims and issue two
#: collectives; its redistribution planner searches such placements in time
#: that grows with the mesh's dims: minutes a layer at 512 ranks.)
PRODUCTION = {False: ((16, 16), ("data", "model"), "pod16x16"),
              True: ((32, 16), ("data", "model"), "pod2x16x16")}


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive at once, at most, over the ops run
    while entered: each op's outputs' storages (plain tensors: a DTensor's
    local shards) are added when first seen and taken off when freed;
    ``start`` adds storages that were alive before (the arguments)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = set()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if counts_lib._dtensor_types(types):
            return NotImplemented      # DTensor's local ops come back here
        out = func(*args, **(kwargs or {}))
        if counts_lib._faking():
            return out
        for t in tree_leaves(out):
            if type(t) is torch.Tensor:
                self.add(t)
        return out


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree's tensors (DTensors by
    their local shard, plain tensors whole), each storage once."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in leaves_of(tree):
        if not isinstance(t, torch.Tensor):
            continue
        loc = t.to_local() if isinstance(t, DTensor) else t
        key = loc.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += loc.untyped_storage().nbytes()
    return total


def start_fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0; an existing default group is destroyed first. DTensor moves a dim's
    split to another dim with an all-to-all (``shard_dim_alltoall``), as on
    the card's NCCL mesh, where on a CPU mesh it falls back to an
    all-gather of the whole and a chunk (gloo has no all-to-all): the fake
    group has one, and ``_card_all_to_all`` routes DTensor to it, so the
    dry run counts the card's collective and holds the card's memory."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _card_all_to_all()


def _card_all_to_all() -> None:
    from torch.distributed.tensor import placement_types

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     group.group_name)

    if hasattr(placement_types, "shard_dim_alltoall"):
        placement_types.shard_dim_alltoall = shard_dim_alltoall


def run_plan(plan: specs.CellPlan, mesh) -> Tuple[counts_lib.Counts, Dict]:
    """One step of ``plan`` on meta DTensors on ``mesh``, counted: (counts,
    memory record)."""
    args = specs.dtensor_args(plan, mesh)
    arg_bytes = local_bytes(args)
    alias = sum(local_bytes(args[i]) for i in plan.donate)
    live = LiveBytes()
    for t in leaves_of(args):
        live.add(t.to_local())
    counter = counts_lib.Counter()
    with counter, live:
        out = plan.fn(*args)
    out_bytes = local_bytes(out)
    del out
    return counter.counts, {
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "temp_bytes": live.peak - arg_bytes, "alias_bytes": alias,
        "peak_estimate_bytes": live.peak}


def cut_shape(arch: str, shape_name: str, global_batch: Optional[int]):
    shape = next(s for s in get_shapes(arch) if s.name == shape_name)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    return shape


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             global_batch: Optional[int] = None) -> dict:
    """Plan, place and run one cell on the current fake group's mesh
    (``mesh_shape`` over ("data", "model"), or the production mesh), and
    write its record."""
    from repro_torch.distributed.mesh import make_mesh
    if mesh_shape is None:
        sizes, names, mesh_name = PRODUCTION[multi_pod]
    else:
        sizes, names = tuple(mesh_shape), ("data", "model")
        mesh_name = "x".join(str(n) for n in sizes)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        mesh = make_mesh(sizes, names, "cpu")
        cfg = get_config(arch)
        shape = cut_shape(arch, shape_name, global_batch)
        fam = {"lm": specs._plan_lm, "gnn": specs._plan_gnn, "recsys": specs._plan_recsys,
               "textpair": specs._plan_textpair}[cfg.family]
        plan = fam(arch, cfg, shape, mesh)
        rec["lower_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        c, memory = run_plan(plan, mesh)
        rec["run_s"] = round(time.time() - t1, 2)
        rec["memory"] = memory
        rec["cost_analysis"] = {"flops": c.flops, "bytes accessed": c.bytes_accessed}
        rec["counts"] = dataclasses.asdict(c)
        roof = build_roofline(arch, shape, mesh_name, mesh.size(), c)
        rec["roofline"] = roof.row()
        rec["meta"] = plan.meta
        if global_batch is not None:
            rec["cut"] = {"global_batch": global_batch}
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failing cell is a report, not a crash
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def skip_record(arch: str, shape_name: str, why: str, out_dir: str) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": "-", "ok": True,
           "skipped": why}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__skip.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _line(rec: dict) -> str:
    if not rec["ok"]:
        return (f"FAIL  {rec['arch']:22s} {rec['shape']:14s} {rec['mesh']:10s} "
                f"{rec['error'][:140]}")
    r = rec["roofline"]
    peak = rec["memory"]["peak_estimate_bytes"] / 2**30
    return (f"ok    {rec['arch']:22s} {rec['shape']:14s} {rec['mesh']:10s} "
            f"run={rec['run_s']:7.1f}s peak={peak:8.2f}GiB "
            f"bottleneck={r['bottleneck']:10s} step={r['step_s']*1e3:9.3f}ms "
            f"roofline={r['roofline_frac']*100:5.1f}%")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-paper-arch", action="store_true",
                    help="also run the sm-cnn cells")
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE",
                    help="a cell to run (again for more), in place of --arch/--shape")
    ap.add_argument("--mesh", default=None,
                    help="a (data, model) mesh such as 1x1 in place of the production ones")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut an LM cell's global batch to this")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    todo = []
    archs = list(ASSIGNED_ARCHS)
    if args.include_paper_arch:
        archs.append("sm-cnn")
    if args.all:
        for arch in archs:
            for shape in get_shapes(arch):
                todo.append((arch, shape))
    else:
        cells = [c.split(":", 1) for c in args.cell]
        if args.arch or args.shape:
            cells.append((args.arch, args.shape))
        assert cells and all(a and s for a, s in cells), "--arch/--shape, --cell or --all"
        for arch, name in cells:
            todo.append((arch, next(s for s in get_shapes(arch) if s.name == name)))

    if args.mesh is not None:
        meshes = [tuple(int(n) for n in args.mesh.split("x"))]
    else:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_fail = 0
    runnable = []
    for arch, shape in todo:
        ok, why = shape_applicable(get_config(arch), shape)
        if not ok:
            skip_record(arch, shape.name, why, args.out)
            print(f"SKIP  {arch:22s} {shape.name:14s} ({why.split(':')[0]})")
            continue
        runnable.append((arch, shape))
    try:
        for m in meshes:     # one fake group a mesh: its world is the mesh's size
            sizes = m if isinstance(m, tuple) else PRODUCTION[m][0]
            world = 1
            for n in sizes:
                world *= n
            start_fake_group(world)
            for arch, shape in runnable:
                if isinstance(m, tuple):
                    rec = run_cell(arch, shape.name, False, args.out, mesh_shape=m,
                                   global_batch=args.global_batch)
                else:
                    rec = run_cell(arch, shape.name, m, args.out,
                                   global_batch=args.global_batch)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                print(_line(rec), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\ndone: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
