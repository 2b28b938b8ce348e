"""Gloo ranks for the port's distributed tests.

``spawn(fn, world, tmp, *args)`` runs ``fn(rank, world, *args)`` on
``world`` CPU ranks started by ``torch.multiprocessing`` (spawn; ``Ranks``
starts them and returns, for ranks that run beside other work), each in a
default process group on the ``gloo`` backend whose rendezvous is a
``file://`` store under the test's ``tmp`` directory, so that test workers
running at once share no TCP port. A rank writes its results under
``tmp`` with ``torch.save``; the test reads them. Gloo's collectives time
out after ``COLLECTIVE_TIMEOUT`` and ``spawn`` kills the ranks after its
``timeout``, so a rank that waits on a collective its peers never reach
fails the test instead of hanging it. A rank starts in about 5 s (torch and
DTensor's imports).

The rank functions below are the ones the ``tests/test_torch_*.py`` files
of ``distributed/``, ``training/compression.py`` and
``models/moe.py``'s ``moe_apply_a2a`` hand to ``spawn``. This module
imports torch and the port only, so a rank starts without JAX; it is not a
test file (pytest collects ``test_*.py``).
"""
import contextlib
import dataclasses
import datetime
import os
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_TIMEOUT_S = 120.0


def _entry(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` ranks running ``fn``, started; ``join`` waits for them."""

    def __init__(self, fn, world: int, tmp, *args):
        self.name, self.world = fn.__name__, world
        store = os.path.join(str(tmp), f"store-{uuid.uuid4().hex}")
        self.ctx = mp.start_processes(_entry, args=(fn, world, store, args), nprocs=world,
                                      join=False, start_method="spawn")

    def join(self, timeout: float = SPAWN_TIMEOUT_S) -> None:
        """Wait for every rank; a rank's exception is raised here, and ranks
        still running after ``timeout`` are killed."""
        deadline = time.monotonic() + timeout
        while not self.ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.name} on {self.world} ranks did not end in "
                                   f"{timeout} s")


def spawn(fn, world: int, tmp, *args) -> None:
    Ranks(fn, world, tmp, *args).join()


@contextlib.contextmanager
def process_group(tmp):
    """A default process group of one gloo rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store-{uuid.uuid4().hex}",
                            rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    from repro_torch.distributed.mesh import make_mesh
    return make_mesh(tuple(shape), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# moe_apply_a2a
# ---------------------------------------------------------------------------

#: the MoE parameter tree's specs as the LM rules place a layer's leaves
MOE_SPECS = {"router": (None, None), "w_gate": ("model", None, None),
             "w_up": ("model", None, None), "w_down": ("model", None, None),
             "shared": {"w_gate": (None, None), "w_up": (None, None), "w_down": (None, None)}}


def moe_cfg(capacity_factor: float):
    """reduced(deepseek-moe-16b) (8 routed experts of 32, top-2, 1 shared)
    at ``capacity_factor``."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("deepseek-moe-16b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


@contextlib.contextmanager
def recorded_dispatch():
    """Each ``_local_dispatch`` call's (slot, kept), in call order."""
    from repro_torch.models import moe
    orig, seen = moe._local_dispatch, []

    def rec(x, ids, n_buckets, cap, valid=None):
        buf, slot, kept = orig(x, ids, n_buckets, cap, valid)
        seen.append((slot.clone(), kept.clone()))
        return buf, slot, kept

    moe._local_dispatch = rec
    try:
        yield seen
    finally:
        moe._local_dispatch = orig


def a2a_rank(rank, world, inputs, shape, capacities, out):
    """On mesh ``shape`` (data, model): the npz ``inputs``' MoE parameters
    (placed by MOE_SPECS) and x (placed ``P("data", "model", None)``)
    through ``moe_apply_a2a`` at each capacity factor: this rank's
    dispatch records and drop counts; the full y, aux, and the gradient of
    ``sum(y**2) + 0.01 * aux`` for every leaf and x (rank 0 writes them);
    one call's collective counts, and an all-gather's and a
    reduce-scatter's; and whether plain tensors on this mesh raise."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.core.treepath import tree_map
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe
    from repro_torch.roofline import counts

    mesh = _mesh(shape)
    z = np.load(inputs)
    p = {k: torch.from_numpy(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    p["shared"] = {k: torch.from_numpy(z[f"shared/{k}"]) for k in ("w_gate", "w_up", "w_down")}
    specs = tree_map(lambda leaf, s: SH.P(*s), p, MOE_SPECS)
    x = torch.from_numpy(z["x"])
    result = {"rank": rank, "coord": divmod(rank, shape[1])}   # the mesh is row-major
    for cf in capacities:
        cfg = moe_cfg(cf)
        pd = tree_map(lambda t: t.detach().requires_grad_(True), SH.distribute(p, specs, mesh))
        xd = distribute_tensor(x, mesh, SH.placements(SH.P("data", "model", None), mesh))
        xd = xd.detach().requires_grad_(True)
        with recorded_dispatch() as seen, moe.count_drops() as n:
            y, aux = moe.moe_apply_a2a(pd, xd, cfg, mesh)
        assert isinstance(y, DTensor) and not isinstance(aux, DTensor)
        loss = (y.to_local() ** 2).sum() + 0.01 * aux
        loss.backward()
        grads = tree_map(lambda t: t.grad.full_tensor(), pd)
        full = {"y": y.full_tensor().detach(), "aux": aux.detach(), "grads": grads,
                "x": xd.grad.full_tensor()}
        with torch.no_grad():
            c = counts.count(lambda: moe.moe_apply_a2a(pd, xd, cfg, mesh))
        result[cf] = {"records": seen, "dropped": n.dropped, "routed": n.routed,
                      "counts": (dict(c.n_collectives), dict(c.collective_bytes), c.link_bytes),
                      "full": full if rank == 0 else None}
    # an all-gather of 8 x 3 float32 a rank and a reduce-scatter back
    part, whole = torch.ones(8, 3), torch.empty(8 * world, 3)
    c = counts.count(lambda: (dist.all_gather_into_tensor(whole, part),
                              dist.reduce_scatter_tensor(part, whole)))
    result["gather_scatter_counts"] = (dict(c.n_collectives), dict(c.collective_bytes),
                                       c.link_bytes)
    if world > 1:
        raised = []
        for args in ((pd, x), (p, xd)):
            try:
                moe.moe_apply_a2a(*args, moe_cfg(capacities[0]), mesh)
                raised.append(False)
            except ValueError:
                raised.append(True)
        result["plain_raises"] = raised
    torch.save(result, os.path.join(out, f"a2a-{rank}.pt"))


# ---------------------------------------------------------------------------
# sharding.distribute and CheckpointManager.restore(shardings=...)
# ---------------------------------------------------------------------------

PLACEMENT_SPECS = ((("data", "model"),), ("model", None), (None, "data"))
PLACEMENT_SHAPE = (8, 12)


def placement_rank(rank, world, shape, out):
    """``distribute`` of one (8, 12) tensor by each of PLACEMENT_SPECS on
    mesh ``shape``: this rank's local shards."""
    from repro_torch.distributed import sharding as SH
    mesh = _mesh(shape)
    full = torch.arange(np.prod(PLACEMENT_SHAPE), dtype=torch.float32).reshape(PLACEMENT_SHAPE)
    shards = [SH.distribute({"t": full}, {"t": SH.P(*s)}, mesh)["t"].to_local()
              for s in PLACEMENT_SPECS]
    torch.save(shards, os.path.join(out, f"placement-{rank}.pt"))


def restore_rank(rank, world, ckpt_dir, template_path, shape, out):
    """The checkpoint in ``ckpt_dir`` restored into the template (a
    torch.save'd tree) unsharded and with ``shardings`` = the ``lm`` rules'
    specs on mesh ``shape``: each placed leaf's placements, its local shard,
    the unsharded restore, and the full tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.treepath import tree_map
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.checkpoint import CheckpointManager

    mesh = _mesh(shape)
    template = torch.load(template_path)
    ck = CheckpointManager(ckpt_dir)
    plain, _, step = ck.restore(template)
    specs = SH.param_specs(template, "lm", mesh)
    placed, _, step2 = ck.restore(template, shardings=specs, mesh=mesh)
    rows = []   # in the template's order (tree_map's walk)

    def row(t, spec, ref):
        assert isinstance(t, DTensor)
        rows.append({"spec": tuple(spec),   # each mesh dim's sharded tensor dim, or None
                     "placements": tuple(getattr(pl, "dim", None) for pl in t.placements),
                     "local": t.to_local().clone(), "full": t.full_tensor(), "plain": ref})

    tree_map(row, placed, specs, plain)
    torch.save({"steps": (step, step2), "rows": rows}, os.path.join(out, f"restore-{rank}.pt"))


# ---------------------------------------------------------------------------
# training/compression.py
# ---------------------------------------------------------------------------

def compression_rank(rank, world, inputs, steps, out):
    """``compressed_psum`` over the default group for ``steps`` steps, this
    rank's gradients rows ``rank`` of the npz ``inputs``' stacked ones
    (step, rank, ...), the error state carried: each step's means and new
    errors."""
    from repro_torch.training import compression as C
    z = np.load(inputs)
    names = sorted(k for k in z.files)
    grads = [{k: torch.from_numpy(z[k][s, rank]) for k in names} for s in range(steps)]
    errors = C.init_error_feedback(grads[0])
    seen = []
    for g in grads:
        means, errors = C.compressed_psum(g, errors)
        seen.append((means, errors))
    torch.save(seen, os.path.join(out, f"compression-{world}-{rank}.pt"))


# ---------------------------------------------------------------------------
# launch/specs.py: planned steps by value
# ---------------------------------------------------------------------------

def planned_case(case):
    """(arch, port config, port ShapeSpec, the plan function's name) of a
    planned-step case: ``case`` is (arch, config overrides, ShapeSpec
    fields) on the arch's reduced config."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeSpec
    arch, over, fields = case
    cfg = reduced(get_config(arch))
    if "moe" in over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **over["moe"]))
    cfg = dataclasses.replace(cfg, **over)
    fam = {"lm": "_plan_lm", "gnn": "_plan_gnn", "recsys": "_plan_recsys",
           "textpair": "_plan_textpair"}[cfg.family]
    return arch, cfg, ShapeSpec(**fields), fam


def run_planned(case, mesh, values):
    """The case's plan on ``mesh`` (a DeviceMesh), its arguments placed from
    ``values`` ({path: array}, the arguments' full values), one step run:
    {path: full output as numpy} (float32 for a bfloat16 leaf)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.treepath import keystr, tree_map_with_path
    from repro_torch.launch import specs
    arch, cfg, shape, fam = planned_case(case)
    plan = getattr(specs, fam)(arch, cfg, shape, mesh)
    def value(i, p, t):
        v = torch.from_numpy(np.array(values[keystr((i,) + tuple(p))])).to(t.dtype)
        assert v.shape == t.shape, (keystr((i,) + tuple(p)), v.shape, t.shape)
        return v

    full = tuple(tree_map_with_path(lambda p, t: value(i, p, t), a)
                 for i, a in enumerate(plan.args))
    args = specs.dtensor_args(plan, mesh, full)
    out = plan.fn(*args)
    flat = {}

    def keep(p, t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach()
        flat[keystr(p)] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    tree_map_with_path(keep, out if isinstance(out, tuple) else (out,))
    return flat


def planned_rank(rank, world, cases, values_path, meshes, out):
    """Every case of ``cases`` ({id: case}) on each mesh shape of ``meshes``
    (over ("data", "model")), its values from the npz ``values_path`` (keys
    "<id>|<path>"): rank 0 writes {(id, mesh): outputs}."""
    z = np.load(values_path)
    result = {}
    for shape in meshes:
        mesh = _mesh(shape)
        for i, case in cases.items():
            values = {k.split("|", 1)[1]: z[k] for k in z.files if k.startswith(f"{i}|")}
            result[(i, tuple(shape))] = run_planned(case, mesh, values)
    if rank == 0:
        torch.save(result, os.path.join(out, "planned.pt"))
