"""The port's ``distributed/`` (``mesh``, ``sharding``, ``context``) and
``launch/mesh.py`` against the JAX package's, on the CPU:

* ``P``'s equality as JAX's ``PartitionSpec``'s (trailing ``None``s count,
  a one-name tuple is the name);
* the rules, leaf by leaf, on ``AbstractMesh``es of (16, 16), (2, 16, 16)
  and (1, 1), for every arch of the port's ``configs.ARCHS`` (sm-cnn among
  them), on JAX's own trees (``launch/specs.py``'s ``plan_cell``, which
  builds them with ``jax.eval_shape``), carried into the port as meta
  tensors: ``param_specs`` under the arch's family (an LM under both
  ``lm`` and ``lm_fsdp``), ``opt_state_specs``, ``batch_specs`` for every
  cell's kind, ``cache_specs`` for the decode caches (bf16 and int8);
  ``lm_rules``, ``gnn_rules``, ``recsys_rules``, ``data_axes``,
  ``axis_size`` and the context's ``_fits``;
* placements: at mesh (2, 2) on 4 gloo ranks, each rank's shard from
  ``distribute`` equal to the block JAX's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the device
  at that rank's mesh coordinate (JAX on 4 fake host devices in a
  subprocess), for ``P(("data", "model"))``, ``P("model", None)`` and
  ``P(None, "data")``; a tuple of axes out of mesh order refused;
* ``constrain``: the identity outside a context and on a plain tensor,
  a DTensor redistributed to its rule's placements inside one;
* ``CheckpointManager.restore(shardings=..., mesh=...)`` at world size 2
  on gloo: each leaf placed by its ``lm`` spec, its shard the rank's block
  of the unsharded restore, the full values equal;
* ``make_mesh``'s refusals: no process group, a CUDA mesh without a card, a
  shape the world does not fill.

The rules take no process group, so they run here as JAX's run on its
``AbstractMesh`` (whose own test file, ``tests/test_sharding.py``, fails
at import under jax 0.9: ROADMAP.md §3, reference fault 2).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_ranks as R
from repro_torch.configs import ARCHS
from repro_torch.core.export import flatten_named
from repro_torch.core.treepath import keystr, tree_map_with_path, tree_paths
from repro_torch.distributed import context as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as launch_mesh

torch.set_num_threads(2)

MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")))
MESH_IDS = ["16x16", "2x16x16", "1x1"]
TRAIN_KINDS = ("train", "graph_full", "graph_sampled", "graph_batched", "rec_train",
               "pair_train")


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.configs import get_config, get_shapes, shape_applicable
    from repro.distributed import context as jctx, mesh as jmesh, sharding as jsh
    from repro.launch import specs
    from repro.models import transformer as jtfm
    return dict(jax=jax, jnp=jnp, AbstractMesh=AbstractMesh, P=PartitionSpec, ctx=jctx,
                mesh=jmesh, sh=jsh, specs=specs, tfm=jtfm, get_config=get_config,
                get_shapes=get_shapes, shape_applicable=shape_applicable, cells={})


def _meshes(J, i):
    sizes, names = MESHES[i]
    return J["AbstractMesh"](sizes, names), M.AbstractMesh(sizes, names)


def _meta(J, tree):
    """A JAX tree of shape structs as the port's tree of meta tensors."""
    return J["jax"].tree.map(
        lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)), device="meta"), tree)


def _jax_flat(J, specs):
    jtu = J["jax"].tree_util
    flat = jtu.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, J["P"]))[0]
    return {jtu.keystr(k, simple=True, separator="/"): tuple(v) for k, v in flat}


def _port_flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _port_flat(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, SH.P):
        return {k: v for i, sub in enumerate(tree) for k, v in _port_flat(sub, path + (i,)).items()}
    assert isinstance(tree, SH.P), tree
    return {"/".join(str(p) for p in path): tuple(tree)}


def _same(J, jspecs, pspecs):
    want, got = _jax_flat(J, jspecs), _port_flat(pspecs)
    assert got == want
    return len(want)


def _cells(J, arch):
    """Every applicable cell of ``arch``: (shape, plan) from JAX's
    ``plan_cell`` on the (16, 16) mesh, once."""
    if arch not in J["cells"]:
        mesh = J["AbstractMesh"](*MESHES[0])
        cfg = J["get_config"](arch)
        J["cells"][arch] = [
            (s, J["specs"].plan_cell(arch, s.name, mesh)) for s in J["get_shapes"](arch)
            if J["shape_applicable"](cfg, s)[0]]
    return J["cells"][arch]


def _families(J, arch):
    fam = J["get_config"](arch).family
    return ("lm", "lm_fsdp") if fam == "lm" else (fam,)


# ---------------------------------------------------------------------------
# P and the meshes
# ---------------------------------------------------------------------------

SPEC_PAIRS = [(("a", None), ("a",)), ((("a",),), ("a",)), ((), (None,)),
              ((("a", "b"), None), (("a", "b"),)), (("a", None), ("a", None)),
              ((None, "b"), (None, ("b",)))]


@pytest.mark.parametrize("a,b", SPEC_PAIRS)
def test_partition_spec_equality_matches_jax(J, a, b):
    P = J["P"]
    assert (SH.P(*a) == SH.P(*b)) == (P(*a) == P(*b))
    assert tuple(SH.P(*a)) == tuple(P(*a))
    import pickle
    assert pickle.loads(pickle.dumps(SH.P(*a))) == SH.P(*a)


@pytest.mark.parametrize("i", range(3), ids=MESH_IDS)
def test_mesh_helpers_match_jax(J, i):
    jm, pm = _meshes(J, i)
    assert pm.axis_names == tuple(jm.axis_names) and pm.shape == dict(jm.shape)
    assert M.data_axes(pm) == J["mesh"].data_axes(jm)
    for names in ((), ("model",), ("data", "model"), ("pod", "data"), ("pod",)):
        assert M.axis_size(pm, *names) == J["mesh"].axis_size(jm, *names)
    assert launch_mesh.make_mesh is M.make_mesh
    assert launch_mesh.make_production_mesh is M.make_production_mesh


@pytest.mark.parametrize("i", range(3), ids=MESH_IDS)
def test_context_rules_match_jax(J, i):
    jm, pm = _meshes(J, i)
    for sp in (True, False):
        assert ({k: tuple(v) for k, v in C.lm_rules(pm, sp).items()}
                == {k: tuple(v) for k, v in J["ctx"].lm_rules(jm, sp).items()})
    assert tuple(C.gnn_rules(pm)["nodes"]) == tuple(J["ctx"].gnn_rules(jm)["nodes"])
    assert tuple(C.recsys_rules(pm)["candidates"]) == tuple(J["ctx"].recsys_rules(jm)["candidates"])
    # _fits: the rule is skipped where an axis does not divide the dim
    rules = C.lm_rules(pm)
    for shape in ((8, 32, 4), (32, 32, 4), (512, 16, 4), (2, 3)):
        for spec in list(rules.values()) + [SH.P(tuple(pm.axis_names))]:
            with C.activation_sharding(pm, rules):
                got = C._fits(spec, shape)
            with J["ctx"].activation_sharding(jm, J["ctx"].lm_rules(jm)):
                want = J["ctx"]._fits(J["P"](*spec), shape)
            assert got == want, (spec, shape)


# ---------------------------------------------------------------------------
# the rules, arch by arch, on JAX's trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(3), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_jax(J, arch, i):
    """param_specs under each family that applies and opt_state_specs,
    on the arch's training cell's parameter and adamw trees."""
    jm, pm = _meshes(J, i)
    shape, plan = next((s, p) for s, p in _cells(J, arch) if s.kind in TRAIN_KINDS)
    jparams, jopt = plan.args[0], plan.args[1]
    params, opt = _meta(J, jparams), _meta(J, jopt)
    n = 0
    for fam in _families(J, arch):
        n += _same(J, J["sh"].param_specs(jparams, fam, jm), SH.param_specs(params, fam, pm))
        n += _same(J, J["sh"].opt_state_specs(jopt, jparams, fam, jm),
                   SH.opt_state_specs(opt, params, fam, pm))
    assert n > 0


@pytest.mark.parametrize("i", range(3), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(J, arch, i):
    """batch_specs for every cell's kind, on the cell's inputs, and
    cache_specs for each decode cell's cache and its int8 form."""
    jm, pm = _meshes(J, i)
    fam = J["get_config"](arch).family
    jsh = J["sh"]
    for shape, plan in _cells(J, arch):
        args = plan.args
        if shape.kind in TRAIN_KINDS:
            jbatch = args[2]
        elif shape.kind in ("decode", "long_decode"):
            jbatch = (args[2], args[3])
            _same(J, jsh.cache_specs(args[1], None, jm), SH.cache_specs(_meta(J, args[1]), None, pm))
        else:
            jbatch = args[1]
        _same(J, jsh.batch_specs(jbatch, fam, shape.kind, jm),
              SH.batch_specs(_meta(J, jbatch), fam, shape.kind, pm))
    if fam == "lm":
        import dataclasses
        cfg = dataclasses.replace(J["get_config"](arch), kv_quant=True)
        jcache = J["jax"].eval_shape(lambda: J["tfm"].init_cache(cfg, 128, 32768))
        assert set(jcache) == {"k", "v", "k_scale", "v_scale"}
        _same(J, jsh.cache_specs(jcache, cfg, jm), SH.cache_specs(_meta(J, jcache), cfg, pm))


def test_zero_shard_and_placements():
    pm = M.AbstractMesh((16, 16), ("data", "model"))
    P = SH.P
    assert SH.zero_shard_spec(P(None, None, "model"), (28, 2048, 11264), pm) == P(None, "data", "model")
    assert SH.zero_shard_spec(P(("data", "model"), None), (1024, 64), pm) == P(("data", "model"), None)
    from torch.distributed.tensor import Replicate, Shard
    assert SH.placements(P(("data", "model"), None), pm) == (Shard(0), Shard(0))
    assert SH.placements(P(None, "model"), pm) == (Replicate(), Shard(1))
    assert SH.placements(P("data", "model", None), pm) == (Shard(0), Shard(1))
    assert SH.placements(P(), pm) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        SH.placements(P(("model", "data")), pm)
    with pytest.raises(ValueError, match="shards two dims"):
        SH.placements(P("data", "data"), pm)


TREES = [{"b": [np.zeros(2), (np.zeros(3), np.zeros(1))], "a": {"c": np.zeros(4)}},
         [(np.zeros(2),), {"w": np.zeros((1, 5))}],
         (np.zeros(1), [np.zeros(2), {"x": np.zeros(3), "y": (np.zeros(6),)}])]


@pytest.mark.parametrize("k", range(len(TREES)))
def test_tree_walk_matches_jax_paths(J, k):
    """``core.treepath``'s walk, which the rules and ``export.flatten_named``
    share: the key paths of ``jax.tree_util.tree_map_with_path`` as
    ``keystr`` renders them, the nesting kept (tuples stay tuples), and
    ``tree_paths`` listing every leaf once."""
    tree, jtu = TREES[k], J["jax"].tree_util
    want = jtu.tree_map_with_path(lambda p, x: jtu.keystr(p, simple=True, separator="/"), tree)
    assert tree_map_with_path(lambda p, x: keystr(p), tree) == want
    flat = {jtu.keystr(p, simple=True, separator="/"): x.shape
            for p, x in jtu.tree_flatten_with_path(tree)[0]}
    got = [(keystr(p), x.shape) for p, x in tree_paths(tree)]
    assert dict(got) == flat and len(got) == len(flat)
    assert {n: a.shape for n, a in flatten_named(tree).items()} == flat


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = []
    for spec in json.loads(sys.argv[1]):
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        m = NamedSharding(mesh, spec).devices_indices_map(tuple(json.loads(sys.argv[2])))
        out.append([[[s.start, s.stop] for s in m[mesh.devices[i, j]]]
                    for i in range(2) for j in range(2)])
    print("BLOCKS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """JAX's device blocks (subprocess) beside the port's 4 placement ranks
    and 2 restore ranks."""
    pytest.importorskip("jax")
    import json
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.training.checkpoint import CheckpointManager

    out = tmp_path_factory.mktemp("gloo")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                             json.dumps(R.PLACEMENT_SPECS), json.dumps(R.PLACEMENT_SHAPE)],
                            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        # a reduced LM's checkpoint, and its template of zeros
        cfg = reduced(get_config("qwen3-0.6b"))
        params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        CheckpointManager(str(out / "ckpt")).save(7, params)
        torch.save({k: v for k, v in _zeros(params).items()}, out / "template.pt")
        ranks = [R.Ranks(R.placement_rank, 4, out, (2, 2), str(out)),
                 R.Ranks(R.restore_rank, 2, out, str(out / "ckpt"), str(out / "template.pt"),
                         (1, 2), str(out))]
        for r in ranks:
            r.join()
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        proc.kill()
        proc.wait()
    line = next((x for x in stdout.splitlines() if x.startswith("BLOCKS ")), None)
    assert line is not None, stdout + stderr
    return dict(blocks=json.loads(line[len("BLOCKS "):]),
                placement=[torch.load(out / f"placement-{r}.pt") for r in range(4)],
                restore=[torch.load(out / f"restore-{r}.pt", weights_only=False)
                         for r in range(2)],
                params=params)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


@pytest.mark.parametrize("k", range(len(R.PLACEMENT_SPECS)),
                         ids=["data-model", "model-none", "none-data"])
def test_distribute_cuts_as_jax_devices(gloo_runs, k):
    """Rank r (mesh coordinate divmod(r, 2)) holds JAX's block for the
    device at that coordinate."""
    full = torch.arange(np.prod(R.PLACEMENT_SHAPE), dtype=torch.float32).reshape(R.PLACEMENT_SHAPE)
    for r in range(4):
        idx = tuple(slice(a, b) for a, b in gloo_runs["blocks"][k][r])
        assert torch.equal(gloo_runs["placement"][r][k], full[idx])


def test_restore_places_leaves_by_their_specs(gloo_runs):
    """Each restored leaf is a DTensor placed by its ``lm`` spec on mesh
    (1, 2): its full values the unsharded restore's (which are the saved
    params), its shard on rank r the r-th block of the model-sharded dim."""
    from repro_torch.core.treepath import tree_map
    saved = []
    tree_map(saved.append, gloo_runs["params"])      # the ranks' order
    sharded = 0
    for r, res in enumerate(gloo_runs["restore"]):
        assert res["steps"] == (7, 7)
        assert len(res["rows"]) == len(saved)
        for row, want in zip(res["rows"], saved):
            assert torch.equal(row["plain"], want) and torch.equal(row["full"], want)
            spec = row["spec"]
            dim = next((d for d, e in enumerate(spec) if e == "model"), None)
            if dim is None:
                assert row["placements"] == (None, None)
                assert torch.equal(row["local"], want)
            else:
                assert row["placements"] == (None, dim)
                assert torch.equal(row["local"], torch.chunk(want, 2, dim=dim)[r])
                sharded += 1
    assert sharded > 0


def test_constrain_places_a_dtensor_inside_a_context(tmp_path):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(2, 4, 3)
    assert C.constrain(x, "residual") is x
    with R.process_group(tmp_path):
        mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
        xd = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        assert C.constrain(xd, "residual") is xd
        with C.activation_sharding(mesh, C.lm_rules(mesh)):
            assert C.constrain(x, "residual") is x
            got = C.constrain(xd, "residual")
            assert got.placements == (Shard(0), Shard(1))
            assert torch.equal(got.full_tensor(), x)
            assert C.constrain(xd, "no such kind") is xd
            assert C.current().mesh is mesh
        assert C.current() is None


def test_make_mesh_refusals(tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh((1, 1), ("data", "model"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            M.make_mesh((1, 1), ("data", "model"))
    with R.process_group(tmp_path):
        with pytest.raises(ValueError, match="needs 4 ranks"):
            M.make_mesh((2, 2), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            M.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            M.make_production_mesh(multi_pod=True, device_type="cpu")
        mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
        assert M.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert M.data_axes(mesh) == ("data",)
