"""The port's dry-run planner (``launch/specs.py``) and what it stands on,
against the JAX package's, on the CPU:

* ``plan_cell`` on an ``AbstractMesh`` against JAX's ``plan_cell`` on
  ``jax.sharding.AbstractMesh`` for every cell of ``configs.cells()`` and
  sm-cnn's two, at (16, 16) and (2, 16, 16): argument tree paths, shapes,
  dtypes and specs, output specs, ``donate``, ``default_trip`` and
  ``meta``, exactly; the inapplicable cells refused alike, with the same
  reasons;
* the init functions on ``device="meta"`` (the twin of ``jax.eval_shape``):
  the same tree, shapes and dtypes as on the CPU at a reduced config, no
  value drawn (the generator's state unmoved), and ``adamw(...).init`` of
  the meta tree meta too;
* ``sharding.param_shardings`` and ``named`` against JAX's (their specs);
* the last two names the port lacked: ``models/sm_cnn.py``
  ``naive_conv_arm`` and ``core/export.py`` ``save`` (a file each package's
  ``load`` reads bit for bit).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shapes, reduced, shape_applicable
from repro_torch.core.treepath import keystr, tree_paths
from repro_torch.distributed import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = tuple(ASSIGNED_ARCHS) + ("sm-cnn",)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    from jax.sharding import AbstractMesh
    from repro.core.treepath import keystr as jkeystr
    from repro.distributed import sharding as jsh
    from repro.launch import specs as jspecs
    return dict(jax=jax, AbstractMesh=AbstractMesh, specs=jspecs, sh=jsh, keystr=jkeystr)


def _jax_flat(J, tree):
    jtu = J["jax"].tree_util
    leaves = jtu.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, J["jax"].sharding.NamedSharding))[0]
    return {J["keystr"](p): leaf for p, leaf in leaves}


def _port_flat(tree):
    return {keystr(p): leaf for p, leaf in tree_paths(tree)}


def _port_shardings(tree, path=()):
    """{path: spec} of a tree of NamedSharding (a P is a tuple: not a
    node)."""
    if isinstance(tree, SH.NamedSharding):
        return {keystr(path): tuple(tree.spec)}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_shardings(sub, path + (key,)).items()}
    return {k: v for i, sub in enumerate(tree) for k, v in _port_shardings(sub, path + (i,)).items()}


def _cells():
    return [(arch, s.name) for arch in ARCHS for s in get_shapes(arch)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_matches_jax(J, arch, mesh):
    sizes, names = MESHES[mesh]
    jm, pm = J["AbstractMesh"](sizes, names), M.AbstractMesh(sizes, names)
    for shape in get_shapes(arch):
        ok, why = shape_applicable(get_config(arch), shape)
        if not ok:
            with pytest.raises(ValueError) as port_err:
                specs.plan_cell(arch, shape.name, pm)
            with pytest.raises(ValueError) as jax_err:
                J["specs"].plan_cell(arch, shape.name, jm)
            assert str(port_err.value) == str(jax_err.value)
            continue
        jp, pp = J["specs"].plan_cell(arch, shape.name, jm), specs.plan_cell(arch, shape.name, pm)
        ja, pa, ps = _jax_flat(J, jp.args), _port_flat(pp.args), _port_shardings(pp.in_shardings)
        assert sorted(ja) == sorted(pa) == sorted(ps), (arch, shape.name)
        for path, leaf in ja.items():
            t = pa[path]
            assert tuple(t.shape) == tuple(leaf.shape), (arch, shape.name, path)
            assert str(t.dtype) == f"torch.{leaf.dtype.name}", (arch, shape.name, path)
            assert t.device.type == "meta"
            assert ps[path] == tuple(leaf.sharding.spec), (arch, shape.name, path)
        jo = {k: tuple(v.spec) for k, v in _jax_flat(J, jp.out_shardings).items()}
        po = pp.out_shardings
        po = {"": tuple(po.spec)} if isinstance(po, SH.NamedSharding) else _port_shardings(po)
        assert jo == po, (arch, shape.name)
        assert (tuple(pp.donate), pp.default_trip, pp.meta, pp.kind) == (
            tuple(jp.donate), jp.default_trip, jp.meta, jp.kind), (arch, shape.name)
        assert specs.input_specs(arch, shape.name, pm) is not None


def test_every_cell_is_planned_or_skipped_as_in_jax(J):
    from repro.configs import cells as jcells
    from repro_torch.configs import cells
    assert [(a, s.name) for a, s in cells(include_inapplicable=True)] == [
        (a, s.name) for a, s in jcells(include_inapplicable=True)]
    skipped = [(a, s) for a, s in _cells()
               if not shape_applicable(get_config(a), next(x for x in get_shapes(a)
                                                           if x.name == s))[0]]
    assert len(skipped) == 5 and all(s == "long_500k" for _, s in skipped)
    assert len(_cells()) - len(skipped) == 37


def _inits(cfg, device, seed=0):
    from repro_torch.models import gnn, recsys, sm_cnn, transformer
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "lm":
        return {"params": transformer.init_lm(cfg, g, device=device),
                "cache": transformer.init_cache(cfg, 2, 8, device=device)}, g
    if cfg.family == "gnn":
        return {"params": gnn.init_gnn(cfg, g, 8, device=device)}, g
    if cfg.family == "recsys":
        return {"params": recsys.init_model(cfg, g, device=device)}, g
    return {"params": sm_cnn.init_sm_cnn(cfg, g, device=device)}, g


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b", "meshgraphnet",
                                  "dlrm-mlperf", "fm", "din", "bert4rec", "sm-cnn"])
def test_meta_init_matches_the_cpu_tree(arch):
    from repro_torch.training import optimizer as opt
    cfg = reduced(get_config(arch))
    if arch == "qwen3-0.6b":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    cpu, _ = _inits(cfg, "cpu")
    meta, g = _inits(cfg, "meta")
    assert g.get_state().equal(torch.Generator().manual_seed(0).get_state())   # nothing drawn
    cf, mf = _port_flat(cpu), _port_flat(meta)
    assert list(cf) == list(mf)
    for path, t in cf.items():
        assert (tuple(mf[path].shape), mf[path].dtype, mf[path].device.type) == (
            tuple(t.shape), t.dtype, "meta"), path
    state = opt.adamw(1e-3).init(meta["params"])
    cpu_state = opt.adamw(1e-3).init(cpu["params"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in _port_flat(state).items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in _port_flat(cpu_state).items()}
    assert all(v.device.type == "meta" for v in _port_flat(state).values())


def test_meta_device_is_shapes_only():
    from repro_torch import resolve_device
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("xpu")


@pytest.mark.parametrize("family,arch", [("lm", "qwen3-0.6b"), ("lm_fsdp", "qwen3-0.6b"),
                                         ("recsys", "dlrm-mlperf"), ("gnn", "meshgraphnet")])
def test_param_shardings_and_named_match_jax(J, family, arch):
    sizes, names = MESHES["16x16"]
    jm, pm = J["AbstractMesh"](sizes, names), M.AbstractMesh(sizes, names)
    jp = J["specs"].plan_cell(arch, get_shapes(arch)[0].name, jm).args[0]
    pp = specs.plan_cell(arch, get_shapes(arch)[0].name, pm).args[0]
    js = {k: tuple(v.spec) for k, v in _jax_flat(J, J["sh"].param_shardings(jp, family, jm)).items()}
    ps = SH.param_shardings(pp, family, pm)
    assert _port_shardings(ps) == js
    assert _port_shardings(SH.named(pm, SH.param_specs(pp, family, pm))) == js
    one = next(iter(_port_flat_shardings(ps)))
    assert len(one.placements) == 2 and one == SH.NamedSharding(pm, one.spec)


def _port_flat_shardings(tree):
    if isinstance(tree, SH.NamedSharding):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _port_flat_shardings(v)
    else:
        for v in tree:
            yield from _port_flat_shardings(v)


def test_naive_conv_arm_matches_jax_and_conv_arm(J):
    from repro.models import sm_cnn as jcnn
    from repro_torch.models import sm_cnn
    rng = np.random.default_rng(0)
    w, d, f = 5, 6, 7
    conv = {"w": rng.standard_normal((w * d, f)).astype(np.float32) * 0.3,
            "b": rng.standard_normal(f).astype(np.float32) * 0.1}
    x = rng.standard_normal((3, 9, d)).astype(np.float32)
    got = sm_cnn.naive_conv_arm({k: torch.from_numpy(v) for k, v in conv.items()},
                                torch.from_numpy(x), w).numpy()
    want = np.asarray(jcnn.naive_conv_arm(conv, x, w))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, sm_cnn.conv_arm({k: torch.from_numpy(v) for k, v in
                                                     conv.items()}, torch.from_numpy(x), w).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_export_save_is_read_by_both_loads(J, tmp_path):
    from repro.core import export as jexport
    from repro_torch.core import export
    rng = np.random.default_rng(1)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": [rng.integers(0, 9, (5,)).astype(np.int32)]}
    export.save(str(tmp_path / "port.rpro"), {"a": {"w": torch.from_numpy(tree["a"]["w"])},
                                               "b": [torch.from_numpy(tree["b"][0])]},
                model="m", meta={"k": 1})
    jexport.save(str(tmp_path / "jax.rpro"), tree, model="m", meta={"k": 1})
    assert (tmp_path / "port.rpro").read_bytes() == (tmp_path / "jax.rpro").read_bytes()
    for path in ("port.rpro", "jax.rpro"):
        for load in (export.load, jexport.load):
            flat, header = load(str(tmp_path / path))
            assert header["model"] == "m" and header["meta"] == {"k": 1}
            np.testing.assert_array_equal(flat["a/w"], tree["a"]["w"])
            np.testing.assert_array_equal(flat["b/0"], tree["b"][0])
