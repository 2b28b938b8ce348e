"""The planned-step tests' cases, argument values, JAX runs and checks
(``tests/test_torch_planned_*.py``): the port's ``launch/specs.py`` by
value against the JAX package's, on the CPU.

A case is a family's ``_plan_*`` at a reduced config and a small shape.
JAX's ``_plan_*`` runs jitted on a (1, 1) mesh (axis types Auto) from
arguments drawn with numpy from a seed; the port's runs the same arguments,
placed as DTensors by the plan's shardings, on gloo at world size 1 (mesh
(1, 1), in the test's process) and 4 (meshes (2, 2) and (1, 4),
``tests/torch_ranks.py``). Every output leaf is held to JAX's: rtol 1e-4,
atol 1e-5 (the North star's score tolerance), the optimizer's moments
(gradients) at atol 1e-6, an int8 cache within one step of JAX's.

The MoE step's aux loss is each rank's GShard loss over its own tokens,
averaged over the ranks, in both packages, so it depends on the mesh: its
world-4 runs are held to JAX's plan on the same meshes, run on 4 fake host
devices in a subprocess (``--xla_force_host_platform_device_count``, set
before JAX starts). MeshGraphNet runs in float64, as
``tests/test_torch_gnn.py`` holds it (in float32 one cancelling element of
a gradient misses rtol 1e-4 in both packages). This module imports JAX
only inside its functions.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import torch_ranks as R

SEED = 0
#: id -> (arch, config overrides, ShapeSpec fields)
CASES = {
    "lm-train": ("qwen3-0.6b", {}, dict(name="train_t", kind="train", seq_len=32,
                                        global_batch=4)),
    "lm-prefill": ("qwen3-0.6b", {}, dict(name="prefill_t", kind="prefill", seq_len=32,
                                          global_batch=4)),
    "moe-train": ("deepseek-moe-16b", {"moe": {"capacity_factor": 8.0}},
                  dict(name="train_t", kind="train", seq_len=32, global_batch=4)),
    "moe-decode": ("deepseek-moe-16b", {},
                   dict(name="decode_t", kind="decode", seq_len=32, global_batch=4)),
    "int8-decode": ("qwen3-0.6b", {"kv_quant": True},
                    dict(name="decode_t", kind="decode", seq_len=32, global_batch=4)),
    "gnn-full": ("meshgraphnet", {"dtype": "float64"},
                 dict(name="full_t", kind="graph_full", n_nodes=40, n_edges=96, d_feat=8)),
    "gnn-batched": ("meshgraphnet", {"dtype": "float64"},
                    dict(name="mol_t", kind="graph_batched", n_nodes=10, n_edges=24, d_feat=8,
                         n_graphs=4)),
    "dlrm-serve": ("dlrm-mlperf", {}, dict(name="serve_t", kind="rec_serve", batch=8)),
    "dlrm-retrieval": ("dlrm-mlperf", {}, dict(name="retr_t", kind="rec_retrieval",
                                               n_candidates=32)),
    "fm-train": ("fm", {}, dict(name="train_t", kind="rec_train", batch=8)),
    "smcnn-serve": ("sm-cnn", {}, dict(name="serve_t", kind="pair_serve", batch=8)),
}
MESHES = ((2, 2), (1, 4))
RTOL, ATOL, MOMENT_ATOL = 1e-4, 1e-5, 1e-6

JAX_MESH_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    sys.path.insert(0, sys.argv[1])
    import planned_cases as C
    case = sys.argv[3]
    z = np.load(sys.argv[2])
    values = {k.split("|", 1)[1]: z[k] for k in z.files if k.startswith(case + "|")}
    out = {}
    auto = jax.sharding.AxisType.Auto
    for shape in C.MESHES:
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(auto, auto))
        got = C.jax_run(case, mesh, values)
        out.update({f"{shape[0]}x{shape[1]}|{p}": v for p, v in got.items()})
    np.savez(sys.argv[4], **out)
""")


def _jax_case(case):
    """(arch, JAX config, JAX ShapeSpec, plan function) of a case."""
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeSpec
    from repro.launch import specs
    arch, over, fields = case
    cfg = reduced(get_config(arch))
    if "moe" in over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **over["moe"]))
    cfg = dataclasses.replace(cfg, **over)
    fam = {"lm": specs._plan_lm, "gnn": specs._plan_gnn, "recsys": specs._plan_recsys,
           "textpair": specs._plan_textpair}[cfg.family]
    return arch, cfg, ShapeSpec(**fields), fam


def _values(cfg, shape, path: str, leaf, rng):
    """A numpy value for one argument leaf, by its path and type."""
    name = path.split("/")[-1]
    if "/" not in path:                        # a bare argument: prefill's or decode's
        name = {("prefill", "1"): "tokens", ("decode", "2"): "toks",
                ("decode", "3"): "pos"}[(shape.kind, name)]
    shp, dt = tuple(leaf.shape), np.dtype(leaf.dtype.name if leaf.dtype.name != "bfloat16"
                                          else "float32")
    if path.startswith("1/step"):
        return np.zeros(shp, np.int32)
    if path.startswith(("1/mu", "1/nu")):
        return np.zeros(shp, np.float32)
    if dt.kind in "iu" and name not in ("k", "v"):
        hi = {"tokens": cfg_attr(cfg, "vocab_size"), "labels": cfg_attr(cfg, "vocab_size"),
              "senders": shape.n_nodes, "receivers": shape.n_nodes,
              "q_tok": cfg_attr(cfg, "vocab_size"), "a_tok": cfg_attr(cfg, "vocab_size"),
              "label": 2}.get(name)
        if name in ("ids", "user_ids"):
            vs = np.array(cfg.vocab_sizes[:shp[-1]])
            return (rng.integers(0, 1 << 20, shp) % vs).astype(dt)
        if name == "candidates":
            return rng.integers(0, cfg.vocab_sizes[-1], shp).astype(dt)
        if name == "pos":
            return rng.integers(0, shape.seq_len, shp).astype(dt)
        if name == "toks":
            hi = cfg.vocab_size
        return rng.integers(0, hi, shp).astype(dt)
    if name in ("k", "v"):                     # an int8 cache: zeros, as init_cache
        return np.zeros(shp, dt)
    if name in ("label",):
        return rng.integers(0, 2, shp).astype(dt)
    if name in ("k_scale", "v_scale"):
        return np.zeros(shp, dt)
    if name in ("node_mask", "hist_mask"):
        return np.ones(shp, dt)
    return (rng.standard_normal(shp) * 0.3).astype(dt)


def cfg_attr(cfg, name):
    return getattr(cfg, name, 0)


def _flat(tree):
    import jax
    from repro.core.treepath import keystr
    return {keystr(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _x64(cfg):
    import jax
    return jax.enable_x64(cfg.dtype == "float64")


def _plan(case, mesh):
    arch, cfg, shape, fam = _jax_case(CASES[case])
    with _x64(cfg):
        return cfg, shape, fam(arch, cfg, shape, mesh)


def _auto_mesh(shape):
    import jax
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh(shape, ("data", "model"), axis_types=(auto, auto))


def draw_values(case):
    """The case's argument values, {path: array}, drawn from its seed by
    the JAX plan's argument tree: optimizer moments 0, master copies the
    params in float32, ids inside their tables."""
    cfg, shape, plan = _plan(case, _auto_mesh((1, 1)))
    rng = np.random.default_rng(SEED + list(CASES).index(case))
    values = {p: _values(cfg, shape, p, leaf, rng) for p, leaf in _flat(plan.args).items()}
    for p in values:
        if p.startswith("1/master/"):
            values[p] = values["0/" + p[len("1/master/"):]].astype(np.float32)
    return values


def jax_run(case, mesh, values):
    """JAX's plan of ``case`` on ``mesh`` run once, jitted, its arguments
    placed by their shardings: {path: output}."""
    import jax
    import jax.numpy as jnp
    cfg, shape, plan = _plan(case, mesh)
    with _x64(cfg):
        flat_args, tdef = jax.tree_util.tree_flatten(plan.args)
        leaves = [jax.device_put(jnp.asarray(values[p], dtype=a.dtype), a.sharding)
                  for p, a in zip(_flat(plan.args), flat_args)]
        out = jax.jit(plan.fn)(*jax.tree_util.tree_unflatten(tdef, leaves))
        out = out if isinstance(out, tuple) else (out,)
        return {p: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
                for p, v in _flat(out).items()}


class WorldFour:
    """The port's ranks at world size 4 (one group a mesh of MESHES, all
    started at once) and JAX's runs on the same meshes for ``mesh_jax``
    (a subprocess of 4 host devices), started at construction; ``result``
    waits: ({(id, mesh): port outputs}, {(id, mesh): JAX outputs})."""

    def __init__(self, values, tmp, mesh_jax=()):
        self.tmp, self.ids = tmp, list(values)
        path = tmp / "values.npz"
        np.savez(path, **{f"{i}|{p}": v for i, vals in values.items() for p, v in vals.items()})
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.sides = {i: subprocess.Popen([sys.executable, "-c", JAX_MESH_SCRIPT,
                                           os.path.dirname(__file__), str(path), i,
                                           str(tmp / f"{i}_jax.npz")], env=env)
                      for i in mesh_jax}
        cases = {i: CASES[i] for i in values}
        self.ranks = []
        for shape in MESHES:
            out = tmp / f"{shape[0]}x{shape[1]}"
            out.mkdir()
            self.ranks.append((out, R.Ranks(R.planned_rank, 4, out, cases, str(path),
                                            (shape,), str(out))))
        self._result = None

    def result(self):
        if self._result is None:
            port = {}
            for out, ranks in self.ranks:
                ranks.join()
                port.update(torch.load(out / "planned.pt", weights_only=False))
            jax_side = {}
            for i, proc in self.sides.items():
                assert proc.wait(timeout=120) == 0
                z = np.load(self.tmp / f"{i}_jax.npz")
                for shape in MESHES:
                    tag = f"{shape[0]}x{shape[1]}|"
                    jax_side[(i, shape)] = {k[len(tag):]: z[k] for k in z.files
                                            if k.startswith(tag)}
            self._result = port, jax_side
        return self._result


def world_one(case, values):
    """The port's outputs at world size 1, in this process."""
    from repro_torch.distributed.mesh import make_mesh
    import tempfile
    with tempfile.TemporaryDirectory() as tmp, R.process_group(tmp):
        return R.run_planned(CASES[case], make_mesh((1, 1), ("data", "model"), "cpu"), values)


def check(got, want, case):
    assert set(got) == set(want), (sorted(got)[:5], sorted(want)[:5])
    for p, w in want.items():
        g = got[p]
        assert g.shape == w.shape, (p, g.shape, w.shape)
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, p
        elif w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=p)
        else:
            atol = MOMENT_ATOL if p.startswith(("1/mu", "1/nu")) else ATOL
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=f"{case} {p}")
