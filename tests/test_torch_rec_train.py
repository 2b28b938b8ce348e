"""The port's recsys training and FM/DIN serving against ``repro.models.recsys``
and ``repro.launch.train``.

On ``reduced()`` dlrm-mlperf, fm and din in float32 on the CPU, with the
JAX weights carried into the port by ``params_from_numpy`` and batches from
each package's data module with the same seed:

* ``loss_fn``'s value, its metrics and the gradient of EVERY parameter leaf
  against ``jax.value_and_grad`` of the JAX ``loss_fn`` (DLRM's lookups
  through ``EmbeddingBag``, whose CPU backward is the plain backward; FM's
  and DIN's through torch indexing), rtol 1e-4 / atol 1e-6: float32 sums in
  another order through a few layers;
* 5 ``Trainer`` + ``adamw`` steps against the JAX ``Trainer``, each step's
  loss within rtol 1e-4 (adam normalises the gradient, so an update moves
  each weight by about lr and the two stay close);
* FM and DIN ``serve_step`` and ``retrieval_step`` at the repo's score
  tolerance (rtol 1e-4, atol 1e-5);
* the training launcher's ``build`` (the JAX launcher's batches and
  parameter tree) and ``main`` for the three on ``--device cpu``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import export as jax_export
from repro.launch import train as jax_train
from repro.models import recsys as jax_rec
from repro.training import optimizer as jax_opt, train_loop as jax_loop
from repro_torch.configs import RecsysConfig, get_config, reduced
from repro_torch.core import export
from repro_torch.core.treepath import tree_leaves
from repro_torch.data import recsys as data
from repro_torch.kernels import embedding_bag as EB
from repro_torch.launch import train
from repro_torch.models import recsys as rec
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import Trainer, value_and_grad

torch.set_num_threads(2)
ARCHS = ("dlrm-mlperf", "fm", "din")
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """reduced(arch) in both packages, the JAX weights and the port's copy."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jax_rec.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp


def _port_params(arch):
    _, _, jp = _setup(arch)
    return rec.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and lists (both packages nest alike)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------------ configs --

@pytest.mark.parametrize("arch", ["fm", "din"])
def test_config_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()


@pytest.mark.parametrize("arch", ["fm", "din"])
def test_init_model_has_the_jax_tree(arch):
    """FM's ``emb``, ``lin``, ``bias`` and DIN's ``emb``, ``attn``, ``out``:
    names, shapes, dtypes; the same seed draws the same values."""
    _, cfg, jp = _setup(arch)
    tree = rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jflat = jax_export._flatten_named(jax.tree.map(np.asarray, jp))
    flat = export.flatten_named(tree)
    assert sorted(flat) == sorted(jflat)
    for name, arr in flat.items():
        assert arr.shape == jflat[name].shape and arr.dtype == jflat[name].dtype, name
    again = export.flatten_named(rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    for name in flat:
        np.testing.assert_array_equal(again[name], flat[name])
    emb = flat["emb"]
    assert abs(emb.std() - 0.02) < 2e-3
    if arch == "fm":
        assert flat["bias"].shape == () and flat["bias"] == 0
        assert abs(flat["lin"].std() - 0.01) < 2e-3


# ------------------------------------------------------------- serving --

@pytest.mark.parametrize("arch", ["fm", "din"])
@pytest.mark.parametrize("batch,seed", [(1, 0), (37, 3)])
def test_serve_step_matches_jax(arch, batch, seed):
    jcfg, cfg, jp = _setup(arch)
    b = data.batch_for(cfg, batch, seed=seed)
    want = jax_rec.serve_step(jp, _j(b), jcfg)
    got = rec.serve_step(_port_params(arch), _t(b), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ["fm", "din"])
@pytest.mark.parametrize("n", [1, 500])
def test_retrieval_step_matches_jax(arch, n):
    jcfg, cfg, jp = _setup(arch)
    b = data.retrieval_batch(cfg, n, seed=5)
    want = jax_rec.retrieval_step(jp, _j(b), jcfg)
    got = rec.retrieval_step(_port_params(arch), _t(b), cfg)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ["fm", "din"])
def test_retrieval_equals_serving_each_candidate(arch):
    """Retrieval decomposes the forward: each candidate's score equals
    ``serve_step`` on the user context with that candidate as the target."""
    _, cfg, _ = _setup(arch)
    params = _port_params(arch)
    b = _t(data.retrieval_batch(cfg, 9, seed=6))
    got = rec.retrieval_step(params, b, cfg).reshape(-1)
    cand = b["candidates"]
    if arch == "fm":
        ids = torch.cat([b["user_ids"].expand(9, -1), cand[:, None]], dim=1)
        want = rec.serve_step(params, {"ids": ids}, cfg)
    else:
        want = rec.serve_step(params, {"hist": b["hist"].expand(9, -1),
                                       "hist_mask": b["hist_mask"].expand(9, -1),
                                       "target": cand}, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ----------------------------------------------------------------- loss_fn --

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jcfg, cfg, jp = _setup(arch)
    batch = data.batch_for(cfg, 64, seed=3)
    (want, want_m), want_g = jax.value_and_grad(
        functools.partial(jax_rec.loss_fn, cfg=jcfg), has_aux=True)(jp, _j(batch))
    before = (EB.launches, EB.bwd_launches)
    got, got_m, grads = value_and_grad(functools.partial(rec.loss_fn, cfg=cfg),
                                       _port_params(arch), _t(batch))
    assert (EB.launches, EB.bwd_launches) == before   # the CPU path launches nothing
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for key in ("bce", "acc"):
        np.testing.assert_allclose(got_m[key].item(), float(want_m[key]), rtol=1e-5,
                                   err_msg=key)
    grads, want_flat = _flat(grads), _flat(want_g)
    assert sorted(grads) == sorted(want_flat)
    for path, g in grads.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), _np(want_flat[path]), err_msg=path, **GRAD_TOL)


def test_dlrm_training_goes_through_the_bag_function():
    """Under grad DLRM's lookup is one ``EmbeddingBag`` node; the plain
    route (both plain versions) gives the same gradient tree bit for bit."""
    _, cfg, _ = _setup("dlrm-mlperf")
    batch = _t(data.batch_for(cfg, 16, seed=4))
    trees = {}
    for lookup in ("kernel", "plain"):
        loss, _, grads = value_and_grad(
            functools.partial(rec.loss_fn, cfg=cfg, lookup=lookup), _port_params("dlrm-mlperf"),
            batch)
        seen, stack, n = set(), [loss.grad_fn], 0
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            n += type(fn).__name__ == "EmbeddingBagBackward"
            stack.extend(f for f, _ in fn.next_functions)
        assert n == 1, lookup
        trees[lookup] = grads
    for a, b in zip(tree_leaves(trees["kernel"]), tree_leaves(trees["plain"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match_jax(arch):
    """5 ``Trainer`` + ``adamw`` steps (the launcher's warmup-cosine schedule)
    from the same weights on the same batches."""
    jcfg, cfg, jp = _setup(arch)
    sched = dict(peak_lr=1e-3, warmup=10, total=STEPS)
    tr = Trainer(functools.partial(rec.loss_fn, cfg=cfg),
                 opt.adamw(opt.warmup_cosine_schedule(**sched)), _port_params(arch))
    jtr = jax_loop.Trainer(functools.partial(jax_rec.loss_fn, cfg=jcfg),
                           jax_opt.adamw(jax_opt.warmup_cosine_schedule(**sched)), jp)
    tr.run(data.batches(cfg, 32, seed=0), max_steps=STEPS, log_every=0)
    jtr.run(data.batches(cfg, 32, seed=0), max_steps=STEPS, log_every=0)
    assert tr.step == jtr.step == STEPS
    for i, (got, want) in enumerate(zip(tr.history, jtr.history)):
        for key in ("loss", "bce", "acc"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    assert tr.history[-1]["loss"] != tr.history[0]["loss"]


# ---------------------------------------------------------------- launcher --

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_build_gives_the_jax_launchers_batches_and_tree(arch):
    jcfg, jparams, _, jdata = jax_train.build(arch, False, 8, 16)
    cfg, params, loss, batches = train.build(arch, False, 8, 16, device="cpu")
    assert cfg.name == jcfg.name and cfg.family == jcfg.family == "recsys"
    jflat = jax_export._flatten_named(jax.tree.map(np.asarray, jparams))
    flat = export.flatten_named(params)
    assert {k: (v.shape, v.dtype) for k, v in flat.items()} == \
        {k: (v.shape, v.dtype) for k, v in jflat.items()}
    for _ in range(2):
        want, got = next(jdata), next(batches)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    value, metrics = loss(params, _t(next(batches)))
    assert value.dim() == 0 and math.isfinite(value.item()) and set(metrics) == {"bce", "acc"}


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_main_trains_on_the_cpu(arch, capsys):
    """``main`` prints the JAX launcher's ``arch=`` line (its parameter
    count) and a finite final loss."""
    _, jparams, _, _ = jax_train.build(arch, False, 16, 64)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    train.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={arch} family=recsys params={n:,}"
    assert lines[-1].startswith("final: {") and "'bce'" in lines[-1]


def test_bert4rec_training_still_raises():
    cfg = reduced(RecsysConfig(**dataclasses.asdict(jax_get_config("bert4rec"))))
    with pytest.raises(NotImplementedError, match="10e"):
        rec.loss_fn({}, {}, cfg)
