"""The port's MeshGraphNet (``repro_torch.models.gnn``) against the JAX
package's ``repro.models.gnn``.

On ``reduced(meshgraphnet)`` (2 layers, d_hidden 16, float32) on the CPU,
with the JAX weights carried into the port by ``params_from_numpy`` (and
through ``RPROAVRO1``) and graphs from ``data/graph.py`` with numpy seeds:

* ``forward``, ``forward_batched`` and ``loss_fn`` (with and without
  ``node_mask``) for the ``sum``, ``mean`` and ``max`` aggregators, the
  outputs at rtol 1e-4 / atol 1e-5 and EVERY gradient leaf against
  ``jax.grad`` at rtol 1e-4 / atol 1e-6 (float32 sums in another order;
  the single-graph gradients with both packages in float64 as well);
* senders and receivers outside [0, N), negatives included (JAX's gather
  wraps [-N, 0) and clamps the rest, passing no gradient back through a
  clamped id; its segment reductions drop them), per graph in the batched
  form;
* a node no edge reaches under ``max`` (its segment is -inf, the row NaN,
  as in JAX);
* gradients with ``remat`` on and off, bit-equal.

The ``cuda``-marked test holds the port on the card against the port on the
CPU and skips where no card is present. The JAX side is imported by a
fixture, so that it runs on a machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gnn.py
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import GNN_SHAPES, get_config, reduced
from repro_torch.core import export
from repro_torch.core.treepath import tree_leaves
from repro_torch.data import graph as G
from repro_torch.models import gnn
from repro_torch.training.train_loop import value_and_grad

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
AGGS = ("sum", "mean", "max")
D_FEAT = 5
KEYS = ("nodes", "edges", "senders", "receivers")


@pytest.fixture(scope="module")
def J():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config, reduced as jax_reduced
    from repro.configs.base import GNNConfig
    from repro.core import export as jax_export
    from repro.models import gnn as jax_gnn
    return types.SimpleNamespace(jax=jax, jnp=jnp, gnn=jax_gnn, export=jax_export,
                                 GNNConfig=GNNConfig, inits={},
                                 cfg=jax_reduced(jax_get_config("meshgraphnet")))


def _cfgs(J, aggregator="sum", **kw):
    jcfg = dataclasses.replace(J.cfg, aggregator=aggregator, **kw)
    cfg = dataclasses.replace(reduced(get_config("meshgraphnet")), aggregator=aggregator,
                              **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _weights(J, jcfg, d_feat=D_FEAT):
    """The JAX init's weights (the aggregator does not change them) and the
    port's copy."""
    key = (dataclasses.replace(jcfg, aggregator="sum"), d_feat)
    if key not in J.inits:
        J.inits[key] = J.gnn.init_gnn(J.jax.random.PRNGKey(0), *key)
    jp = J.inits[key]
    return jp, gnn.params_from_numpy(J.jax.tree.map(np.asarray, jp), "cpu")


def _graph(n=20, e=60, seed=1, n_graphs=0, cover=True, mask=False):
    """A graph_batch whose every node receives an edge (``cover``: no
    empty segment, so ``max`` stays finite)."""
    b = G.graph_batch(n, e, D_FEAT, seed=seed, n_graphs=n_graphs)
    if cover:
        b["receivers"][..., :n] = np.arange(n, dtype=np.int32)
    if mask:
        b["node_mask"] = (np.arange(n) % 3 != 0).astype(np.float32)
    return b


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _forward_both(J, jcfg, cfg, jp, tp, b, batched=False):
    jf, tf = ((J.gnn.forward_batched, gnn.forward_batched) if batched
              else (J.gnn.forward, gnn.forward))
    want = J.jax.jit(functools.partial(jf, cfg=jcfg))(jp, *[J.jnp.asarray(b[k]) for k in KEYS])
    got = tf(tp, *[torch.from_numpy(b[k]) for k in KEYS], cfg)
    return _np(got), _np(want)


def _grads_both(J, jcfg, cfg, jp, tp, b, batched=False):
    (want, _), want_g = J.jax.jit(J.jax.value_and_grad(
        functools.partial(J.gnn.loss_fn, cfg=jcfg, batched=batched), has_aux=True))(
        jp, {k: J.jnp.asarray(v) for k, v in b.items()})
    got, metrics, grads = value_and_grad(
        functools.partial(gnn.loss_fn, cfg=cfg, batched=batched), tp,
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(metrics) == {"mse"}
    return got.item(), float(want), _flat(grads), _flat(want_g)


def _assert_grads(got, want, got_g, want_g):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert sorted(got_g) == sorted(want_g)
    for path, g in got_g.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), _np(want_g[path]), err_msg=path, **GRAD_TOL)


# ------------------------------------------------------------------ configs --

def test_config_matches_jax(J):
    from repro.configs import get_config as jax_get_config
    from repro.configs.base import GNN_SHAPES as JAX_GNN_SHAPES
    cfg, jcfg = get_config("meshgraphnet"), jax_get_config("meshgraphnet")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(J.cfg)
    for d_feat in (16, 602, 1433):
        assert cfg.n_params(d_feat) == jcfg.n_params(d_feat)
    assert [dataclasses.asdict(s) for s in GNN_SHAPES] == \
        [dataclasses.asdict(s) for s in JAX_GNN_SHAPES]


@pytest.mark.parametrize("full", [False, True])
def test_init_gnn_has_the_jax_tree(J, full):
    """Names, shapes and dtypes of every leaf (``proc`` stacked on a
    leading n_layers axis), the same values for the same seed, norms at
    1 and 0."""
    cfg = get_config("meshgraphnet") if full else reduced(get_config("meshgraphnet"))
    jcfg = J.GNNConfig(**dataclasses.asdict(cfg))
    shapes = J.jax.eval_shape(lambda: J.gnn.init_gnn(J.jax.random.PRNGKey(0), jcfg, 16))
    flat = _flat(gnn.init_gnn(cfg, torch.Generator().manual_seed(0), 16, "cpu"))
    jflat = _flat(shapes)
    assert sorted(flat) == sorted(jflat)
    for name, t in flat.items():
        assert tuple(t.shape) == jflat[name].shape, name
        assert str(t.dtype) == f"torch.{jflat[name].dtype}", name
    assert flat["proc/edge/w/0"].shape[0] == cfg.n_layers
    assert bool((flat["proc/node/ln_w"] == 1).all() and (flat["node_enc/ln_b"] == 0).all())
    again = _flat(gnn.init_gnn(cfg, torch.Generator().manual_seed(0), 16, "cpu"))
    assert all(torch.equal(again[name], t) for name, t in flat.items())


# ------------------------------------------------------------------ forward --

@pytest.mark.parametrize("agg", AGGS)
def test_forward_matches_jax(J, agg):
    jcfg, cfg = _cfgs(J, agg)
    jp, tp = _weights(J, jcfg)
    got, want = _forward_both(J, jcfg, cfg, jp, tp, _graph())
    assert got.shape == (20, cfg.d_out) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("agg", AGGS)
def test_forward_batched_matches_jax(J, agg):
    jcfg, cfg = _cfgs(J, agg)
    jp, tp = _weights(J, jcfg)
    got, want = _forward_both(J, jcfg, cfg, jp, tp, _graph(10, 24, seed=2, n_graphs=4),
                              batched=True)
    assert got.shape == (4, 10, cfg.d_out) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_batched_graphs_do_not_mix(J):
    """Each graph of ``forward_batched`` equals ``forward`` on that graph
    alone."""
    _, cfg = _cfgs(J)
    _, tp = _weights(J, J.cfg)
    b = _graph(10, 24, seed=3, n_graphs=3)
    got = gnn.forward_batched(tp, *[torch.from_numpy(b[k]) for k in KEYS], cfg)
    for i in range(3):
        alone = gnn.forward(tp, *[torch.from_numpy(b[k][i]) for k in KEYS], cfg)
        np.testing.assert_allclose(_np(got[i]), _np(alone), **TOL)


# ---------------------------------------------------------- loss, gradients --

@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_loss_and_every_gradient_leaf_match_jax(J, agg, mask):
    """The loss in float32, then the loss and every gradient leaf with both
    packages in float64 (the JAX weights cast up, ``jax.enable_x64``):
    in float32 a weight gradient that sums ~100 terms down to 1/5000 of
    their size carries rounding past rtol 1e-4 in either package (``max``
    with the mask: one element of ``proc/edge/w/1``, the port 1.9e-6 and
    JAX 0.8e-6 off its float64 value), while the algorithm is the point."""
    jcfg, cfg = _cfgs(J, agg)
    jp, tp = _weights(J, jcfg)
    b = _graph(mask=mask)
    got, want, _, _ = _grads_both(J, jcfg, cfg, jp, tp, b)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with J.jax.enable_x64(True):
        jcfg64, cfg64 = _cfgs(J, agg, dtype="float64")
        jp64 = J.jax.tree.map(lambda a: J.jnp.asarray(np.asarray(a, np.float64)), jp)
        tp64 = gnn.params_from_numpy(J.jax.tree.map(np.asarray, jp64), "cpu")
        b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in b.items()}
        _assert_grads(*_grads_both(J, jcfg64, cfg64, jp64, tp64, b64))


@pytest.mark.parametrize("agg", AGGS)
def test_batched_loss_and_gradients_match_jax(J, agg):
    jcfg, cfg = _cfgs(J, agg)
    jp, tp = _weights(J, jcfg)
    _assert_grads(*_grads_both(J, jcfg, cfg, jp, tp, _graph(10, 24, seed=4, n_graphs=3),
                               batched=True))


@pytest.mark.parametrize("agg", AGGS)
def test_ids_outside_the_graph_follow_jax(J, agg):
    """Senders and receivers -1, -N, -N-5, N, N+13 (N = 20): JAX's gather
    wraps [-N, 0) and clamps the rest (a clamped id passes no gradient),
    its segment reductions drop every receiver outside [0, N). Outputs,
    the loss and every gradient leaf."""
    jcfg, cfg = _cfgs(J, agg)
    jp, tp = _weights(J, jcfg)
    b = _graph(mask=True)
    bad = np.array([-1, -20, -25, 20, 33], np.int32)
    b["senders"][25:30] = bad
    b["receivers"][30:35] = bad
    b["senders"][35:40] = bad[::-1]
    b["receivers"][35:40] = bad
    got, want = _forward_both(J, jcfg, cfg, jp, tp, b)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(*_grads_both(J, jcfg, cfg, jp, tp, b))


@pytest.mark.parametrize("agg", AGGS)
def test_batched_ids_outside_each_graph_stay_in_their_graph(J, agg):
    """The same ids in the batched form are resolved within each graph: a
    clamped sender reads its own graph's last node, a dropped receiver
    reaches no node of the next graph."""
    jcfg, cfg = _cfgs(J, agg)
    jp, tp = _weights(J, jcfg)
    b = _graph(10, 24, seed=5, n_graphs=3)
    bad = np.array([-1, -10, -14, 10, 23], np.int32)
    b["senders"][0, 12:17] = bad
    b["receivers"][1, 12:17] = bad
    b["senders"][2, 17:22] = bad
    b["receivers"][2, 17:22] = bad[::-1]
    got, want = _forward_both(J, jcfg, cfg, jp, tp, b, batched=True)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(*_grads_both(J, jcfg, cfg, jp, tp, b, batched=True))


def test_empty_max_segment_is_minus_inf_as_in_jax(J):
    """Under ``max`` a node that no edge reaches aggregates -inf, so its row
    turns NaN in the node MLP and spreads along its out-edges, as in JAX:
    the same NaN positions and the same finite values elsewhere."""
    jcfg, cfg = _cfgs(J, "max")
    jp, tp = _weights(J, jcfg)
    b = _graph(cover=False)
    b["receivers"] = np.where(b["receivers"] == 7, 8, b["receivers"]).astype(np.int32)
    b["senders"] = np.where(b["senders"] == 7, 8, b["senders"]).astype(np.int32)
    got, want = _forward_both(J, jcfg, cfg, jp, tp, b)
    assert np.isnan(want[7]).all() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    agg = gnn._aggregate(torch.ones((3, 2)), torch.tensor([0, 0, 2]), 3, "max")
    assert torch.isneginf(agg[1]).all() and (agg[[0, 2]] == 1).all()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_remat_gradients_are_bit_equal(J, agg, batched):
    """``remat`` recomputes each layer in the backward: the same loss and
    the same gradient tree, bit for bit."""
    _, cfg = _cfgs(J, agg)
    _, tp = _weights(J, J.cfg)
    b = _graph(10, 24, seed=6, n_graphs=2) if batched else _graph(mask=True)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    out = []
    for remat in (True, False):
        loss = functools.partial(gnn.loss_fn, cfg=dataclasses.replace(cfg, remat=remat),
                                 batched=batched)
        out.append(value_and_grad(loss, tp, batch))
    (l1, _, g1), (l2, _, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves(g1), tree_leaves(g2)))


def test_weights_cross_the_export_format_both_ways(J):
    """JAX writes ``RPROAVRO1``, the port reads it (forward equal); the
    port writes, the JAX package restores its own tree bit for bit."""
    jcfg, cfg = _cfgs(J)
    jp, tp = _weights(J, jcfg)
    flat, _ = export.loads(J.export.dumps(jp, model="meshgraphnet-smoke"))
    tree = gnn.params_from_numpy(export.unflatten(flat), "cpu")
    assert isinstance(tree["dec"]["w"], list) and tree["proc"]["edge"]["w"][0].dim() == 3
    b = _graph()
    got = gnn.forward(tree, *[torch.from_numpy(b[k]) for k in KEYS], cfg)
    want = J.gnn.forward(jp, *[J.jnp.asarray(b[k]) for k in KEYS], jcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jflat, _ = J.export.loads(export.dumps(tp))
    back = J.export.restore_into(jp, jflat)
    for a, c in zip(J.jax.tree.leaves(back), J.jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


# ---------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("agg", AGGS)
def test_cuda_matches_the_cpu(cuda_device, agg):
    """reduced(meshgraphnet) float32 on the card against the CPU: forward,
    forward_batched, and loss_fn's value and every gradient leaf (the
    scatter's float atomics sum in another order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("meshgraphnet")), aggregator=agg)
    cpu = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), D_FEAT, "cpu")
    card = gnn.params_from_numpy(cpu, cuda_device)
    for batched, b in ((False, _graph(mask=True)), (True, _graph(10, 24, n_graphs=3))):
        loss = functools.partial(gnn.loss_fn, cfg=cfg, batched=batched)
        l_cpu, _, g_cpu = value_and_grad(loss, cpu, {k: torch.from_numpy(v)
                                                     for k, v in b.items()})
        l_card, _, g_card = value_and_grad(loss, card, {k: torch.from_numpy(v).to(cuda_device)
                                                        for k, v in b.items()})
        np.testing.assert_allclose(l_card.item(), l_cpu.item(), rtol=1e-5)
        for a, c in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
            np.testing.assert_allclose(_np(a.cpu()), _np(c), **GRAD_TOL)
