"""The port's BERT4Rec and ``layers.layer_norm`` against the JAX package's
``repro.models.recsys`` and ``repro.models.layers``.

On ``reduced(bert4rec)`` (d 8, 2 blocks, 2 heads, seq 16, 100 items,
float32) on the CPU, with the JAX weights carried into the port by
``params_from_numpy`` (and through ``RPROAVRO1``) and batches from each
package's data module with the same seed:

* ``layer_norm`` in float32 and bfloat16;
* ``bert4rec_encode``, ``serve_step`` (``bert4rec_pointwise`` on the
  serving batch ``{"seq", "target"}`` that ``launch/specs.py`` builds) and
  ``retrieval_step`` (``bert4rec_retrieval``) at rtol 1e-4 / atol 1e-5,
  ``loss_fn``'s sampled softmax and EVERY gradient leaf against
  ``jax.value_and_grad`` at rtol 1e-4 / atol 1e-6, 5 ``Trainer`` steps;
* ids outside the table (``jnp.take``'s: [-V, 0) wraps, a NaN row outside
  [-V, V)) and the [MASK] row ``n_items``;
* the lookups: one bag of one row per id, one ``EmbeddingBag`` node per
  loss (the table gradient one float32 sum, rounded once: in bfloat16
  within a unit in the last place of JAX's float32 gradient of the same
  cotangents), the ``lookup="plain"`` route bit-equal;
* in bfloat16, the attention scores are a float32 product of the bf16
  heads, as JAX's ``preferred_element_type=float32``: the float32 encode
  catches an exact GELU (JAX's is the tanh form), the bfloat16 one bf16
  scores; the bfloat16 encode with the MLP branch on (random biases)
  agrees within ``BF16_MLP_ATOL``, which JAX's per-op bf16 GELU stays
  under and a dropped term or another activation does not.

The ``cuda``-marked test holds the lookups through the kernels against the
plain route on the card and skips where no card is present. The JAX side is
imported by a fixture, so that it runs on a machine with the port's
dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bert4rec.py
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import export
from repro_torch.core.treepath import tree_leaves
from repro_torch.data import recsys as data
from repro_torch.kernels import embedding_bag as EB
from repro_torch.models import layers
from repro_torch.models import recsys as rec
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import Trainer, value_and_grad

torch.set_num_threads(2)
CFG = reduced(get_config("bert4rec"))
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: one bfloat16 unit in the last place, relative
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def J():
    """The JAX package's side of the comparison: reduced(bert4rec) and its
    weights from PRNGKey(0)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config, reduced as jax_reduced
    from repro.core import export as jax_export
    from repro.models import layers as jax_layers
    from repro.models import recsys as jax_rec
    from repro.training import optimizer as jax_opt, train_loop as jax_loop
    jcfg = jax_reduced(jax_get_config("bert4rec"))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, rec=jax_rec, layers=jax_layers, export=jax_export, opt=jax_opt,
        loop=jax_loop, get_config=jax_get_config, cfg=jcfg,
        params=jax_rec.init_model(jax.random.PRNGKey(0), jcfg))


def _port(J, params=None):
    tree = J.params if params is None else params
    return rec.params_from_numpy(J.jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(J, batch):
    return {k: J.jnp.asarray(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _serve_batch(cfg, batch, seed):
    """The serving batch ``{"seq", "target"}`` (``src/repro/launch/specs.py``
    builds it so), from ``data/recsys.py``'s training batch."""
    b = data.batch_for(cfg, batch, seed=seed)
    return {"seq": b["seq"], "target": b["label"]}


def _loss_and_grads(J, cfg, jcfg, jp, tp, batch):
    (want, want_m), want_g = J.jax.value_and_grad(
        functools.partial(J.rec.loss_fn, cfg=jcfg), has_aux=True)(jp, _j(J, batch))
    got, got_m, grads = value_and_grad(functools.partial(rec.loss_fn, cfg=cfg), tp, _t(batch))
    return (got, got_m, _flat(grads)), (want, want_m, _flat(want_g))


# ------------------------------------------------------------------ configs --

def test_config_matches_jax(J):
    cfg, jcfg = get_config("bert4rec"), J.get_config("bert4rec")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(CFG) == dataclasses.asdict(J.cfg)
    assert cfg.n_params() == jcfg.n_params() == 64_111_104


@pytest.mark.parametrize("full", [False, True])
def test_init_model_has_the_jax_tree(J, full):
    """Names, shapes and dtypes of every leaf (the table padded to
    padded_rows(n_items + 1) rows, the blocks stacked on a leading n_blocks
    axis); the same seed draws the same values."""
    cfg = get_config("bert4rec") if full else CFG
    jcfg = J.get_config("bert4rec") if full else J.cfg
    shapes = _flat(J.jax.eval_shape(lambda: J.rec.init_model(J.jax.random.PRNGKey(0), jcfg)))
    flat = _flat(rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert sorted(flat) == sorted(shapes)
    for name, t in flat.items():
        assert tuple(t.shape) == shapes[name].shape, name
        assert str(t.dtype) == f"torch.{shapes[name].dtype}", name
    assert flat["emb"].shape[0] == rec.padded_rows(cfg.n_items + 1) > cfg.n_items
    assert flat["blocks/wqkv"].shape == (cfg.n_blocks, cfg.embed_dim, 3 * cfg.embed_dim)
    if full:   # the padded tree is a little larger than n_params()
        assert sum(t.numel() for t in flat.values()) == 64_141_056
        return
    assert abs(flat["emb"].std().item() - 0.02) < 2e-3
    assert bool((flat["blocks/ln1_w"] == 1).all() and (flat["blocks/b1"] == 0).all())
    again = _flat(rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert all(torch.equal(again[k], t) for k, t in flat.items())


# --------------------------------------------------------------- layer_norm --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(J, dtype):
    """float32 at the score tolerance; bfloat16 within one unit in the last
    place (both compute in float32 and round once, the sums in another
    order), and equal to the float32 result rounded."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 7, 64)) * 4 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = J.jnp.dtype(dtype), getattr(torch, dtype)
    want = J.layers.layer_norm(*(J.jnp.asarray(a).astype(jdt) for a in (x, w, b)))
    args = [torch.from_numpy(a).to(tdt) for a in (x, w, b)]
    got = layers.layer_norm(*args)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=1e-6)
    assert torch.equal(got, layers.layer_norm(*(a.float() for a in args)).to(tdt))


# ------------------------------------------------------------------ serving --

@pytest.mark.parametrize("batch", [1, 7])
def test_encode_matches_jax(J, batch):
    seq = data.batch_for(CFG, batch, seed=2)["seq"]
    want = J.rec.bert4rec_encode(J.params, J.jnp.asarray(seq), J.cfg)
    got = rec.bert4rec_encode(_port(J), torch.from_numpy(seq), CFG)
    assert tuple(got.shape) == (batch, CFG.seq_len, CFG.embed_dim)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("batch,seed", [(1, 0), (37, 3)])
def test_serve_step_matches_jax(J, batch, seed):
    b = _serve_batch(CFG, batch, seed)
    want = J.rec.serve_step(J.params, _j(J, b), J.cfg)
    got = rec.serve_step(_port(J), _t(b), CFG)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("n,users", [(1, 1), (500, 1), (60, 3)])
def test_retrieval_step_matches_jax(J, n, users):
    b = data.retrieval_batch(CFG, n, seed=5)
    b["seq"] = data.batch_for(CFG, users, seed=6)["seq"] if users > 1 else b["seq"]
    want = J.rec.retrieval_step(J.params, _j(J, b), J.cfg)
    got = rec.retrieval_step(_port(J), _t(b), CFG)
    assert tuple(got.shape) == tuple(want.shape) == (users, n)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_retrieval_equals_serving_each_candidate(J):
    params = _port(J)
    b = _t(data.retrieval_batch(CFG, 9, seed=7))
    got = rec.retrieval_step(params, b, CFG)[0]
    want = rec.serve_step(params, {"seq": b["seq"].expand(9, -1), "target": b["candidates"]},
                          CFG)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mask_row_is_a_row_like_any_other(J):
    """Row ``n_items`` is the [MASK] token (inside the padded table, past
    every item id): sequences holding it serve as in JAX, and the loss's
    gradient reaches that row as in JAX."""
    b = data.batch_for(CFG, 8, seed=8)
    b["seq"][:, -1] = CFG.n_items
    b["seq"][::2, 3] = CFG.n_items
    sb = {"seq": b["seq"], "target": b["label"]}
    want = J.rec.serve_step(J.params, _j(J, sb), J.cfg)
    got = rec.serve_step(_port(J), _t(sb), CFG)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    (_, _, grads), (_, _, want_g) = _loss_and_grads(J, CFG, J.cfg, J.params, _port(J), b)
    row = _np(grads["emb"])[CFG.n_items]
    assert np.abs(row).max() > 0
    np.testing.assert_allclose(row, _np(want_g["emb"])[CFG.n_items], **GRAD_TOL)


def _outside(v):
    """Ids at the table's edges: -1 and -V (``jnp.take`` wraps them to rows
    V - 1 and 0), V and -V-1 (NaN rows); V is the padded table's rows."""
    return np.array([-1, -v, v, -v - 1], dtype=np.int32)


@pytest.mark.parametrize("where", ["seq", "target", "candidates"])
def test_ids_outside_the_table_follow_jnp_take(J, where):
    """Serving and retrieval at ids -1, -V, V and -V-1: JAX's scores, NaN
    where JAX gives NaN (a NaN row in a sequence reaches every position of
    it through attention), and no IndexError."""
    v = J.params["emb"].shape[0]
    if where == "candidates":
        b = data.retrieval_batch(CFG, 8, seed=9)
        b["candidates"][:4] = _outside(v)
        jstep, step = J.rec.retrieval_step, rec.retrieval_step
    else:
        b = _serve_batch(CFG, 8, seed=9)
        if where == "seq":
            b["seq"][:4, 5] = _outside(v)
        else:
            b["target"][:4] = _outside(v)
        jstep, step = J.rec.serve_step, rec.serve_step
    want = _np(jstep(J.params, _j(J, b), J.cfg))
    got = _np(step(_port(J), _t(b), CFG))
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_wrapped_ids_train_like_jax(J):
    """Ids -1 and -V in the sequence, the label and the negatives: the loss
    and EVERY gradient leaf finite and equal to JAX's, the wrapped rows'
    included. With V and -V-1 as well: the loss NaN in both, and the
    table's gradient equal to JAX's where finite and NaN where JAX's is
    (a NaN id's own row gets nothing: the backward drops it)."""
    v = J.params["emb"].shape[0]
    b = data.batch_for(CFG, 8, seed=10)
    b["seq"][0, :2] = (-1, -v)
    b["label"][1:3] = (-1, -v)
    b["negatives"][3, :2] = (-1, -v)
    bad = {k: x.copy() for k, x in b.items()}
    bad["seq"][4, 0], bad["negatives"][5, 1] = v, -v - 1
    for batch, finite in ((b, True), (bad, False)):
        (got, _, grads), (want, _, want_g) = _loss_and_grads(J, CFG, J.cfg, J.params,
                                                            _port(J), batch)
        assert np.isfinite(got.item()) == finite == np.isfinite(float(want))
        for path, g in grads.items():
            if finite or path == "emb":
                np.testing.assert_allclose(_np(g), _np(want_g[path]), err_msg=path,
                                           equal_nan=not finite, **GRAD_TOL)
            if finite:
                assert np.isfinite(_np(g)).all(), path
        emb = _np(grads["emb"])
        assert np.abs(emb[[0, v - 1]]).max() > 0 if finite else True


# ----------------------------------------------------------------- training --

def test_loss_and_every_gradient_leaf_match_jax(J):
    b = data.batch_for(CFG, 64, seed=3)
    before = (EB.launches, EB.bwd_launches)
    (got, got_m, grads), (want, want_m, want_g) = _loss_and_grads(
        J, CFG, J.cfg, J.params, _port(J), b)
    assert (EB.launches, EB.bwd_launches) == before   # the CPU path launches nothing
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(got_m) == {"ce"} and got_m["ce"].item() == got.item()
    assert sorted(grads) == sorted(want_g)
    for path, g in grads.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), _np(want_g[path]), err_msg=path, **GRAD_TOL)


def test_each_step_looks_its_rows_up_in_one_bag_call(J, monkeypatch):
    """``serve_step``, ``retrieval_step`` and ``loss_fn`` each make one call
    of the bag (bags of one row, the ids of every lookup concatenated), on
    either route; the loss is one ``EmbeddingBag`` node, and the plain
    route gives the same loss and gradient tree bit for bit."""
    calls = []
    plain = EB.embedding_bag_plain
    monkeypatch.setattr(EB, "embedding_bag_plain",
                        lambda table, ids, w=None: calls.append(tuple(ids.shape))
                        or plain(table, ids, w))
    params = _port(J)
    sb, rb = _t(_serve_batch(CFG, 5, 1)), _t(data.retrieval_batch(CFG, 40, seed=1))
    lb = _t(data.batch_for(CFG, 6, seed=1))
    trees = {}
    for lookup in ("kernel", "plain"):
        calls.clear()
        rec.serve_step(params, sb, CFG, lookup=lookup)
        rec.retrieval_step(params, rb, CFG, lookup=lookup)
        loss, _, grads = value_and_grad(
            functools.partial(rec.loss_fn, cfg=CFG, lookup=lookup), params, lb)
        s = CFG.seq_len
        assert calls == [(5 * s + 5, 1), (s + 40, 1), (6 * (s + 1 + CFG.n_negatives), 1)]
        seen, stack, n = set(), [loss.grad_fn], 0
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            n += type(fn).__name__ == "EmbeddingBagBackward"
            stack.extend(f for f, _ in fn.next_functions)
        assert n == 1, lookup
        trees[lookup] = (loss, grads)
    assert torch.equal(trees["kernel"][0], trees["plain"][0])
    for a, b in zip(tree_leaves(trees["kernel"][1]), tree_leaves(trees["plain"][1])):
        assert torch.equal(a, b)


def test_trainer_steps_match_jax(J):
    """5 ``Trainer`` + ``adamw`` steps (the launcher's warmup-cosine
    schedule) from the same weights on the same batches."""
    sched = dict(peak_lr=1e-3, warmup=10, total=5)
    tr = Trainer(functools.partial(rec.loss_fn, cfg=CFG),
                 opt.adamw(opt.warmup_cosine_schedule(**sched)), _port(J))
    jtr = J.loop.Trainer(functools.partial(J.rec.loss_fn, cfg=J.cfg),
                         J.opt.adamw(J.opt.warmup_cosine_schedule(**sched)), J.params)
    tr.run(data.batches(CFG, 32, seed=0), max_steps=5, log_every=0)
    jtr.run(data.batches(CFG, 32, seed=0), max_steps=5, log_every=0)
    assert tr.step == jtr.step == 5
    for i, (got, want) in enumerate(zip(tr.history, jtr.history)):
        for key in ("loss", "ce"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=f"step {i} {key}")
    assert tr.history[-1]["loss"] != tr.history[0]["loss"]


def test_weights_cross_the_export_format_both_ways(J):
    """JAX writes ``RPROAVRO1``, the port reads it (scores equal); the port
    writes, the JAX package restores its own tree bit for bit."""
    flat, _ = export.loads(J.export.dumps(J.params, model="bert4rec-smoke"))
    assert "blocks/wqkv" in flat and flat["blocks/wqkv"].shape[0] == CFG.n_blocks
    tree = rec.params_from_numpy(export.unflatten(flat), "cpu")
    b = _serve_batch(CFG, 6, 11)
    np.testing.assert_allclose(_np(rec.serve_step(tree, _t(b), CFG)),
                               _np(J.rec.serve_step(J.params, _j(J, b), J.cfg)), **TOL)
    jflat, _ = J.export.loads(export.dumps(_port(J)))
    back = J.export.restore_into(J.params, jflat)
    for a, c in zip(J.jax.tree.leaves(back), J.jax.tree.leaves(J.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


# ----------------------------------------------------------------- bfloat16 --

def _bf16(J, q_scale=4.0):
    """reduced(bert4rec) in bfloat16 with the JAX weights cast, each block's
    query and key columns scaled by ``q_scale`` (scores in the tens, where
    bfloat16 keeps a unit or less) and ``w2`` zeroed: the MLP branch adds
    0, so JAX's GELU (each op rounded to bfloat16) and the port's (one
    rounding) are out of the comparison."""
    jcfg = dataclasses.replace(J.cfg, dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jnp = J.jnp
    d = cfg.embed_dim
    jp = J.jax.tree.map(lambda a: a.astype(jnp.bfloat16), J.params)
    cols = jnp.concatenate([jnp.full((2 * d,), q_scale), jnp.ones((d,))])
    jp["blocks"]["wqkv"] = (jp["blocks"]["wqkv"].astype(jnp.float32) * cols).astype(jnp.bfloat16)
    jp["blocks"]["w2"] = jnp.zeros_like(jp["blocks"]["w2"])
    return jcfg, cfg, jp


def test_bfloat16_scores_are_float32_products(J):
    """JAX takes the bf16 heads' scores in float32
    (``preferred_element_type``) before the float32 softmax; the port's
    encode in bfloat16 agrees within a unit in the last place (bf16 scores
    miss by ~0.1 here)."""
    jcfg, cfg, jp = _bf16(J)
    seq = data.batch_for(cfg, 16, seed=1)["seq"]
    want = J.rec.bert4rec_encode(jp, J.jnp.asarray(seq), jcfg)
    got = rec.bert4rec_encode(_port(J, jp), torch.from_numpy(seq), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=BF16_ULP)


#: the bfloat16 encode with the MLP branch on: JAX rounds each op of its
#: GELU to bfloat16, the port once, and the gap reaches 0.0508 (seeds 1-4,
#: batches 16 and 64); a branch that drops a bias reads 1.6-3.0 and one with
#: ReLU for the GELU 0.41-0.87
BF16_MLP_ATOL = 0.1


@pytest.mark.parametrize("seed", [1, 2])
def test_bfloat16_encode_with_the_mlp_matches_jax(J, seed):
    """The bfloat16 encode with every term of the MLP branch live (w1, a
    random b1, the GELU, w2, a random b2) agrees with JAX within
    BF16_MLP_ATOL: above the per-op rounding gap of JAX's bf16 GELU, below
    what a wrong branch reads."""
    jcfg, cfg = dataclasses.replace(J.cfg, dtype="bfloat16"), dataclasses.replace(
        CFG, dtype="bfloat16")
    jnp = J.jnp
    jp = J.jax.tree.map(lambda a: a.astype(jnp.bfloat16), J.params)
    rng = np.random.default_rng(0)
    for k in ("b1", "b2"):
        jp["blocks"][k] = jnp.asarray(rng.normal(0.0, 0.5, jp["blocks"][k].shape)
                                      .astype(np.float32)).astype(jnp.bfloat16)
    seq = data.batch_for(cfg, 16, seed=seed)["seq"]
    want = J.rec.bert4rec_encode(jp, jnp.asarray(seq), jcfg)
    got = rec.bert4rec_encode(_port(J, jp), torch.from_numpy(seq), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=BF16_MLP_ATOL)


def test_bfloat16_table_gradient_is_the_float32_sum_rounded_once(J, monkeypatch):
    """The bf16 table's gradient is the float32 sum of the lookups'
    cotangents, rounded once: within a unit in the last place of JAX's
    float32 ``jnp.take`` VJP of the same cotangents (JAX's own bf16 VJP
    sums in bfloat16, reference fault 8)."""
    _, cfg, jp = _bf16(J, q_scale=1.0)
    seen = []
    plain = EB.embedding_bag_bwd_plain
    monkeypatch.setattr(EB, "embedding_bag_bwd_plain",
                        lambda g, ids, w, n: seen.append((g, ids)) or plain(g, ids, w, n))
    b = data.batch_for(cfg, 16, seed=12)
    b["negatives"][:, :4] = 7      # one row named 64 times besides its random uses
    _, _, grads = value_and_grad(functools.partial(rec.loss_fn, cfg=cfg), _port(J, jp), _t(b))
    (g, ids), = seen
    assert g.dtype == torch.bfloat16 and grads["emb"].dtype == torch.bfloat16
    jnp = J.jnp
    table = jnp.zeros(grads["emb"].shape, jnp.float32)
    _, vjp = J.jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids.numpy()[:, 0]), axis=0), table)
    (want,) = vjp(jnp.asarray(g.float().numpy()))
    np.testing.assert_allclose(_np(grads["emb"]), np.asarray(want), rtol=BF16_ULP, atol=1e-6)


# ---------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bag kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lookups_equal_the_plain_route(cuda_device, dtype):
    """reduced(bert4rec) at d 64 on the card: serve, retrieval, the loss and
    its gradient tree through the bag kernels equal to the ``plain`` route,
    one forward launch a step and one backward launch a loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CFG, embed_dim=64, dtype=dtype)
    params = rec.init_model(cfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)

    def on(b):
        return {k: torch.from_numpy(v).to(cuda_device) for k, v in b.items()}

    sb, rb = on(_serve_batch(cfg, 64, 1)), on(data.retrieval_batch(cfg, 5000, seed=2))
    lb = on(data.batch_for(cfg, 64, seed=3))
    out = {}
    for lookup in ("kernel", "plain"):
        before = (EB.launches, EB.bwd_launches)
        with torch.no_grad():
            serve = rec.serve_step(params, sb, cfg, lookup=lookup)
            ret = rec.retrieval_step(params, rb, cfg, lookup=lookup)
        loss, _, grads = value_and_grad(
            functools.partial(rec.loss_fn, cfg=cfg, lookup=lookup), params, lb)
        out[lookup] = (serve, ret, loss, grads,
                       (EB.launches - before[0], EB.bwd_launches - before[1]))
    k, p = out["kernel"], out["plain"]
    assert k[4] == (3, 1) and p[4] == (0, 0)
    assert torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all()
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(k[3]), tree_leaves(p[3])):
        assert torch.equal(a, b)
