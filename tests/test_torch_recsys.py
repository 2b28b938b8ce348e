"""The port's DLRM serving path against ``repro.models.recsys``,
``repro.models.layers``, ``repro.data.recsys`` and ``repro.configs``.

Inputs come from the data module of each package with the same seed;
JAX parameters come from ``repro.models.recsys.init_model`` and reach the
port through ``params_from_numpy``. Everything runs in float32 on the CPU
on ``reduced(dlrm-mlperf)``, where the point is the algorithm; the lookups
run through the EmbeddingBag wrapper, which on CPU tensors runs its plain
version (``tests/test_torch_embedding_bag.py`` holds that against the JAX
oracle). Scores are held at the repo's score tolerance (``rtol=1e-4,
atol=1e-5``); lookups and data exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RECSYS_SHAPES as JAX_RECSYS_SHAPES
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import export as jax_export
from repro.data import recsys as jax_data
from repro.models import layers as jax_layers, recsys as jax_rec
from repro_torch.configs import RECSYS_SHAPES, RecsysConfig, get_config, reduced
from repro_torch.core import export
from repro_torch.data import recsys as data
from repro_torch.kernels import embedding_bag as EB
from repro_torch.models import layers, recsys as rec

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = ("dlrm-mlperf", "fm", "din", "bert4rec")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_cfg(jcfg):
    """The port's RecsysConfig with the JAX config's fields."""
    return RecsysConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _dlrm():
    """reduced(dlrm-mlperf) in both packages, with the JAX weights (jnp)
    and the port's copy of them (via params_from_numpy)."""
    jcfg = jax_reduced(jax_get_config("dlrm-mlperf"))
    cfg = reduced(get_config("dlrm-mlperf"))
    jp = jax_rec.init_model(jax.random.PRNGKey(0), jcfg)
    tp = rec.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


# ----------------------------------------------------------------- configs --

def test_dlrm_config_matches_jax():
    cfg, jcfg = get_config("dlrm-mlperf"), jax_get_config("dlrm-mlperf")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params() == 24_036_595_969
    assert cfg.total_vocab == jcfg.total_vocab == 187_767_399
    assert rec.padded_rows(cfg.total_vocab) == 187_767_808
    assert [dataclasses.asdict(s) for s in RECSYS_SHAPES] == \
        [dataclasses.asdict(s) for s in JAX_RECSYS_SHAPES]


@pytest.mark.parametrize("arch", KINDS)
def test_reduced_recsys_configs_match_jax(arch):
    jcfg = jax_get_config(arch)
    assert dataclasses.asdict(reduced(_port_cfg(jcfg))) == \
        dataclasses.asdict(jax_reduced(jcfg))


# -------------------------------------------------------------------- data --

@pytest.mark.parametrize("arch", KINDS)
def test_data_is_byte_equal_to_jax(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = _port_cfg(jcfg)
    pairs = [(data.batch_for(cfg, 33, seed=7), jax_data.batch_for(jcfg, 33, seed=7)),
             (data.retrieval_batch(cfg, 100, seed=3), jax_data.retrieval_batch(jcfg, 100, seed=3))]
    for got, want in zip(data.batches(cfg, 5, seed=2), jax_data.batches(jcfg, 5, seed=2)):
        pairs.append((got, want))
        if len(pairs) == 4:
            break
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_full_width_ids_lie_in_their_fields():
    cfg = get_config("dlrm-mlperf")
    ids = data.batch_for(cfg, 512, seed=0)["ids"]
    assert ids.dtype == np.int32 and ids.shape == (512, 26)
    assert (ids >= 0).all() and (ids < np.asarray(cfg.vocab_sizes)).all()
    gids = ids + _np(rec.field_offsets(cfg.vocab_sizes, "cpu")).astype(np.int64)
    assert gids.max() < cfg.total_vocab < 2 ** 31


# ------------------------------------------------------------------ layers --

def test_mlp_apply_matches_jax():
    dims = (13, 16, 8, 3)
    jp = jax_layers.mlp_params(jax.random.PRNGKey(3), dims)
    tp = rec.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert isinstance(tp["w"], list) and [tuple(w.shape) for w in tp["w"]] == \
        [(13, 16), (16, 8), (8, 3)]
    x = np.random.default_rng(0).standard_normal((9, 13)).astype(np.float32)
    for kw, tkw in (({}, {}),
                    (dict(act=jax.nn.relu, final_act=jax.nn.relu),
                     dict(act=torch.relu, final_act=torch.relu)),
                    (dict(act=jax.nn.sigmoid), dict(act=torch.sigmoid))):
        want = jax_layers.mlp_apply(jp, jnp.asarray(x), **kw)
        got = layers.mlp_apply(tp, torch.from_numpy(x), **tkw)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mlp_params_has_the_jax_shapes_and_scales():
    dims = (479, 64, 1)
    tp = layers.mlp_params(torch.Generator().manual_seed(0), dims)
    jp = jax_layers.mlp_params(jax.random.PRNGKey(0), dims)
    for key in ("w", "b"):
        assert [tuple(t.shape) for t in tp[key]] == [a.shape for a in jp[key]]
    assert abs(tp["w"][0].std().item() - 479 ** -0.5) < 0.005
    assert all(bool((b == 0).all()) for b in tp["b"])


@pytest.mark.parametrize("f", [2, 5, 27])
def test_dot_interaction_matches_jax_in_triu_order(f):
    iu, ju = torch.triu_indices(f, f, 1)
    jiu, jju = jnp.triu_indices(f, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))
    vecs = np.random.default_rng(f).standard_normal((4, f, 8)).astype(np.float32)
    got = rec.dot_interaction(torch.from_numpy(vecs))
    want = jax_rec.dot_interaction(jnp.asarray(vecs))
    assert tuple(got.shape) == (4, f * (f - 1) // 2)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -------------------------------------------------------------- embeddings --

def test_embedding_lookup_equals_jax_exactly():
    jcfg, cfg, jp, tp = _dlrm()
    ids = data.batch_for(cfg, 17, seed=4)["ids"]
    want = jax_rec.embedding_lookup(jp["emb"], jnp.asarray(ids),
                                    jax_rec.field_offsets(jcfg.vocab_sizes))
    before = EB.launches
    got = rec.embedding_lookup(tp["emb"], torch.from_numpy(ids),
                               rec.field_offsets(cfg.vocab_sizes, "cpu"))
    assert EB.launches == before
    assert tuple(got.shape) == (17, cfg.n_sparse, cfg.embed_dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_np(rec.field_offsets(cfg.vocab_sizes, "cpu")),
                                  np.asarray(jax_rec.field_offsets(jcfg.vocab_sizes)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_take_rows_follows_jnp_take(dtype, shape):
    """FM's and DIN's lookup helper against ``jnp.take``: every id from -V-3
    to V+2 (a row, a wrapped row [-V, 0), or NaN outside [-V, V)), bit for
    bit with NaN where JAX gives NaN, and no host wait (no ``.item()``)."""
    v, d = 6, 3
    rng = np.random.default_rng(11)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(-v - 3, v + 3, size=shape).astype(np.int32)
    ids.reshape(-1)[:4] = (-1, -v, v, -v - 1)
    jt = jnp.asarray(table).astype(jnp.dtype(dtype))
    want = np.asarray(jnp.take(jt, jnp.asarray(ids), axis=0).astype(jnp.float32))
    got = rec.take_rows(torch.from_numpy(table).to(getattr(torch, dtype)),
                        torch.from_numpy(ids))
    assert tuple(got.shape) == shape + (d,) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), want)
    assert np.isnan(want).any() and not np.isnan(want).all()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ragged_embedding_bag_matches_jax(mode, weighted):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    flat_ids = rng.integers(0, 40, 23).astype(np.int32)
    # bags 0..6 with bag 3 empty
    segs = np.sort(rng.choice([0, 1, 2, 4, 5, 6], 23)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, 23).astype(np.float32) if weighted else None
    want = jax_rec.embedding_bag(jnp.asarray(table), jnp.asarray(flat_ids), jnp.asarray(segs),
                                 7, None if w is None else jnp.asarray(w), mode)
    got = rec.embedding_bag(torch.from_numpy(table), torch.from_numpy(flat_ids),
                            torch.from_numpy(segs), 7,
                            None if w is None else torch.from_numpy(w), mode)
    assert tuple(got.shape) == (7, 6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(ValueError):
        rec.embedding_bag(torch.from_numpy(table), torch.from_numpy(flat_ids),
                          torch.from_numpy(segs), 7, mode="median")


# -------------------------------------------------------------------- DLRM --

@pytest.mark.parametrize("batch,seed", [(1, 0), (64, 5)])
def test_serve_step_matches_jax(batch, seed):
    jcfg, cfg, jp, tp = _dlrm()
    b = data.batch_for(cfg, batch, seed=seed)
    want = jax_rec.serve_step(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    got = rec.serve_step(tp, _t(b), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_array_equal(_np(rec.serve_step(tp, _t(b), cfg, lookup="plain")),
                                  _np(got))


@pytest.mark.parametrize("n", [1, 300])
def test_retrieval_step_matches_jax(n):
    jcfg, cfg, jp, tp = _dlrm()
    b = data.retrieval_batch(cfg, n, seed=9)
    want = jax_rec.retrieval_step(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    got = rec.retrieval_step(tp, _t(b), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_retrieval_equals_serving_each_candidate():
    """Scoring N candidates at once equals serving the N rows that differ
    only in the last field (the decomposition changes nothing)."""
    _, cfg, _, tp = _dlrm()
    b = data.retrieval_batch(cfg, 12, seed=1)
    rows = {"dense": np.repeat(b["dense"], 12, 0),
            "ids": np.concatenate([np.repeat(b["user_ids"], 12, 0),
                                   b["candidates"][:, None]], 1)}
    np.testing.assert_allclose(_np(rec.retrieval_step(tp, _t(b), cfg)),
                               _np(rec.serve_step(tp, _t(rows), cfg)), **TOL)


def test_init_model_has_the_jax_tree():
    jcfg, cfg, jp, _ = _dlrm()
    tree = rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jflat = jax_export._flatten_named(jax.tree.map(np.asarray, jp))
    flat = export.flatten_named(tree)
    assert sorted(flat) == sorted(jflat) and "bot/w/0" in flat and "top/b/2" in flat
    for name, arr in flat.items():
        assert arr.shape == jflat[name].shape and arr.dtype == jflat[name].dtype, name
    assert flat["emb"].shape == (rec.padded_rows(sum(cfg.vocab_sizes)), cfg.embed_dim)
    again = export.flatten_named(rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    for name in flat:
        np.testing.assert_array_equal(again[name], flat[name])


def test_table_is_drawn_in_place_in_chunks(monkeypatch):
    monkeypatch.setattr(rec, "INIT_CHUNK_ROWS", 1000)
    t = rec._table_init(torch.Generator().manual_seed(0), 4500, 16, torch.bfloat16)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (4500, 16)
    for chunk in t.float().split(1000):   # every chunk drawn, none left empty
        assert abs(chunk.std().item() - 0.02) < 0.002 and abs(chunk.mean().item()) < 0.002


def test_dlrm_tree_round_trips_through_export_both_ways():
    jcfg, cfg, jp, tp = _dlrm()
    b = data.batch_for(cfg, 8, seed=2)
    want = jax_rec.serve_step(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    # JAX writes, the port reads, through unflatten + params_from_numpy
    flat, _ = export.loads(jax_export.dumps(jp, model="dlrm-mlperf-smoke"))
    assert "bot/w/0" in flat and "top/w/2" in flat
    tree = export.unflatten(flat)
    assert isinstance(tree["bot"]["w"], list) and len(tree["top"]["b"]) == 3
    got = rec.serve_step(rec.params_from_numpy(tree, "cpu"), _t(b), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # the port writes, the JAX package reads it into its own tree
    jflat, _ = jax_export.loads(export.dumps(tp))
    back = jax_export.restore_into(jp, jflat)
    for (path, a), (_, c) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c), err_msg=str(path))


def test_unknown_lookup_raises():
    _, cfg, _, tp = _dlrm()
    with pytest.raises(ValueError, match="lookup"):
        rec.serve_step(tp, _t(data.batch_for(cfg, 2)), cfg, lookup="take")
