"""The port's SM-CNN against ``repro.models.sm_cnn`` on the same weights,
and the RPROAVRO1 weight format in both directions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import export as jax_export
from repro.models import sm_cnn as jax_sm_cnn
from repro_torch.configs import get_config, reduced
from repro_torch.core import export
from repro_torch.models import sm_cnn


def _cfgs(full):
    if full:
        return jax_get_config("sm-cnn"), get_config("sm-cnn")
    return jax_reduced(jax_get_config("sm-cnn")), reduced(get_config("sm-cnn"))


def _batch(cfg, b=5, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    a = rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    q[:, 3:] = 0          # short queries: PAD id 0 gathers embed[0]
    a[0, :] = 0
    feats = rng.random((b, 4)).astype(np.float32)
    return q, a, feats


@pytest.mark.parametrize("full", [False, True])
def test_forward_and_score_match_jax(full):
    jcfg, cfg = _cfgs(full)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = sm_cnn.params_from_numpy(tree, "cpu")
    q, a, feats = _batch(cfg)
    tq, ta, tf = (torch.from_numpy(x) for x in (q, a, feats))
    np.testing.assert_allclose(
        sm_cnn.forward(params, tq, ta, tf, cfg).numpy(),
        np.asarray(jax_sm_cnn.forward(jparams, q, a, feats, jcfg)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        sm_cnn.score(params, tq, ta, tf, cfg).numpy(),
        np.asarray(jax_sm_cnn.score(jparams, q, a, feats, jcfg)),
        rtol=1e-4, atol=1e-5)


def test_im2col_and_conv_arm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    conv = {"w": (rng.standard_normal((3 * 4, 6)) * 0.3).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32)}
    np.testing.assert_array_equal(sm_cnn.im2col(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jax_sm_cnn.im2col(jnp.asarray(x), 3)))
    got = sm_cnn.conv_arm(sm_cnn.params_from_numpy(conv, "cpu"),
                          torch.from_numpy(x), 3)
    want = jax_sm_cnn.conv_arm(jax.tree.map(jnp.asarray, conv), jnp.asarray(x), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_init_uses_the_generator_and_jax_layouts():
    _, cfg = _cfgs(False)
    p1 = sm_cnn.init_sm_cnn(cfg, torch.Generator().manual_seed(7), device="cpu")
    p2 = sm_cnn.init_sm_cnn(cfg, torch.Generator().manual_seed(7), device="cpu")
    jshapes = jax.tree.map(lambda x: tuple(x.shape),
                           jax_sm_cnn.init_sm_cnn(jax.random.PRNGKey(0),
                                                  jax_reduced(jax_get_config("sm-cnn"))))
    assert jax.tree.map(lambda t: tuple(t.shape), p1) == jshapes
    for name, arr in export.flatten_named(p1).items():
        np.testing.assert_array_equal(arr, export.flatten_named(p2)[name])
    assert p1["conv_q"]["w"].shape == (cfg.filter_width * cfg.embed_dim,
                                       cfg.conv_filters)


def test_jax_export_loads_in_the_port():
    jcfg, cfg = _cfgs(False)
    jparams = jax_sm_cnn.init_sm_cnn(jax.random.PRNGKey(5), jcfg)
    blob = jax_export.dumps(jparams, model=jcfg.name)
    flat, header = export.loads(blob)
    assert header["model"] == cfg.name
    params = sm_cnn.params_from_numpy(export.unflatten(flat), "cpu")
    q, a, feats = _batch(cfg, seed=6)
    np.testing.assert_allclose(
        sm_cnn.score(params, *(torch.from_numpy(x) for x in (q, a, feats)), cfg).numpy(),
        np.asarray(jax_sm_cnn.score(jparams, q, a, feats, jcfg)),
        rtol=1e-4, atol=1e-5)


def test_port_export_loads_in_jax():
    _, cfg = _cfgs(False)
    params = sm_cnn.init_sm_cnn(cfg, torch.Generator().manual_seed(1), device="cpu")
    blob = export.dumps(params, model=cfg.name, meta={"filter_width": cfg.filter_width})
    flat, header = jax_export.loads(blob)
    assert header["meta"] == {"filter_width": cfg.filter_width}
    mine = export.flatten_named(params)
    assert sorted(flat) == sorted(mine) == [
        "conv_a/b", "conv_a/w", "conv_q/b", "conv_q/w", "embed",
        "join/b", "join/w", "out/b", "out/w"]
    for name, arr in flat.items():
        np.testing.assert_array_equal(arr, mine[name])
    # and the JAX side rebuilds its own tree from it
    template = jax_sm_cnn.init_sm_cnn(jax.random.PRNGKey(0),
                                      jax_reduced(jax_get_config("sm-cnn")))
    restored = jax_export.restore_into(template, flat)
    np.testing.assert_array_equal(np.asarray(restored["conv_q"]["w"]),
                                  params["conv_q"]["w"].numpy())


def test_export_widens_bfloat16_like_jax():
    params = {"w": torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16)}
    flat, _ = jax_export.loads(export.dumps(params))
    assert flat["w"].dtype == np.float32
    np.testing.assert_array_equal(flat["w"], [[1.5, -2.25]])
