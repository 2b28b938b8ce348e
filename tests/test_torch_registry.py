"""The port's model registry against the JAX package's
(``tests/test_rollout.py``'s registry cases, mirrored): content-addressed,
idempotent ids; resolve by "latest", id prefix, unknown; the load round
trip and hash verification; ``nest_flat``; ``content_hash``; and
``PlanContext`` binding a version and ``bind_version``. Both packages give
the same weights the same id, and each loads the other's versions. The JAX
side is imported by a fixture."""
import json
import os
import types

import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.core import bm25
from repro_torch.core.plan import PlanContext, PlanError
from repro_torch.core.registry import (ModelRegistry, RegistryError, content_hash,
                                       nest_flat)
from repro_torch.data import qa
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.models import sm_cnn


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import registry
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("sm-cnn"))
    corpus = qa.generate_corpus(n_docs=24, n_questions=10, seed=9)
    tok = HashingTokenizer(cfg.vocab_size)
    index = bm25.build_index([tok.encode(" ".join(d)) for d in corpus.documents],
                             cfg.vocab_size)
    params_a = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    # A structurally identical second version with different scores.
    params_b = {k: ({kk: vv * 1.5 for kk, vv in v.items()} if isinstance(v, dict)
                    else v * 1.5) for k, v in params_a.items()}
    return cfg, params_a, params_b, corpus, tok, index


@pytest.fixture()
def registry(world, tmp_path):
    cfg, params_a, params_b, *_ = world
    reg = ModelRegistry(str(tmp_path / "registry"))
    va = reg.publish(params_a, model=cfg.name).version_id
    vb = reg.publish(params_b, model=cfg.name).version_id
    return reg, va, vb


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


def _ctx(world, reg, version):
    cfg, params_a, _, corpus, tok, index = world
    return PlanContext.from_world(cfg, params_a, corpus, tok, index,
                                  buckets=(1, 8), registry=reg,
                                  model_version=version, device="cpu")


def test_registry_publish_is_idempotent_and_content_addressed(world, tmp_path):
    cfg, params_a, params_b, *_ = world
    reg = ModelRegistry(str(tmp_path / "reg"))
    v1 = reg.publish(params_a)
    v2 = reg.publish(sm_cnn.params_from_numpy(params_a, "cpu"))  # tensors, same weights
    assert v1.version_id == v2.version_id
    assert reg.list_versions() == [v1.version_id]
    v3 = reg.publish(params_b)          # different weights -> new version
    assert v3.version_id != v1.version_id
    assert len(reg.list_versions()) == 2
    assert sorted(os.listdir(v1.path)) == ["manifest.json", "params.rpro"]


def test_registry_resolve_latest_prefix_unknown(registry):
    reg, va, vb = registry
    assert reg.resolve("latest") == vb           # published second
    assert reg.resolve(va) == va
    assert reg.resolve(va[:8]) == va             # unique prefix
    with pytest.raises(RegistryError, match="unknown"):
        reg.resolve("v-000000000000")
    with pytest.raises(RegistryError, match="ambiguous"):
        reg.resolve("v-")                        # matches both
    with pytest.raises(RegistryError, match="empty"):
        ModelRegistry(os.path.join(reg.directory, "none")).resolve("latest")


def test_registry_load_params_roundtrip_and_hash_verification(world, registry):
    cfg, params_a, *_ = world
    reg, va, vb = registry
    for template in (params_a, None, sm_cnn.params_from_numpy(params_a, "cpu")):
        loaded = reg.load_params(va, template=template)
        for want, got in zip(_leaves(params_a), _leaves(loaded)):
            np.testing.assert_array_equal(want, got)
    # Tamper with the recorded hash: load must refuse the blob.
    mpath = os.path.join(reg.get(vb).path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["content_hash"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RegistryError, match="hash"):
        reg.load(vb)


def test_nest_flat_rebuilds_nested_tree():
    flat = {"conv/w": np.ones((2, 2)), "conv/b": np.zeros(2), "out": np.ones(3)}
    nested = nest_flat(flat)
    assert set(nested) == {"conv", "out"}
    assert set(nested["conv"]) == {"w", "b"}
    with pytest.raises(RegistryError):
        nest_flat({"a": np.ones(1), "a/b": np.ones(1)})
    with pytest.raises(RegistryError):
        nest_flat({"a/b": np.ones(1), "a": np.ones(1)})


def test_content_hash_sensitive_to_values_and_names():
    base = {"w": np.arange(4, dtype=np.float32)}
    assert content_hash(base) == content_hash({"w": np.arange(4, dtype=np.float32)})
    assert content_hash(base) != content_hash({"w2": np.arange(4, dtype=np.float32)})
    assert content_hash(base) != content_hash({"w": np.arange(1, 5, dtype=np.float32)})
    assert content_hash(base) != content_hash({"w": np.arange(4, dtype=np.float64)})


def test_plan_context_version_binding(world, registry):
    cfg, params_a, params_b, corpus, tok, index = world
    reg, va, vb = registry
    ctx = _ctx(world, reg, vb[:8])      # prefix resolves at construction
    assert ctx.model_version == vb
    for want, got in zip(_leaves(params_b), _leaves(ctx.params)):
        np.testing.assert_array_equal(want, got)
    scorer = ctx.scorer_for("numpy")
    back = ctx.bind_version(va)
    assert back.model_version == va and ctx.model_version == vb
    assert back.scorers() == [] and ctx.scorers() == [scorer]   # a fresh scorer memo
    assert back.cache is ctx.cache
    rng = np.random.default_rng(0)
    q = rng.integers(0, cfg.vocab_size, (4, cfg.max_len)).astype(np.int32)
    f = rng.random((4, 4), np.float32)
    assert not np.allclose(back.scorer_for("numpy")(q, q, f), scorer(q, q, f))
    plain = PlanContext.from_world(cfg, params_a, corpus, tok, index, device="cpu")
    with pytest.raises(PlanError, match="registry"):
        plain.bind_version(va)
    with pytest.raises(PlanError, match="no registry"):
        PlanContext.from_world(cfg, params_a, corpus, tok, index, device="cpu",
                               model_version=va)


def test_both_packages_publish_the_same_weights_to_the_same_id(jx, world, tmp_path):
    cfg, params_a, params_b, *_ = world
    mine = ModelRegistry(str(tmp_path / "torch"))
    theirs = jx.registry.ModelRegistry(str(tmp_path / "jax"))
    for params in (params_a, params_b):
        v = mine.publish(params, model=cfg.name)
        jv = theirs.publish(jx.jax.tree.map(jx.jnp.asarray, params), model=cfg.name)
        assert v.version_id == jv.version_id
        assert v.manifest["content_hash"] == jv.manifest["content_hash"]
        assert v.manifest["nbytes"] == jv.manifest["nbytes"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_others_versions(jx, world, tmp_path, writer):
    cfg, params_a, params_b, *_ = world
    directory = str(tmp_path / "shared")
    if writer == "jax":
        w = jx.registry.ModelRegistry(directory)
        ids = [w.publish(jx.jax.tree.map(jx.jnp.asarray, p), model=cfg.name).version_id
               for p in (params_a, params_b)]
    else:
        w = ModelRegistry(directory)
        ids = [w.publish(p, model=cfg.name).version_id for p in (params_a, params_b)]
    for reader in (ModelRegistry(directory), jx.registry.ModelRegistry(directory)):
        assert reader.list_versions() == ids and reader.resolve("latest") == ids[1]
        for vid, params in zip(ids, (params_a, params_b)):
            for want, got in zip(_leaves(params), _leaves(reader.load_params(vid))):
                np.testing.assert_array_equal(want, got)


def test_publish_checkpoint_waits_for_training(tmp_path):
    """``publish_checkpoint`` waited for the port's training package; with
    ``training.checkpoint`` here it promotes a checkpoint's params under the
    id ``publish`` gives the same weights, and refuses an empty directory."""
    from repro_torch.training.checkpoint import CheckpointManager
    reg = ModelRegistry(str(tmp_path / "reg"))
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(RegistryError, match="no checkpoints"):
        reg.publish_checkpoint(manager)
    params = sm_cnn.init_sm_cnn_numpy(reduced(get_config("sm-cnn")), seed=3)
    manager.save(7, sm_cnn.params_from_numpy(params, device="cpu"))
    mv = reg.publish_checkpoint(manager)
    assert mv.manifest["source_step"] == 7
    assert mv.version_id == ModelRegistry(str(tmp_path / "other")).publish(
        params).version_id
