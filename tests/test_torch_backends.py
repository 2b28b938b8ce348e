"""The paper's integration strategies in the port, held against the JAX
package on ``reduced(sm-cnn)``: the ``numpy``, ``artifact``, ``eager`` and
``pallas`` backends each agree with the JAX backend of the same name and
with ``repro.models.sm_cnn.score`` (rtol 1e-4, atol 1e-5), pad to their
bucket (1e-5 / 1e-6), and the two file formats behave: a ``RPROAVRO1``
blob written by either package gives both ``NumpySMCNN``s the same scores,
and the compiled artifact runs without the model's code and refuses what is
not its own. ``jit`` and ``aot`` compile with inductor, which takes seconds
a program here, so they have a file of their own
(``tests/test_torch_compiled_backends.py``). The JAX side is imported by a
fixture."""
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import backends as BK
from repro_torch.core import compiled_artifact as CA
from repro_torch.core import export as E
from repro_torch.core import numpy_eval as NE
from repro_torch.models import sm_cnn

BACKENDS = ["numpy", "artifact", "eager", "pallas"]
N = 8


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.core import backends, compiled_artifact, export, numpy_eval
    from repro.models import sm_cnn as jsm
    return types.SimpleNamespace(jax=jax, jnp=jnp, cfg=jreduced(jget("sm-cnn")),
                                 backends=backends, export=export,
                                 compiled_artifact=compiled_artifact,
                                 numpy_eval=numpy_eval, sm_cnn=jsm)


@pytest.fixture(scope="module")
def setup(jx):
    cfg = reduced(get_config("sm-cnn"))
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=3)
    tree["embed"] = tree["embed"] * 50.0   # spread the scores apart
    rng = np.random.default_rng(0)
    q = rng.integers(0, cfg.vocab_size, (N, cfg.max_len)).astype(np.int32)
    a = rng.integers(0, cfg.vocab_size, (N, cfg.max_len)).astype(np.int32)
    f = rng.random((N, 4), np.float32)
    jparams = jx.jax.tree.map(jx.jnp.asarray, tree)
    ref = np.asarray(jx.sm_cnn.score(jparams, q, a, f, jx.cfg))
    return cfg, tree, jparams, q, a, f, ref


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_agrees_with_jax(jx, setup, backend):
    cfg, tree, jparams, q, a, f, ref = setup
    got = BK.make_scorer(backend, tree, cfg, buckets=(8, 64), device="cpu")(q, a, f)
    want = jx.backends.make_scorer(backend, jparams, jx.cfg, buckets=(8, 64))(q, a, f)
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert np.ptp(ref) > 1e-2   # the scores differ enough to mean something


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_pads_to_its_bucket(setup, backend):
    cfg, tree, _, q, a, f, ref = setup
    scorer = BK.make_scorer(backend, tree, cfg, buckets=(8, 64), device="cpu")
    got = scorer(q[:3], a[:3], f[:3])          # 3 -> padded to bucket 8
    assert got.shape == (3,) and scorer.calls == 1
    np.testing.assert_allclose(got, ref[:3], rtol=1e-5, atol=1e-6)


def test_numpy_eval_naive_matches_gemm(setup):
    cfg, tree, _, q, a, f, _ = setup
    ev = NE.NumpySMCNN.from_bytes(E.dumps(tree, meta={"filter_width": cfg.filter_width}))
    fast = ev.get_score(q[:2], a[:2], f[:2])
    naive = ev.get_score(q[:2], a[:2], f[:2], naive=True)
    np.testing.assert_allclose(fast, naive, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_blob_from_either_package_scores_alike_in_both_evaluators(jx, setup, writer):
    """numpy_eval is numpy on both sides: the same blob gives bit-equal
    scores, and so does the other package's blob of the same weights."""
    cfg, tree, jparams, q, a, f, _ = setup
    meta = {"filter_width": cfg.filter_width}
    blob = (jx.export.dumps(jparams, model=cfg.name, meta=meta) if writer == "jax"
            else E.dumps(sm_cnn.params_from_numpy(tree, "cpu"), model=cfg.name, meta=meta))
    got = NE.NumpySMCNN.from_bytes(blob).get_score(q, a, f)
    want = jx.numpy_eval.NumpySMCNN.from_bytes(blob).get_score(q, a, f)
    np.testing.assert_array_equal(got, want)
    for naive in (False, True):
        np.testing.assert_array_equal(
            NE.NumpySMCNN.from_bytes(blob).log_probs(q[:2], a[:2], f[:2], naive),
            jx.numpy_eval.NumpySMCNN.from_bytes(blob).log_probs(q[:2], a[:2], f[:2], naive))


def _artifact(cfg, tree, buckets=(8,)):
    p = sm_cnn.params_from_numpy(tree, "cpu")
    shapes = {f"b{b}": (torch.zeros((b, cfg.max_len), dtype=torch.int32),
                        torch.zeros((b, cfg.max_len), dtype=torch.int32),
                        torch.zeros((b, 4), dtype=torch.float32)) for b in buckets}
    return CA.build_artifact(lambda q, a, f: sm_cnn.score(p, q, a, f, cfg), shapes,
                             meta={"model": cfg.name})


def test_compiled_artifact_is_standalone(setup, monkeypatch, tmp_path):
    """The artifact runs from its bytes alone (the 'single binary'): the
    model's code raises once the blob is built."""
    cfg, tree, _, q, a, f, ref = setup
    blob = _artifact(cfg, tree)
    scorer = BK.make_scorer("artifact", tree, cfg, buckets=(8,), device="cpu")

    def gone(*_a, **_k):
        raise AssertionError("the artifact called the model's code")
    monkeypatch.setattr(sm_cnn, "forward", gone)
    monkeypatch.setattr(sm_cnn, "score", gone)
    path = tmp_path / "sm_cnn.rpropt2"
    path.write_bytes(blob)
    art = CA.CompiledArtifact.from_file(str(path), device="cpu")
    assert art.shape_keys == ["b8"] and art.meta == {"model": cfg.name}
    assert art.device == "cpu"
    with torch.inference_mode():
        out = art.call("b8", torch.from_numpy(q), torch.from_numpy(a),
                       torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scorer(q, a, f), ref, rtol=1e-5, atol=1e-6)


def _with_device(blob: bytes, device: str) -> bytes:
    """``blob`` with its header's device rewritten."""
    m = len(CA.MAGIC)
    hlen = int.from_bytes(blob[m:m + 8], "little")
    header = json.loads(blob[m + 8:m + 8 + hlen])
    header["device"] = device
    new = json.dumps(header).encode()
    return CA.MAGIC + len(new).to_bytes(8, "little") + new + blob[m + 8 + hlen:]


@pytest.mark.parametrize("case", ["bad-magic", "jax-stablehlo", "other-device"])
def test_compiled_artifact_refuses_what_is_not_its_own(jx, setup, case):
    cfg, tree, jparams, *_ = setup
    if case == "bad-magic":
        blob, match = b"NOTAFILE" + b"\x00" * 64, "magic"
    elif case == "jax-stablehlo":
        jnp = jx.jnp
        spec = (jx.jax.ShapeDtypeStruct((8, cfg.max_len), jnp.int32),
                jx.jax.ShapeDtypeStruct((8, cfg.max_len), jnp.int32),
                jx.jax.ShapeDtypeStruct((8, 4), jnp.float32))
        blob = jx.compiled_artifact.build_artifact(
            lambda q, a, f: jx.sm_cnn.score(jparams, q, a, f, jx.cfg), {"b8": spec})
        assert blob.startswith(CA.JAX_MAGIC)
        match = "RPROHLO1"
    else:
        blob = _with_device(_artifact(cfg, tree), "cuda")
        CA.CompiledArtifact.from_bytes(_with_device(blob, "cpu"), device="cpu")
        match = "built for device 'cuda'"
    with pytest.raises(ValueError, match=match):
        CA.CompiledArtifact.from_bytes(blob, device="cpu")


def test_export_restore_into_keeps_the_template(setup):
    """The registry's template restore: structure, dtype and (for tensors)
    device from the template, values from the blob; a missing or misshapen
    tensor raises."""
    cfg, tree, *_ = setup
    flat, _ = E.loads(E.dumps(tree))
    for template in (tree, sm_cnn.params_from_numpy(tree, "cpu")):
        got = E.restore_into(template, flat)
        assert set(got) == set(tree) and set(got["conv_q"]) == {"w", "b"}
        assert type(got["embed"]) is type(template["embed"])
        np.testing.assert_array_equal(np.asarray(got["conv_q"]["w"]), tree["conv_q"]["w"])
    with pytest.raises(KeyError, match="embed"):
        E.restore_into(tree, {k: v for k, v in flat.items() if k != "embed"})
    with pytest.raises(ValueError, match="shape"):
        E.restore_into(tree, dict(flat, embed=flat["embed"][:1]))


def test_artifact_blob_is_one_entry_a_bucket(setup):
    cfg, tree, *_ = setup
    blob = _artifact(cfg, tree, buckets=(1, 8))
    m = len(CA.MAGIC)
    hlen = int.from_bytes(blob[m:m + 8], "little")
    header = json.loads(blob[m + 8:m + 8 + hlen])
    assert header["device"] == "cpu" and sorted(header["entries"]) == ["b1", "b8"]
    assert len(blob) == m + 8 + hlen + sum(header["entries"].values())
    assert CA.CompiledArtifact.from_bytes(blob, "cpu").shape_keys == ["b1", "b8"]
