"""The slice as a whole: one ``ops`` expression, one corpus and one set of
weights, lowered to ``local`` and ``batched`` in both packages for the
``eager`` and ``pallas`` backends, gives the same ``(doc_id, sent_id)``
rankings (order swaps only between scores within ``tie_atol``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import backends as jax_backends, bm25 as jax_bm25, ops as jax_ops
from repro.core import plan as jax_plan
from repro.data import qa as jax_qa
from repro.data.tokenizer import HashingTokenizer as JaxTokenizer
from repro_torch.configs import get_config, reduced
from repro_torch.core import backends, bm25, ops
from repro_torch.core import plan as P
from repro_torch.data import qa
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.kernels import sm_cnn_conv
from repro_torch.models import sm_cnn
from repro_torch.serving import telemetry

TIE_ATOL = 1e-5
N_QUERIES = 8


def _weights(cfg):
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=9)
    tree["embed"] = tree["embed"] * 50.0   # spread the scores apart
    return tree


@pytest.fixture(scope="module")
def worlds():
    cfg = reduced(get_config("sm-cnn"))
    jcfg = jax_reduced(jax_get_config("sm-cnn"))
    corpus = qa.generate_corpus(n_docs=40, n_questions=N_QUERIES, seed=2)
    jcorpus = jax_qa.generate_corpus(n_docs=40, n_questions=N_QUERIES, seed=2)
    tok, jtok = HashingTokenizer(cfg.vocab_size), JaxTokenizer(jcfg.vocab_size)
    docs = [tok.encode(" ".join(d)) for d in corpus.documents]
    tree = _weights(cfg)
    ctx = P.PlanContext.from_world(cfg, tree, corpus, tok,
                                   bm25.build_index(docs, cfg.vocab_size),
                                   device="cpu")
    jctx = jax_plan.PlanContext.from_world(
        jcfg, jax.tree.map(jnp.asarray, tree), jcorpus, jtok,
        jax_bm25.build_index(docs, jcfg.vocab_size))
    return ctx, jctx, corpus.questions


def _ids(cands):
    return [(c.doc_id, c.sent_id) for c in cands]


def _assert_same_rankings(want, got):
    assert len(want) == len(got)
    for (wc, _), (gc, _) in zip(want, got):
        if _ids(wc) == _ids(gc):
            continue
        assert sorted(_ids(wc)) == sorted(_ids(gc))
        for w, g in zip(wc, gc):
            if (w.doc_id, w.sent_id) != (g.doc_id, g.sent_id):
                assert abs(w.score - g.score) <= TIE_ATOL


def _pipelines(kind, O):
    if kind == "fuse":   # fusion after a score-gap cutoff, both backends
        return (O.Retrieve(h=5) >> O.DynamicCutoff(margin=2.0, min_keep=2)
                >> (O.Rerank("eager") | O.Rerank("pallas")) % 4)
    return O.Retrieve(h=5) >> O.Rerank(kind) % 4


@pytest.mark.parametrize("kind", ["eager", "pallas", "fuse"])
def test_both_packages_rank_alike(worlds, kind):
    ctx, jctx, queries = worlds
    pipe, jpipe = _pipelines(kind, ops), _pipelines(kind, jax_ops)
    assert repr(pipe) == repr(jpipe)
    plans = [P.plan(pipe, t, ctx) for t in ("local", "batched")]
    jplans = [jax_plan.plan(jpipe, t, jctx) for t in ("local", "batched")]
    P.verify_plans(plans, queries, tie_atol=TIE_ATOL)
    want = jplans[0].run_many(queries)
    assert any(c for c, _ in want)
    for p in plans:
        got = p.run_many(queries)
        _assert_same_rankings(want, got)
        for (wc, _), (gc, _) in zip(want, got):
            np.testing.assert_allclose([c.score for c in gc][:1],
                                       [c.score for c in wc][:1],
                                       rtol=1e-4, atol=1e-5)


def test_stage_one_candidates_identical(worlds):
    ctx, jctx, queries = worlds
    pipe = ops.Retrieve(h=5)
    for target in ("local", "batched"):
        got = P.plan(pipe, target, ctx).run_many(queries)
        want = jax_plan.plan(jax_ops.Retrieve(h=5), target, jctx).run_many(queries)
        for (gc, _), (wc, _) in zip(got, want):
            assert [(c.doc_id, c.sent_id, c.text) for c in gc] == \
                   [(c.doc_id, c.sent_id, c.text) for c in wc]
            np.testing.assert_allclose([c.score for c in gc],
                                       [c.score for c in wc], rtol=1e-6)


def test_pallas_and_eager_rank_alike_and_cpu_launches_nothing(worlds):
    ctx, _, queries = worlds
    before = sm_cnn_conv.launches
    plans = [P.plan(ops.Retrieve(h=5) >> ops.Rerank(b) % 4, "batched", ctx)
             for b in ("pallas", "eager")]
    P.verify_plans(plans, queries, tie_atol=TIE_ATOL)
    assert sm_cnn_conv.launches == before
    assert any(s.name == "pallas" and s.calls > 0 for s in ctx.scorers())


def test_scorer_buckets_chunks_and_metrics_match_jax(worlds):
    ctx, jctx, _ = worlds
    rng = np.random.default_rng(0)
    n = 21                                   # past the top bucket: 3 chunks
    q = rng.integers(0, ctx.cfg.vocab_size, (n, ctx.cfg.max_len)).astype(np.int32)
    a = rng.integers(0, ctx.cfg.vocab_size, (n, ctx.cfg.max_len)).astype(np.int32)
    f = rng.random((n, 4)).astype(np.float32)
    scorer = backends.make_scorer("eager", ctx.params, ctx.cfg, buckets=(1, 8),
                                  device="cpu")
    jscorer = jax_backends.make_scorer("eager", jctx.params, jctx.cfg, buckets=(1, 8))
    telemetry.reset_all()
    tracer = telemetry.get_tracer()
    with tracer.span("request"):
        got = scorer(q, a, f)
    np.testing.assert_allclose(got, jscorer(q, a, f), rtol=1e-4, atol=1e-5)
    assert got.shape == (n,) and scorer.calls == 3
    snap = telemetry.get_registry().snapshot()
    assert snap["scorer_batch_ms_count{backend=eager,bucket=8}"] == 3.0
    assert [s.name for s in tracer.finished()].count("scorer") == 3


def test_unported_targets_and_backends_raise(worlds):
    """The remote targets wait for the serving slice; every backend of the
    JAX package is ported, and an unknown one raises."""
    ctx, _, _ = worlds
    pipe = ops.Retrieve(h=5) >> ops.Rerank("eager") % 4
    for target in ("remote", "remote_pipeline"):
        with pytest.raises(P.PlanError, match="not ported"):
            P.plan(pipe, target, ctx)
    assert backends.BACKENDS == jax_backends.BACKENDS
    with pytest.raises(ValueError, match="unknown backend"):
        backends.make_scorer("onnx", ctx.params, ctx.cfg, device="cpu")


def test_expired_deadline_sheds(worlds):
    from repro_torch.core.wire import ShedError
    ctx, _, queries = worlds
    p = P.plan(ops.Retrieve(h=5) >> ops.Rerank("eager") % 4, "local", ctx)
    telemetry.reset_all()
    with pytest.raises(ShedError):
        p.run_many(queries, deadline_abs=0.0)
    assert telemetry.get_registry().snapshot()[
        "plan_sheds_expired{target=local}"] == 1.0


def test_entry_points_raise_without_a_card_unless_asked_for_cpu(worlds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    ctx, _, _ = worlds
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.PlanContext(tokenizer=ctx.tokenizer, idf=ctx.idf, max_len=ctx.max_len)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        backends.make_scorer("pallas", ctx.params, ctx.cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sm_cnn.params_from_numpy(ctx.params)
