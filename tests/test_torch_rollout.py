"""The port's ``serving/rollout.py`` and the pool and engine hot-swaps
against the JAX package's (``tests/test_rollout.py``'s cases that assert no
latency, mirrored; its registry cases are in ``test_torch_registry.py`` and
its MSG_VERSION/MSG_SWAP cases in ``test_torch_service.py``), at
``reduced(sm-cnn)`` with weights from a numpy seed:

* ``query_bucket``, ``sample_query`` and ``ABEngine.arm_of`` route every
  query as the JAX package's do (a fleet may mix both packages);
* a port engine and a JAX engine bound to one registry version rank alike;
* a 2-replica pool hot-swaps under load with no failed request, also over
  repeated swaps, and scores as the new version's scorer after it;
* ``RolloutController`` rolls a NaN-poisoned candidate back and lands a
  healthy one, on an engine and through MSG_SWAP on a live server;
* ``ShadowEngine`` and ``ABEngine``: the primary path untouched, per-version
  metrics, candidate failures never surfacing.

The JAX side is imported by a fixture; every socket read and join has a
bound."""
import math
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import backends as BK
from repro_torch.core import bm25 as BM
from repro_torch.core import ops
from repro_torch.core import service as SV
from repro_torch.core.plan import PlanContext
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.treepath import tree_map
from repro_torch.data import qa as QA
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.models import sm_cnn
from repro_torch.serving import telemetry
from repro_torch.serving.cluster import ReplicaPool
from repro_torch.serving.engine import PipelineEngine
from repro_torch.serving.rollout import (ABEngine, RolloutController, RolloutError,
                                         ShadowEngine, query_bucket, sample_query)

torch.set_num_threads(2)

BUCKETS = (1, 8)
WAIT_S = 30.0


@pytest.fixture(autouse=True, scope="module")
def _bounded_sockets():
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(WAIT_S)
    yield
    socket.setdefaulttimeout(old)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.core import bm25, ops as jops
    from repro.core.plan import PlanContext as JaxPlanContext
    from repro.core.registry import ModelRegistry as JaxRegistry
    from repro.data import qa
    from repro.data.tokenizer import HashingTokenizer as JTok
    from repro.serving import rollout
    from repro.serving.engine import PipelineEngine as JaxEngine
    return types.SimpleNamespace(jax=jax, cfg=jreduced(jget("sm-cnn")), bm25=bm25,
                                 ops=jops, PlanContext=JaxPlanContext,
                                 Registry=JaxRegistry, qa=qa, Tok=JTok,
                                 rollout=rollout, Engine=JaxEngine)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("sm-cnn"))
    corpus = QA.generate_corpus(n_docs=24, n_questions=10, seed=9)
    tok = HashingTokenizer(cfg.vocab_size)
    docs = [tok.encode(" ".join(d)) for d in corpus.documents]
    params_a = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    params_a["embed"] = params_a["embed"] * 50.0   # spread the scores apart
    # a cheap, structurally identical second version with different scores
    params_b = tree_map(lambda x: x * 1.5, params_a)
    return types.SimpleNamespace(cfg=cfg, corpus=corpus, tok=tok, docs=docs,
                                 index=BM.build_index(docs, cfg.vocab_size),
                                 params_a=params_a, params_b=params_b)


@pytest.fixture()
def registry(world, tmp_path):
    reg = ModelRegistry(str(tmp_path / "registry"))
    va = reg.publish(world.params_a, model=world.cfg.name).version_id
    vb = reg.publish(world.params_b, model=world.cfg.name).version_id
    return reg, va, vb


def _pairs(corpus, n=4):
    return [(corpus.questions[i % len(corpus.questions)],
             corpus.documents[i % len(corpus.documents)][0]) for i in range(n)]


def _ctx(world, reg, version):
    return PlanContext.from_world(world.cfg, world.params_a, world.corpus, world.tok,
                                  world.index, buckets=BUCKETS, registry=reg,
                                  model_version=version, device="cpu")


def _engine(world, reg, version, backend="numpy"):
    return PipelineEngine(ops.Retrieve(h=8) >> ops.Rerank(backend, k=3),
                          _ctx(world, reg, version), target="batched")


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()


# ------------------------------------------------- against the JAX package --

def test_query_routing_matches_jax(jx):
    """Bucket, sample and A/B arm of 400 queries, as the JAX package's."""
    qs = [f"query variant {i}" for i in range(400)] + ["", "über straße ✓"]
    assert [query_bucket(q) for q in qs] == [jx.rollout.query_bucket(q) for q in qs]
    for frac in (0.0, 0.1, 0.25, 1.0):
        assert [sample_query(q, frac) for q in qs] == \
               [jx.rollout.sample_query(q, frac) for q in qs]
    for pct in (0.0, 25.0, 50.0, 100.0):
        ab, jab = ABEngine(None, None, pct), jx.rollout.ABEngine(None, None, pct)
        assert [ab.arm_of(q) for q in qs] == [jab.arm_of(q) for q in qs]


def test_engines_on_one_registry_version_rank_as_jax(jx, world, registry):
    """A port engine and a JAX engine bound to the same registry version (a
    directory either package reads) rank alike."""
    reg, va, vb = registry
    jcorpus = jx.qa.generate_corpus(n_docs=24, n_questions=10, seed=9)
    jreg = jx.Registry(reg.directory)
    queries = list(world.corpus.questions[:6])
    for vid in (va, vb):
        jctx = jx.PlanContext.from_world(
            jx.cfg, None, jcorpus, jx.Tok(jx.cfg.vocab_size),
            jx.bm25.build_index(world.docs, jx.cfg.vocab_size), buckets=BUCKETS,
            registry=jreg, model_version=vid)
        jengine = jx.Engine(jx.ops.Retrieve(h=8) >> jx.ops.Rerank("numpy", k=3),
                            jctx, target="batched")
        engine = _engine(world, reg, vid)
        assert engine.model_version == jengine.model_version == vid
        got, want = engine.rank_batch(queries), jengine.rank_batch(queries)
        assert [[(d, s) for d, s, _ in r] for r in got] == \
               [[(d, s) for d, s, _ in r] for r in want]
        np.testing.assert_allclose([[x for _, _, x in r] for r in got],
                                   [[x for _, _, x in r] for r in want],
                                   rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- pool swaps --

def _pump_pool(pool, pairs, n_threads, run):
    errors, ok = [], [0]
    lock = threading.Lock()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                assert pool.get_scores(pairs).shape == (len(pairs),)
                with lock:
                    ok[0] += 1
            except Exception as e:  # noqa: BLE001 — the assertion target
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=pump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    try:
        run()
    finally:
        stop.set()
        _join(threads)
    return errors, ok[0]


def test_pool_hot_swap_zero_loss_under_load(world, registry):
    """A 2-replica pool under concurrent load hot-swaps replica by replica
    with no failed request, and scores as the new version's scorer after."""
    reg, va, vb = registry
    pool = ReplicaPool.build("numpy", world.params_a, world.cfg, world.tok,
                             world.corpus.idf, n_replicas=2, buckets=BUCKETS,
                             device="cpu")
    pool.model_version = va
    pairs = _pairs(world.corpus, 4)
    out = {}

    def swap():
        time.sleep(0.1)                          # load before the swap
        out["vid"] = pool.swap_version(vb, reg)
        time.sleep(0.1)                          # load across the rejoin

    with pool:
        errors, ok = _pump_pool(pool, pairs, 4, swap)
        assert errors == [] and ok > 0
        assert out["vid"] == vb and pool.model_version == vb
        got = pool.get_scores(pairs)
    scorer_b = BK.make_scorer("numpy", world.params_b, world.cfg, buckets=BUCKETS)
    want = SV.QuestionAnsweringHandler(scorer_b, world.tok, world.corpus.idf,
                                       world.cfg.max_len).get_scores(pairs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pool_repeated_swaps_lose_nothing(world, registry):
    """a -> b -> a -> b under load: no request fails, the pool lands on the
    last version (the soak of ``test_rollout.py`` without its count of
    requests served)."""
    reg, va, vb = registry
    with ReplicaPool.build("numpy", world.params_a, world.cfg, world.tok,
                           world.corpus.idf, n_replicas=2, buckets=BUCKETS,
                           device="cpu") as pool:
        def swaps():
            for target in (vb, va, vb):
                time.sleep(0.05)
                assert pool.swap_version(target, reg) == target

        errors, ok = _pump_pool(pool, _pairs(world.corpus, 2), 3, swaps)
    assert errors == [] and ok > 0
    assert pool.model_version == vb


def test_pool_swap_requires_build_provenance(world, registry):
    reg, va, vb = registry
    scorers = [BK.make_scorer("numpy", world.params_a, world.cfg, buckets=BUCKETS)]
    with ReplicaPool(scorers, world.tok, world.corpus.idf, world.cfg.max_len) as pool:
        with pytest.raises(RuntimeError, match="build"):
            pool.swap_version(vb, reg)


def test_remote_target_engine_swaps_its_pool(world, registry):
    """An engine on the ``remote`` target over a version-bound pool swaps
    through the pool's replica-by-replica swap."""
    import dataclasses
    reg, va, vb = registry
    ctx = _ctx(world, reg, va)
    with ReplicaPool.build("numpy", ctx.params, world.cfg, world.tok,
                           world.corpus.idf, n_replicas=2, buckets=BUCKETS,
                           device="cpu") as pool:
        pool.model_version = va
        engine = PipelineEngine(ops.Retrieve(h=8) >> ops.Rerank("numpy", k=3),
                                dataclasses.replace(ctx, remote=pool),
                                target="remote")
        before = engine.rank_batch(world.corpus.questions[:3])
        assert engine.swap_version(vb) == vb == pool.model_version
        after = engine.rank_batch(world.corpus.questions[:3])
        want = _engine(world, reg, vb).rank_batch(world.corpus.questions[:3])
    assert [[s for _, _, s in r] for r in after] != [[s for _, _, s in r] for r in before]
    np.testing.assert_allclose([[s for _, _, s in r] for r in after],
                               [[s for _, _, s in r] for r in want], rtol=1e-6)


# ----------------------------------------------------------- engine swaps --

def test_engine_swap_labels_metrics_per_version(world, registry):
    reg, va, vb = registry
    telemetry.reset_all()
    engine = _engine(world, reg, va)
    engine.rank_batch(world.corpus.questions[:3])
    assert engine.model_version == va
    assert engine.swap_version(vb) == vb and engine.model_version == vb
    engine.rank_batch(world.corpus.questions[:3])
    assert engine.stats()["swaps"] == 1.0
    groups = telemetry.split_by_label(telemetry.get_registry().snapshot(),
                                      "model_version")
    for vid in (va, vb):
        assert any(k.startswith("engine_rank_queries") for k in groups[vid])


def test_engine_swap_without_registry_is_refused(world):
    ctx = PlanContext.from_world(world.cfg, world.params_a, world.corpus, world.tok,
                                 world.index, buckets=BUCKETS, device="cpu")
    engine = PipelineEngine(ops.Retrieve(h=8) >> ops.Rerank("numpy", k=3), ctx,
                            target="batched")
    with pytest.raises(RuntimeError, match="registry"):
        engine.swap_version("latest")


# ------------------------------------------------------ guardrail rollback --

def _poisoned(reg, params):
    bad = tree_map(lambda x: np.full(np.shape(x), np.nan, np.asarray(x).dtype), params)
    return reg.publish(bad, model="broken").version_id


def test_rollout_controller_rolls_back_broken_version(world, registry):
    """A NaN-poisoned candidate fails its canaries and is rolled back; the
    previous version still serves; a healthy candidate then lands."""
    reg, va, vb = registry
    vbad = _poisoned(reg, world.params_a)
    engine = _engine(world, reg, va)
    ctrl = RolloutController(engine, canary_queries=world.corpus.questions[:4],
                             canary_passes=1)
    report = ctrl.hot_swap(vbad)
    assert report.rolled_back and not report.swapped
    assert "error rate" in report.reason and report.candidate.errors > 0
    assert report.previous_version == va
    assert report.active_version == va == engine.model_version
    assert all(math.isfinite(float(s))
               for _, _, s in engine.rank_batch([world.corpus.questions[0]])[0])
    good = ctrl.hot_swap(vb)
    assert good.swapped and not good.rolled_back
    assert good.active_version == vb == engine.model_version


class _ServedTarget:
    """A live server as a rollout target: ``swap_version`` is MSG_SWAP,
    ``model_version`` MSG_VERSION, the canaries ``rank_batch`` RPCs."""

    def __init__(self, client):
        self.client = client

    @property
    def model_version(self):
        return self.client.version()[0]

    def swap_version(self, version):
        return self.client.swap(version)[0]

    def rank_batch(self, queries):
        return self.client.rank_batch(queries)


def test_rollout_controller_through_msg_swap_on_a_live_server(world, registry):
    reg, va, vb = registry
    vbad = _poisoned(reg, world.params_a)
    with SV.ThreadPoolServer(_engine(world, reg, va),
                             num_workers=2).start_background() as srv:
        with SV.Client(srv.address) as cl:
            ctrl = RolloutController(_ServedTarget(cl),
                                     canary_queries=world.corpus.questions[:3],
                                     canary_passes=1)
            bad = ctrl.hot_swap(vbad)
            assert bad.rolled_back and cl.version() == (va, "active")
            good = ctrl.hot_swap(vb)
            assert good.swapped and cl.version() == (vb, "active")
            got = cl.rank_batch(world.corpus.questions[:3])
    want = _engine(world, reg, vb).rank_batch(world.corpus.questions[:3])
    assert [[(d, s) for d, s, _ in r] for r in got] == \
           [[(d, s) for d, s, _ in r] for r in want]


def test_rollout_controller_requires_canaries(world, registry):
    reg, va, _ = registry
    with pytest.raises(RolloutError, match="canary"):
        RolloutController(_engine(world, reg, va), canary_queries=[])


# ----------------------------------------------------------------- A/B -----

def test_query_bucket_is_deterministic_and_fractional():
    qs = [f"query variant {i}" for i in range(400)]
    assert [query_bucket(q) for q in qs] == [query_bucket(q) for q in qs]
    hit = sum(sample_query(q, 0.25) for q in qs)
    assert 0.15 * len(qs) < hit < 0.35 * len(qs)
    assert not any(sample_query(q, 0.0) for q in qs)
    assert all(sample_query(q, 1.0) for q in qs)


def test_ab_engine_routes_deterministically_with_per_arm_metrics(world, registry):
    reg, va, vb = registry
    telemetry.reset_all()
    arm_a, arm_b = _engine(world, reg, va), _engine(world, reg, vb)
    ab = ABEngine(arm_a, arm_b, split_pct=50.0)
    queries = [f"which document mentions topic {i}" for i in range(16)]
    arms = [ab.arm_of(q) for q in queries]
    assert arms == [ab.arm_of(q) for q in queries] and {"a", "b"} == set(arms)
    out = ab.rank_batch(queries)
    assert len(out) == len(queries)
    for q, ranking in zip(queries, out):
        solo = (arm_b if ab.arm_of(q) == "b" else arm_a).rank_batch([q])[0]
        assert [(d, s) for d, s, _ in ranking] == [(d, s) for d, s, _ in solo]
    snap = telemetry.get_registry().snapshot()
    for vid in (va, vb):
        assert any(k.startswith("ab_queries") and vid in k for k in snap)
    groups = telemetry.split_by_label(snap, "model_version")
    assert va in groups and vb in groups
    assert ab.model_version == f"{va}|{vb}"


def test_ab_engine_rejects_bad_split():
    with pytest.raises(ValueError, match="split_pct"):
        ABEngine(object(), object(), split_pct=120.0)


# ------------------------------------------------------------------ shadow --

def test_shadow_engine_mirrors_and_records_divergence(world, registry):
    reg, va, vb = registry
    telemetry.reset_all()
    shadow = ShadowEngine(_engine(world, reg, va), _engine(world, reg, vb),
                          fraction=1.0, max_pending=4)
    queries = list(world.corpus.questions[:8])
    out = shadow.rank_batch(queries)
    want = _engine(world, reg, va).rank_batch(queries)
    assert [[d for d, _, _ in r] for r in out] == [[d for d, _, _ in r] for r in want]
    assert shadow.drain(WAIT_S)
    snap = telemetry.get_registry().snapshot()
    assert sum(v for k, v in snap.items() if k.startswith("shadow_queries")) > 0
    assert any(k.startswith("shadow_rank_ms") and vb in k for k in snap)
    assert any(k.startswith("shadow_score_divergence") and vb in k for k in snap)
    assert not any(k.startswith("shadow_errors") for k in snap)
    assert shadow.model_version == va            # the candidate stays invisible


def test_shadow_engine_never_surfaces_candidate_failures(world, registry):
    reg, va, _ = registry
    telemetry.reset_all()

    class Exploding:
        model_version = "v-broken"

        def rank_batch(self, queries, deadline_abs=None):
            raise RuntimeError("candidate kaboom")

    shadow = ShadowEngine(_engine(world, reg, va), Exploding(), fraction=1.0)
    out = shadow.rank_batch(list(world.corpus.questions[:4]))
    assert len(out) == 4 and all(out)
    assert shadow.drain(WAIT_S)
    snap = telemetry.get_registry().snapshot()
    assert sum(v for k, v in snap.items() if k.startswith("shadow_errors")) > 0
