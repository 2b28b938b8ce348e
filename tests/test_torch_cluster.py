"""The port's ``serving/cluster.py`` against the JAX package's
(``tests/test_cluster.py``'s pool cases, the pool cases of
``tests/test_threadpool.py``, ``tests/test_deadline_retry.py`` and
``tests/test_hedge.py``, and
``tests/test_ops_plan.py::test_remote_plan_through_replica_pool``,
mirrored), at ``reduced(sm-cnn)`` with weights from a numpy seed.

Each package's ``ReplicaPool`` over the same weights gives the same scores
(rtol 1e-4, atol 1e-5), and the port's pool gives what its own direct
scorer gives (bit-equal on one backend). Every socket read and join here
has a bound. The JAX side is imported by a fixture, so the ``cuda``-marked
test (two ``pallas`` replicas on the card behind a ``ThreadPoolServer``,
the conv kernel launched twice a scorer call) runs where JAX is not
installed."""
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
from repro_torch.core import wire
from repro_torch.core.plan import PlanContext, plan, verify_plans
from repro_torch.data import qa as QA
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.models import sm_cnn
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.cluster import POLICIES, ReplicaPool

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
BUCKETS = (1, 8, 64)
WAIT_S = 30.0


@pytest.fixture(autouse=True, scope="module")
def _bounded_sockets():
    """Client sockets without a timeout of their own time out here."""
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(WAIT_S)
    yield
    socket.setdefaulttimeout(old)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.data import qa
    from repro.data.tokenizer import HashingTokenizer as JTok
    from repro.serving import cluster
    return types.SimpleNamespace(jax=jax, jnp=jnp, cfg=jreduced(jget("sm-cnn")),
                                 qa=qa, Tok=JTok, cluster=cluster)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("sm-cnn"))
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    tree["embed"] = tree["embed"] * 50.0   # spread the scores apart
    corpus = QA.generate_corpus(n_docs=20, n_questions=5, seed=11)
    tok = HashingTokenizer(cfg.vocab_size)
    return types.SimpleNamespace(cfg=cfg, tree=tree, corpus=corpus, tok=tok)


def _pairs(corpus, n):
    return [(corpus.questions[i % len(corpus.questions)],
             corpus.documents[i % len(corpus.documents)][0]) for i in range(n)]


def _pool(w, backend, n=2, device="cpu", **kw):
    return ReplicaPool.build(backend, w.tree, w.cfg, w.tok, w.corpus.idf,
                             n_replicas=n, buckets=BUCKETS, device=device, **kw)


def _direct(w, backend, device="cpu"):
    scorer = BK.make_scorer(backend, w.tree, w.cfg, buckets=BUCKETS, device=device)
    return SV.QuestionAnsweringHandler(scorer, w.tok, w.corpus.idf, w.cfg.max_len)


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()


def _stub_scorer(q_tok, a_tok, feats):
    return np.full((q_tok.shape[0],), 0.5, np.float32)


# ------------------------------------------------- against the JAX package --

def test_policies_are_the_jax_packages(jx):
    assert POLICIES == jx.cluster.POLICIES


@pytest.mark.parametrize("backend", ["eager", "numpy", "pallas"])
def test_pool_scores_match_the_jax_pool(jx, world, backend):
    """One tree, one batch of pairs: the port's pool on ``backend`` and the
    JAX package's pool on its backend of the same name agree, and the two
    pools report the same stats keys."""
    w = world
    pairs = _pairs(w.corpus, 12)
    jcorpus = jx.qa.generate_corpus(n_docs=20, n_questions=5, seed=11)
    jpool = jx.cluster.ReplicaPool.build(
        backend, jx.jax.tree.map(jx.jnp.asarray, w.tree), jx.cfg,
        jx.Tok(jx.cfg.vocab_size), jcorpus.idf, n_replicas=2, buckets=BUCKETS)
    with _pool(w, backend) as pool:
        got = pool.get_scores(pairs)
        stats = pool.stats()
    with jpool:
        want = jpool.get_scores(pairs)
        jstats = jpool.stats()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sorted(stats) == sorted(jstats)


# ----------------------------------------- tests/test_cluster.py, mirrored --

@pytest.mark.parametrize("backend", ["eager", "numpy", "pallas"])
def test_pool_matches_direct_scorer(world, backend):
    pairs = _pairs(world.corpus, 12)
    with _pool(world, backend) as pool:
        got = pool.get_scores(pairs)
    want = _direct(world, backend).get_scores(pairs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pool_policies_route_and_complete(world):
    pairs = _pairs(world.corpus, 4)
    for policy in POLICIES:
        with _pool(world, "eager", n=3, policy=policy) as pool:
            for _ in range(9):
                assert pool.get_scores(pairs).shape == (4,)
            s = pool.stats()
            assert sum(s[f"replica{i}_requests"] for i in range(3)) == 9
            if policy == "round_robin":
                assert all(s[f"replica{i}_requests"] == 3 for i in range(3))
            assert pool.outstanding_rows() == 0


def test_pool_concurrent_clients_agree_with_direct(world):
    pairs = _pairs(world.corpus, 8)
    want = _direct(world, "eager").get_scores(pairs)
    results = {}
    with _pool(world, "eager", policy="p2c") as pool:
        def client(i):
            results[i] = pool.get_scores(pairs)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        _join(threads)
    assert len(results) == 8
    for got in results.values():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pool_rejects_bad_policy(world):
    with pytest.raises(ValueError, match="unknown policy"):
        ReplicaPool([_stub_scorer], world.tok, world.corpus.idf,
                    world.cfg.max_len, policy="random-guess")
    with pytest.raises(ValueError, match="at least one"):
        ReplicaPool([], world.tok, world.corpus.idf, world.cfg.max_len)


def test_pool_row_service_feeds_admission_estimate(world):
    with _pool(world, "numpy") as pool:
        assert pool.row_service_s() is None          # nothing scored yet
        pool.get_scores(_pairs(world.corpus, 4))
        per_row = pool.row_service_s()
        assert per_row is not None and per_row > 0
        ac = AdmissionController(init_row_service_s=123.0,
                                 service_time_source=pool.row_service_s)
        assert ac.estimated_wait_s(10) == pytest.approx(10 * per_row)


def test_four_replica_pool_no_spurious_late_sheds(world):
    """A 4-replica pool's parallelism hint: deadlines that fit through four
    concurrent replicas but not through a serial drain are all admitted."""
    def make_scorer():
        def scorer(q_tok, a_tok, feats):
            time.sleep(0.002 * q_tok.shape[0])
            return np.zeros((q_tok.shape[0],), np.float32)
        return scorer

    with ReplicaPool([make_scorer() for _ in range(4)], world.tok,
                     world.corpus.idf, world.cfg.max_len,
                     policy="least_outstanding") as pool:
        pool.get_scores(_pairs(world.corpus, 8))
        per_row = pool.row_service_s()
        assert per_row is not None and per_row > 0
        assert pool.effective_parallelism == 4
        ac = AdmissionController(max_queue_rows=4096,
                                 service_time_source=pool.row_service_s)
        ac.set_effective_parallelism(pool.effective_parallelism)
        serial = AdmissionController(max_queue_rows=4096,
                                     service_time_source=pool.row_service_s)
        now = time.perf_counter()
        deadline = now + 100 * per_row
        sheds_serial = 0
        for _ in range(20):
            assert ac.try_admit(16, deadline_abs=deadline, now=now) is None
            if serial.try_admit(16, deadline_abs=deadline, now=now) is not None:
                sheds_serial += 1
        assert ac.stats()["shed_late"] == 0
        assert sheds_serial > 0


def test_microbatcher_outstanding_rows_settle(world):
    scorer = BK.make_scorer("numpy", world.tree, world.cfg, buckets=BUCKETS)
    rng = np.random.default_rng(0)
    q = rng.integers(0, world.cfg.vocab_size, (6, world.cfg.max_len)).astype(np.int32)
    a = rng.integers(0, world.cfg.vocab_size, (6, world.cfg.max_len)).astype(np.int32)
    f = rng.random((6, 4), np.float32)
    with MicroBatcher(scorer, max_batch=8, max_wait_s=0.002) as mb:
        mb.submit_many(q, a, f).result(timeout=WAIT_S)
        deadline = time.time() + 5
        while mb.outstanding_rows and time.time() < deadline:
            time.sleep(0.01)
        s = mb.stats()
    assert s["outstanding_rows"] == 0 and s["rows_scored"] == 6


# ------------------------------ deadlines (test_deadline_retry, test_hedge) --

def test_pool_sheds_expired_get_scores():
    with ReplicaPool([_stub_scorer], HashingTokenizer(512), idf={}, max_len=8) as pool:
        pairs = [("what is x", "x is y")]
        with pytest.raises(wire.ShedError, match="expired"):
            pool.get_scores(pairs, deadline_abs=time.perf_counter() - 1.0)
        assert pool.get_scores(pairs) == pytest.approx([0.5])


def test_replica_pool_get_score_sheds_expired():
    with ReplicaPool([_stub_scorer], HashingTokenizer(512), idf={}, max_len=8) as pool:
        with pytest.raises(wire.ShedError, match="expired"):
            pool.get_score("q", "a", deadline_abs=time.perf_counter() - 1.0)
        assert pool.get_score("q", "a") == pytest.approx(0.5)


def test_server_replies_shed_for_expired_deadline():
    """An expired wire deadline passes the SimpleServer (no admission) and
    is dropped at the pool's batcher dequeue, answered with MSG_SHED."""
    with ReplicaPool([_stub_scorer], HashingTokenizer(512), idf={}, max_len=8) as pool:
        srv = SV.SimpleServer(pool).start_background()
        try:
            with SV.Client(srv.address) as cl:
                with pytest.raises(wire.ShedError, match="expired"):
                    cl.get_score("q", "a", deadline_s=-1.0)
                assert cl.get_score("q", "a") == pytest.approx(0.5)
        finally:
            srv.stop()


# --------------------------------------- tests/test_threadpool.py, mirrored --

@pytest.mark.parametrize("backend", ["eager", "numpy", "pallas"])
def test_threadpool_pool_scores_identical_to_simple_server(world, backend):
    """The cluster path == the sequential SimpleServer path, same backend,
    same requests, bit-equal."""
    reqs = _pairs(world.corpus, 10)
    with SV.SimpleServer(_direct(world, backend)).start_background() as simple:
        with SV.Client(simple.address) as cl:
            want = [cl.get_score(q, a) for q, a in reqs]
            want_batch = cl.get_score_batch(reqs)
    with _pool(world, backend) as pool:
        with SV.ThreadPoolServer(pool, num_workers=4,
                                 admission=AdmissionController(1024)
                                 ).start_background() as srv:
            with SV.Client(srv.address) as cl:
                got = [cl.get_score(q, a) for q, a in reqs]
                got_batch = cl.get_score_batch(reqs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_batch, want_batch)


def test_threadpool_concurrent_clients_all_correct(world):
    reqs = _pairs(world.corpus, 8)
    want = _direct(world, "eager").get_scores(reqs)
    results = {}
    with _pool(world, "eager") as pool:
        with SV.ThreadPoolServer(pool, num_workers=6).start_background() as srv:
            def client(i):
                with SV.Client(srv.address) as cl:
                    results[i] = [cl.get_score(q, a, deadline_s=WAIT_S)
                                  for q, a in reqs]

            threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
            for t in threads:
                t.start()
            _join(threads)
    assert len(results) == 6
    for got in results.values():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------- tests/test_ops_plan.py's ReplicaPool case, mirrored --

def test_remote_plan_through_replica_pool(world):
    """ctx.remote can be an in-process handler (a ReplicaPool): no sockets."""
    w = world
    docs = [w.tok.encode(" ".join(d)) for d in w.corpus.documents]
    ctx = PlanContext.from_world(w.cfg, w.tree, w.corpus, w.tok,
                                 BM.build_index(docs, w.cfg.vocab_size), device="cpu")
    with ReplicaPool([ctx.scorer_for("eager", 200)], w.tok, w.corpus.idf,
                     w.cfg.max_len) as pool:
        p = ops.Retrieve(h=8) >> ops.Rerank("eager", k=5)
        verify_plans([plan(p, "local", ctx), plan(p, "remote", ctx=ctx, remote=pool)],
                     w.corpus.questions[:5])


# --------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_pallas_pool_behind_threadpool_server(world, cuda_device):
    """Two ``pallas`` replicas on the card behind a ``ThreadPoolServer``
    under 8 client threads with pairs of their own: every reply is its
    pair's score from an ``eager`` scorer on the card (rtol 1e-4, atol
    1e-5), and the conv kernel launched twice a replica scorer call."""
    from repro_torch.kernels import sm_cnn_conv
    reqs = {i: _pairs(world.corpus, 16)[i:] + _pairs(world.corpus, 16)[:i]
            for i in range(8)}
    direct = _direct(world, "eager", device=cuda_device)
    want = {i: direct.get_scores(r) for i, r in reqs.items()}
    results = {}
    with _pool(world, "pallas", device=cuda_device) as pool:
        sm_cnn_conv.reset_launches()
        with SV.ThreadPoolServer(pool, num_workers=8).start_background() as srv:
            def client(i):
                with SV.Client(srv.address) as cl:
                    results[i] = [cl.get_score(q, a) for q, a in reqs[i]]

            threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            _join(threads)
        calls = sum(r.batcher.scorer.calls for r in pool.replicas)
        assert sm_cnn_conv.launches == 2 * calls > 0
    for i in range(8):
        np.testing.assert_allclose(results[i], want[i], rtol=RTOL, atol=ATOL)
