"""The port's ``remote`` and ``remote_pipeline`` plans on the CPU:
``tests/test_ops_plan.py``'s remote cases (lines 181-330, less the
``ReplicaPool`` one, whose module is not ported) for the ``eager``,
``numpy`` and ``pallas`` backends, a remote plan against a JAX server, and
``tests/test_hedge.py``'s cases that need no timing (where the JAX test
slept to make a replica slow, these hold it on an event). Every plan ranks
as ``local`` does (``verify_plans``, swaps only between scores within
1e-5)."""
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import backends as jax_backends
from repro.core import service as JSV
from repro_torch.configs import get_config, reduced
from repro_torch.core import bm25 as BM
from repro_torch.core import ops
from repro_torch.core import pipeline as PL
from repro_torch.core import service as SV
from repro_torch.core import wire
from repro_torch.core.plan import (FuseStage, PlanContext, PlanError, _LocalChild,
                                   candidate_bound, plan, verify_plans)
from repro_torch.data import qa as QA
from repro_torch.data.featurize import FeaturizationCache
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.kernels import sm_cnn_conv
from repro_torch.models import sm_cnn
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.engine import PipelineEngine, ServingEngine
from repro_torch.serving.hedge import HedgedTransport

torch.set_num_threads(2)

BACKENDS = ["eager", "numpy", "pallas"]
TIE_ATOL = 1e-5
WAIT_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def _bounded_sockets():
    """Every socket this module opens without a timeout of its own (the
    clients' among them) times out instead of blocking on a hung peer."""
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(WAIT_S)
    yield
    socket.setdefaulttimeout(old)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("sm-cnn"))
    corpus = QA.generate_corpus(n_docs=40, n_questions=24, seed=3)
    tok = HashingTokenizer(cfg.vocab_size)
    index = BM.build_index([tok.encode(" ".join(d)) for d in corpus.documents],
                           cfg.vocab_size)
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    tree["embed"] = tree["embed"] * 50.0   # spread the scores apart
    return cfg, tree, corpus, tok, index


def _ctx(world, **kw) -> PlanContext:
    cfg, tree, corpus, tok, index = world
    return PlanContext.from_world(cfg, tree, corpus, tok, index, device="cpu", **kw)


class StubScorer:
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def __call__(self, q_tok, a_tok, feats):
        return np.asarray(self._fn(q_tok, a_tok, feats), np.float32)


def test_fuse_stage_interpolates_scores(world):
    cfg, _, corpus, tok, _ = world
    cache = FeaturizationCache(tok, corpus.idf, cfg.max_len)
    cands = [PL.Candidate(0, i, f"sentence number {i}", 1.0) for i in range(6)]
    up = StubScorer("up", lambda q, a, f: np.arange(q.shape[0]))
    down = StubScorer("down", lambda q, a, f: -2.0 * np.arange(q.shape[0]))
    fuse = FuseStage([_LocalChild(up), _LocalChild(down)], [0.7, 0.3], cache, k=4)
    out = fuse.run("which sentence", cands)
    assert [c.sent_id for c in out] == [5, 4, 3, 2]
    assert out[0].score == pytest.approx(0.5)
    outs = fuse.run_batch(["which sentence", "empty"], [list(cands), []])
    assert [c.sent_id for c in outs[0]] == [5, 4, 3, 2] and outs[1] == []


# ------------------------------------ tests/test_ops_plan.py:181-330, mirrored --

@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_equivalence_local_batched_remote(world, backend):
    """One pipeline, four plans, identical rankings — per backend, with the
    remote plan through a real server + Client and the remote_pipeline plan
    through a ThreadPoolServer over a PipelineEngine."""
    cfg, _, corpus, tok, _ = world
    ctx = _ctx(world)
    handler = SV.QuestionAnsweringHandler(ctx.scorer_for(backend, 200), tok,
                                          corpus.idf, cfg.max_len)
    p = ops.Retrieve(h=8) >> ops.Rerank(backend, k=5)
    engine = PipelineEngine(p, _ctx(world), target="batched")
    launches = sm_cnn_conv.launches
    plans = []
    with SV.SimpleServer(handler).start_background() as srv, \
            SV.ThreadPoolServer(engine).start_background() as psrv:
        try:
            plans = [plan(p, "local", ctx), plan(p, "batched", ctx),
                     plan(p, "remote", ctx=ctx, remote=srv.address),
                     plan(p, "remote_pipeline", ctx=ctx, remote=psrv.address)]
            verify_plans(plans, corpus.questions[:10], tie_atol=TIE_ATOL)
            # the per-query remote path matches the coalesced one
            q = corpus.questions[0]
            seq_ids = [(c.doc_id, c.sent_id) for c in plans[2].run(q)[0]]
            many_ids = [(c.doc_id, c.sent_id) for c in plans[2].run_many([q])[0][0]]
            assert seq_ids == many_ids and seq_ids
            assert "[rpc]" in plans[2].describe()
        finally:
            for pl_ in plans:
                pl_.close()
    assert sm_cnn_conv.launches == launches     # CPU tensors launch nothing


def test_plan_equivalence_fused(world):
    cfg, _, corpus, tok, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=8) >> (ops.Rerank("eager") | ops.Rerank("numpy")) % 6
    verify_plans([plan(p, "local", ctx), plan(p, "batched", ctx)], corpus.questions[:8],
                 tie_atol=TIE_ATOL)


def test_remote_plan_through_in_process_engine(world):
    """ctx.remote can be an in-process handler (a ServingEngine) — no
    sockets; the plan threads its deadline into the engine."""
    cfg, _, corpus, tok, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=8) >> ops.Rerank("pallas", k=5)
    with ServingEngine(ctx.scorer_for("pallas", 200), tok, corpus.idf, cfg.max_len,
                       max_wait_s=0.0005) as eng:
        remote = plan(p, "remote", ctx=ctx, remote=eng)
        verify_plans([plan(p, "local", ctx), remote], corpus.questions[:8],
                     tie_atol=TIE_ATOL)
        out = remote.run_many(corpus.questions[:2],
                              deadline_abs=time.perf_counter() + 60)
        assert len(out) == 2 and eng.stats()["rows_scored"] > 0


def test_remote_fuse_per_backend_endpoints(world):
    """A fused pipeline's remote children resolve per-spec endpoints from a
    ctx.remote dict (here: two in-process handlers)."""
    cfg, _, corpus, tok, _ = world
    ctx = _ctx(world)
    handlers = {b: SV.QuestionAnsweringHandler(ctx.scorer_for(b, 200), tok,
                                               corpus.idf, cfg.max_len)
                for b in ("pallas", "numpy")}
    p = ops.Retrieve(h=8) >> (ops.Rerank("pallas") | ops.Rerank("numpy")) % 6
    verify_plans([plan(p, "local", ctx), plan(p, "remote", ctx=ctx, remote=handlers)],
                 corpus.questions[:8], tie_atol=TIE_ATOL)


def test_remote_pipeline_plan_equivalence(world):
    """remote_pipeline: the whole cascade runs server-side behind one v3
    ranking RPC per query batch; candidate text is rebuilt locally."""
    _, _, corpus, _, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=8) >> ops.Rerank("eager", k=5)
    engine = PipelineEngine(p, _ctx(world), target="batched")
    plans = []
    with SV.ThreadPoolServer(engine).start_background() as srv:
        try:
            plans = [plan(p, "local", ctx), plan(p, "batched", ctx),
                     plan(p, "remote_pipeline", ctx=ctx, remote=srv.address)]
            verify_plans(plans, corpus.questions[:10], tie_atol=TIE_ATOL)
            cands, trace = plans[2].run(corpus.questions[0])
            assert cands and all(c.text == corpus.documents[c.doc_id][c.sent_id]
                                 for c in cands)
            assert [t.name for t in trace] == ["pipeline@remote"]
            assert plans[2].describe().startswith("remote_pipeline: rank-rpc[")
        finally:
            for pl_ in plans:
                pl_.close()


def test_remote_pipeline_in_process_engine(world):
    """ctx.remote can be a PipelineEngine directly (no sockets) — and the
    admission row estimate reflects the pipeline's candidate bound."""
    _, _, corpus, _, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=4) >> ops.Cutoff(6) >> ops.Rerank("numpy", k=3)
    engine = PipelineEngine(p, _ctx(world), target="batched")
    assert engine.rows_per_query == candidate_bound(p, ctx) == 6
    verify_plans([plan(p, "local", ctx), plan(p, "remote_pipeline", ctx=ctx, remote=engine)],
                 corpus.questions[:8], tie_atol=TIE_ATOL)


def test_remote_pipeline_rank_chunk_bounds_rpc_size(world):
    _, _, corpus, _, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=4) >> ops.Rerank("numpy", k=3)
    engine = PipelineEngine(p, _ctx(world), target="batched")
    calls = []

    class Recorder:
        def rank_batch(self, queries):
            calls.append(len(queries))
            return engine.rank_batch(queries)

    out = plan(p, "remote_pipeline", ctx=ctx, remote=Recorder(),
               rank_chunk=3).run_many(corpus.questions[:8])
    assert len(out) == 8 and calls == [3, 3, 2]
    total = sum(trace[0].latency_s for _, trace in out)
    assert total == pytest.approx(8 * out[0][1][0].latency_s)


def test_remote_pipeline_needs_ranking_endpoint(world):
    cfg, _, corpus, tok, _ = world
    ctx = _ctx(world)
    handler = SV.QuestionAnsweringHandler(ctx.scorer_for("numpy", 200), tok,
                                          corpus.idf, cfg.max_len)
    p = ops.Retrieve(h=4) >> ops.Rerank("numpy", k=3)
    with pytest.raises(PlanError, match="rank_batch"):
        plan(p, "remote_pipeline", ctx=ctx, remote=handler)
    with pytest.raises(PlanError, match="ctx.remote"):
        plan(p, "remote", ctx=ctx)
    with pytest.raises(PlanError, match="no local stage"):
        from repro_torch.core.plan import lower
        lower(p, "remote_pipeline", ctx)


def test_remote_pipeline_binds_a_fabric_router(world):
    """An endpoint with a ranking ``router`` (the JAX package's serving
    fabric) binds through that router, and the plan leaves the router to its
    owner: here the JAX ``HealthRouter`` over a port ThreadPoolServer in
    front of a ``PipelineEngine``."""
    import types

    from repro.serving.fabric import HealthRouter, WorkerEndpoint
    _, _, corpus, _, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=8) >> ops.Rerank("numpy", k=5)
    engine = PipelineEngine(p, _ctx(world), target="batched")
    plans = []
    with SV.ThreadPoolServer(engine).start_background() as srv:
        router = HealthRouter([WorkerEndpoint(0, srv.address)])
        try:
            router.probe_once()
            fabric = types.SimpleNamespace(router=router)
            plans = [plan(p, "local", ctx),
                     plan(p, "remote_pipeline", ctx=ctx, remote=fabric)]
            assert plans[1]._ranker is router
            verify_plans(plans, corpus.questions[:8], tie_atol=TIE_ATOL)
            assert router.stats()["hedge_requests"] >= 1
            plans[1].close()
            assert router.rank_batch(corpus.questions[:1])[0]   # still open
        finally:
            for pl_ in plans:
                pl_.close()
            router.close()


def test_plan_run_and_trace_contract(world):
    _, _, corpus, _, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=6) >> ops.Cutoff(12) >> ops.Rerank("numpy", k=3)
    for target in ("local", "batched"):
        cands, trace = plan(p, target, ctx).run(corpus.questions[0])
        assert len(cands) <= 3
        assert [t.name.split("-")[0] for t in trace] == ["bm25", "top12", "rerank"]
        assert all(t.latency_s >= 0 for t in trace)


def test_expired_deadline_sheds_before_any_rpc(world):
    _, _, corpus, _, _ = world
    ctx = _ctx(world)
    p = ops.Retrieve(h=4) >> ops.Rerank("numpy", k=3)

    class Refuses:
        def rank_batch(self, queries):
            raise AssertionError("an expired request reached the endpoint")

    with pytest.raises(wire.ShedError, match="expired"):
        plan(p, "remote_pipeline", ctx=ctx, remote=Refuses()).run_many(
            corpus.questions[:2], deadline_abs=time.perf_counter() - 1)


def test_port_remote_plan_against_jax_server(world):
    """The frames are the JAX package's: a port remote plan scores through a
    JAX server over the same weights and ranks as the port's local plan."""
    cfg, tree, corpus, tok, _ = world
    jcfg = jax_reduced(jax_get_config("sm-cnn"))
    jscorer = jax_backends.make_scorer("eager", jax.tree.map(jnp.asarray, tree), jcfg,
                                       buckets=(1, 8, 64, 256))
    from repro.data.tokenizer import HashingTokenizer as JaxTokenizer
    jhandler = JSV.QuestionAnsweringHandler(jscorer, JaxTokenizer(jcfg.vocab_size),
                                            corpus.idf, jcfg.max_len)
    ctx = _ctx(world)
    p = ops.Retrieve(h=8) >> ops.Rerank("eager", k=5)
    with JSV.ThreadPoolServer(jhandler).start_background() as srv:
        remote = plan(p, "remote", ctx=ctx, remote=[srv.address, srv.address], hedge_ms=1e4)
        try:
            verify_plans([plan(p, "local", ctx), remote], corpus.questions[:8],
                         tie_atol=TIE_ATOL)
            assert type(remote.stages[1].transport).__name__ == "HedgedTransport"
        finally:
            remote.close()


# --------------------------------------- tests/test_hedge.py, without timing --

class _StubTransport:
    """In-process endpoint with an optional gate and a call log."""

    def __init__(self, name, value, fail=False, gate=None):
        self.name = name
        self.value = value
        self.fail = fail
        self.gate = gate
        self.calls = 0
        self.completed = 0
        self._lock = threading.Lock()

    def _wait(self):
        if self.gate is not None and not self.gate.wait(WAIT_S):
            raise RuntimeError("gate never opened")

    def rank_batch(self, queries):
        with self._lock:
            self.calls += 1
        self._wait()
        if self.fail:
            raise wire.ShedError("stub shed")
        out = [[(self.value, 0, float(self.value))] for _ in queries]
        with self._lock:
            self.completed += 1
        return out

    def get_score_batch(self, pairs):
        with self._lock:
            self.calls += 1
        self._wait()
        return [float(self.value)] * len(pairs)


def _until(cond):
    deadline = time.time() + WAIT_S
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    assert cond()


def test_hedge_wins_over_gated_primary_and_loser_drains():
    gate = threading.Event()
    slow = _StubTransport("slow", 1, gate=gate)
    fast = _StubTransport("fast", 2)
    with HedgedTransport([slow, fast], hedge_s=0.02) as ht:
        assert ht.rank_batch(["q"]) == [[(2, 0, 2.0)]]   # the backup's answer won
        s = ht.stats()
        assert s["hedged"] == 1.0 and s["hedge_wins"] == 1.0
        assert slow.completed == 0
        gate.set()                                       # the loser drains
        _until(lambda: slow.completed == 1)
        assert ht.rank_batch(["q2"]) in ([[(1, 0, 1.0)]], [[(2, 0, 2.0)]])


def test_unhedged_baseline_waits_out_the_primary():
    gate = threading.Event()
    slow = _StubTransport("slow", 1, gate=gate)
    fast = _StubTransport("fast", 2)
    ht = HedgedTransport([slow, fast], hedge_s=float("inf"))
    threading.Timer(0.05, gate.set).start()
    assert ht.rank_batch(["q"]) == [[(1, 0, 1.0)]]       # primary = slow, no hedge
    assert ht.stats()["hedged"] == 0.0 and fast.calls == 0


def test_failed_primary_fails_over_to_backup():
    ht = HedgedTransport([_StubTransport("bad", 1, fail=True), _StubTransport("good", 2)],
                         hedge_s=WAIT_S)
    assert ht.rank_batch(["q"]) == [[(2, 0, 2.0)]]       # no wait for the delay
    assert ht.stats()["hedge_wins"] == 1.0


def test_all_endpoints_failing_raises_primary_error():
    ht = HedgedTransport([_StubTransport("b1", 1, fail=True),
                          _StubTransport("b2", 2, fail=True)], hedge_s=0.01)
    with pytest.raises(wire.ShedError):
        ht.rank_batch(["q"])


def test_single_endpoint_no_hedging():
    only = _StubTransport("only", 7)
    ht = HedgedTransport([only], hedge_s=0.001)
    assert ht.rank_batch(["q"]) == [[(7, 0, 7.0)]]
    assert ht.stats()["hedged"] == 0.0
    only.fail = True
    with pytest.raises(wire.ShedError):
        ht.rank_batch(["q"])


def test_warmed_tracker_switches_from_default_to_adaptive():
    ht = HedgedTransport([_StubTransport("a", 1), _StubTransport("b", 2)],
                         min_samples=4, default_hedge_s=WAIT_S, min_hedge_s=0.001)
    assert ht.tracker.percentile(0.95) == 0.0
    for _ in range(4):
        assert ht.hedge_delay_s() == pytest.approx(WAIT_S)   # still cold
        ht.rank_batch(["q"])
    assert 0.001 <= ht.hedge_delay_s() < WAIT_S


def test_fresh_requests_route_around_busy_endpoint():
    """An attempt holding endpoint 0's lock (a loser draining its reply):
    every fresh request lands on the free endpoint."""
    import queue as queue_mod
    gate = threading.Event()
    slow = _StubTransport("slow", 1, gate=gate)
    fast = _StubTransport("fast", 2)
    ht = HedgedTransport([slow, fast], hedge_s=float("inf"))
    drain = threading.Thread(target=ht._attempt,
                             args=(0, "get_score_batch", ([("q", "a")],), queue_mod.Queue()),
                             daemon=True)
    drain.start()
    _until(lambda: ht._locks[0].locked())
    outs = [ht.get_score_batch([("q", "a")]) for _ in range(4)]
    assert all(out == [2.0] for out in outs)
    assert fast.calls == 4 and slow.calls == 1       # the drain's own call only
    gate.set()
    drain.join(timeout=WAIT_S)
    assert not drain.is_alive()


def test_hedged_over_real_sockets_stream_stays_clean():
    """Socket endpoints: the loser's reply is read by its own attempt on its
    own connection, so a later request through the same client decodes the
    right frame."""
    class GatedHandler:
        def __init__(self, value, gate=None):
            self.value, self.gate = value, gate

        def get_scores(self, pairs):
            if self.gate is not None and not self.gate.wait(WAIT_S):
                raise RuntimeError("gate never opened")
            return np.full((len(pairs),), self.value, np.float32)

    gate = threading.Event()
    with SV.SimpleServer(GatedHandler(0.25, gate)).start_background() as srv_slow, \
            SV.SimpleServer(GatedHandler(0.0)).start_background() as srv_fast:
        with HedgedTransport([SV.Client(srv_slow.address), SV.Client(srv_fast.address)],
                             hedge_s=0.02) as ht:
            assert list(ht.get_score_batch([("q", "a"), ("q2", "a2")])) == [0.0, 0.0]
            assert ht.stats()["hedge_wins"] == 1.0
            gate.set()
            _until(lambda: not ht._locks[0].locked())
            ht._hedge_s = float("inf")   # from here each call keeps its endpoint
            got = sorted(ht.get_score_batch([("x", "y")])[0] for _ in range(2))
            assert got == [0.0, 0.25]    # both endpoints, each its own reply


def test_serving_engine_get_score_sheds_expired():
    def stub(q_tok, a_tok, feats):
        return np.full((q_tok.shape[0],), 0.5, np.float32)

    with ServingEngine(stub, HashingTokenizer(512), idf={}, max_len=8) as eng:
        with pytest.raises(wire.ShedError, match="expired"):
            eng.get_score("q", "a", deadline_abs=time.perf_counter() - 1.0)
        assert eng.get_score("q", "a", deadline_abs=time.perf_counter() + 30.0) == \
            pytest.approx(0.5)
        assert eng.get_score("q", "a") == pytest.approx(0.5)


def test_batches_stat_is_monotonic_not_windowed():
    def stub(q_tok, a_tok, feats):
        return np.full((q_tok.shape[0],), 0.5, np.float32)

    with MicroBatcher(stub, max_batch=4, max_wait_s=0.0) as mb:
        mb.batch_sizes = type(mb.batch_sizes)(maxlen=2)
        q, f = np.zeros((1, 4), np.int32), np.zeros((1, 4), np.float32)
        for _ in range(5):
            mb.submit_many(q, q, f).result(timeout=WAIT_S)
        stats = mb.stats()
        assert stats["batches"] == 5.0 and stats["mean_batch"] == 1.0
