"""The port's service (``core/service.py`` and ``serving/{stats,admission,
batcher,engine}.py``) on the CPU: ``tests/test_service.py`` and the
non-timing cases of ``tests/test_threadpool.py``,
``tests/test_deadline_retry.py`` and ``tests/test_admission_buckets.py``,
mirrored; and across the packages: a JAX ``Client`` against the port's
``SimpleServer``/``ThreadPoolServer`` and the port's ``Client`` against a
JAX server, with the weights of both sides drawn from one seed. Scores agree
at rtol 1e-4, atol 1e-5; ``rank_batch`` through ``PipelineEngine`` gives the
same rankings.

Where a JAX test waited on a sleep to hold a request in flight, these hold
it on an event instead. Every socket read has a timeout, every join and
wait a bound (client sockets through the default timeout)."""
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import backends as jax_backends, bm25 as jax_bm25, ops as jax_ops
from repro.core import service as JSV
from repro.core.plan import PlanContext as JaxPlanContext
from repro.data import qa as jax_qa
from repro.data.tokenizer import HashingTokenizer as JaxTokenizer
from repro.serving import admission as jax_admission
from repro.serving.engine import PipelineEngine as JaxPipelineEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core import backends as BK, bm25 as BM, ops
from repro_torch.core import service as SV
from repro_torch.core import wire
from repro_torch.core.plan import PlanContext
from repro_torch.core.registry import ModelRegistry
from repro_torch.data import qa as QA
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.models import sm_cnn
from repro_torch.serving import telemetry
from repro_torch.serving.admission import (SERVICE_BUCKETS, SHED_LATE,
                                           AdmissionController, _bucket_of)
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.engine import PipelineEngine, ServingEngine

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
BUCKETS = (1, 8, 64)
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
    """One corpus, one weight tree drawn from a seed, and each package's
    eager scorer, handler and planning context over them."""
    cfg = reduced(get_config("sm-cnn"))
    jcfg = jax_reduced(jax_get_config("sm-cnn"))
    corpus = QA.generate_corpus(n_docs=20, n_questions=6, seed=7)
    jcorpus = jax_qa.generate_corpus(n_docs=20, n_questions=6, seed=7)
    assert corpus.questions == jcorpus.questions
    tok, jtok = HashingTokenizer(cfg.vocab_size), JaxTokenizer(jcfg.vocab_size)
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=5)
    tree["embed"] = tree["embed"] * 50.0   # spread the scores apart
    params = sm_cnn.params_from_numpy(tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    scorer = BK.make_scorer("eager", params, cfg, buckets=BUCKETS, device="cpu")
    jscorer = jax_backends.make_scorer("eager", jparams, jcfg, buckets=BUCKETS)
    handler = SV.QuestionAnsweringHandler(scorer, tok, corpus.idf, cfg.max_len)
    jhandler = JSV.QuestionAnsweringHandler(jscorer, jtok, jcorpus.idf, jcfg.max_len)
    docs = [tok.encode(" ".join(d)) for d in corpus.documents]
    ctx = PlanContext.from_world(cfg, params, corpus, tok,
                                 BM.build_index(docs, cfg.vocab_size), device="cpu")
    jctx = JaxPlanContext.from_world(jcfg, jparams, jcorpus, jtok,
                                     jax_bm25.build_index(docs, jcfg.vocab_size))
    return dict(cfg=cfg, tree=tree, corpus=corpus, tok=tok, scorer=scorer,
                handler=handler, jhandler=jhandler, ctx=ctx, jctx=jctx)


def _requests(corpus, n):
    return [(corpus.questions[i % len(corpus.questions)],
             corpus.documents[i % len(corpus.documents)][0]) for i in range(n)]


class SlowHandler:
    """Deterministic handler with a fixed service time (0 here)."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    def get_scores(self, pairs):
        time.sleep(self.delay_s)
        return np.arange(len(pairs), dtype=np.float64)


class GateHandler:
    """Holds every request in flight until ``release`` is set."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def get_scores(self, pairs):
        self.entered.set()
        if not self.release.wait(WAIT_S):
            raise RuntimeError("gate never released")
        return np.arange(len(pairs), dtype=np.float64)


def _join(*threads):
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()


# --------------------------------------------- tests/test_service.py, mirrored --

def test_wire_roundtrip_single_batch_reply_error_unicode():
    frame = wire.encode_get_score("what is foo", "foo is bar")
    assert wire.decode_request(frame[4], frame[5:]) == [("what is foo", "foo is bar")]
    pairs = [(f"q{i}", f"a{i} text") for i in range(5)]
    frame = wire.encode_get_score_batch(pairs)
    assert wire.decode_request(frame[4], frame[5:]) == pairs
    for scores in ([0.5], [0.1, 0.9, 0.3333]):
        frame = wire.encode_reply(scores)
        np.testing.assert_allclose(wire.decode_reply(frame[4], frame[5:]), scores)
    frame = wire.encode_error("boom")
    with pytest.raises(RuntimeError, match="boom"):
        wire.decode_reply(frame[4], frame[5:])
    frame = wire.encode_get_score("café ≠ caffé", "naïve answer")
    assert wire.decode_request(frame[4], frame[5:])[0][0] == "café ≠ caffé"


@pytest.fixture(scope="module")
def simple(world):
    with SV.SimpleServer(world["handler"]).start_background() as srv:
        yield srv


def test_service_single_and_batch_agree_with_direct(world, simple):
    corpus, handler = world["corpus"], world["handler"]
    with SV.Client(simple.address) as cl:
        q, a = corpus.questions[0], corpus.documents[0][0]
        assert abs(cl.get_score(q, a) - float(handler.get_scores([(q, a)])[0])) < 1e-9
        pairs = [(q, corpus.documents[0][i]) for i in range(3)]
        np.testing.assert_allclose(cl.get_score_batch(pairs), handler.get_scores(pairs),
                                   rtol=1e-9)


def test_service_survives_bad_pair_and_recovers(world, simple):
    corpus = world["corpus"]
    with SV.Client(simple.address) as cl:
        assert 0.0 <= cl.get_score("", "") <= 1.0   # empty strings must not kill it
        assert 0.0 <= cl.get_score(corpus.questions[0], corpus.documents[0][0]) <= 1.0


def test_service_sequential_clients(world, simple):
    """TSimpleServer semantics: one connection at a time, served fully."""
    corpus = world["corpus"]
    results = []

    def worker():
        with SV.Client(simple.address) as cl:
            results.append(cl.get_score(corpus.questions[0], corpus.documents[0][0]))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    _join(*threads)
    assert len(results) == 3 and len(set(round(r, 9) for r in results)) == 1


def test_scorer_fault_is_answered_with_msg_error():
    """A server never answers from another scorer: a fault is MSG_ERROR,
    and the connection serves on."""
    class Broken:
        def get_scores(self, pairs):
            if pairs[0][0] == "boom":
                raise FloatingPointError("scorer fault")
            return np.zeros(len(pairs))

    with SV.SimpleServer(Broken()).start_background() as srv, SV.Client(srv.address) as cl:
        with pytest.raises(RuntimeError, match="server error: scorer fault") as ei:
            cl.get_score("boom", "a")
        assert not isinstance(ei.value, wire.ShedError)
        assert cl.get_score("q", "a") == 0.0


def test_client_span_parents_the_server_span(world, simple):
    """Wire v5 trace context: the server's request span is a child of the
    client's span, across the socket."""
    telemetry.reset_all()
    with SV.Client(simple.address) as cl:
        cl.get_score("q", "a")
    spans = {s.name: s for s in telemetry.get_tracer().finished()}
    assert spans["server.score"].parent_id == spans["client.get_score"].span_id
    assert spans["server.score"].trace_id == spans["client.get_score"].trace_id


# --------------------------------------- tests/test_threadpool.py, mirrored --

def test_threadpool_engine_scores_identical_to_simple_server(world, simple):
    """A ThreadPoolServer over a micro-batching ServingEngine answers what
    the SimpleServer over the plain handler does, on the same scorer."""
    reqs = _requests(world["corpus"], 10)
    with SV.Client(simple.address) as cl:
        want = [cl.get_score(q, a) for q, a in reqs]
        want_batch = cl.get_score_batch(reqs)
    cfg = world["cfg"]
    with ServingEngine(world["scorer"], world["tok"], world["corpus"].idf, cfg.max_len,
                       max_batch=64, max_wait_s=0.001) as eng, \
            SV.ThreadPoolServer(eng, num_workers=4,
                                admission=AdmissionController(1024)).start_background() as srv, \
            SV.Client(srv.address) as cl:
        got = [cl.get_score(q, a) for q, a in reqs]
        got_batch = cl.get_score_batch(reqs)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got_batch, want_batch, rtol=0, atol=0)


def test_threadpool_concurrent_clients_all_correct(world):
    reqs = _requests(world["corpus"], 8)
    want = world["handler"].get_scores(reqs)
    results = {}
    with SV.ThreadPoolServer(world["handler"], num_workers=6).start_background() as srv:
        def client(i):
            with SV.Client(srv.address) as cl:
                results[i] = [cl.get_score(q, a, deadline_s=30.0) for q, a in reqs]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        _join(*threads)
    assert len(results) == 6
    for got in results.values():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_threadpool_sheds_on_queue_full():
    """One request holds the bound's only row in flight; the next is shed
    queue_full, and the first still completes."""
    gate = GateHandler()
    out = {}
    with SV.ThreadPoolServer(gate, num_workers=4,
                             admission=AdmissionController(max_queue_rows=1)
                             ).start_background() as srv:
        def first():
            with SV.Client(srv.address) as cl:
                out["first"] = cl.get_score("q", "a")

        th = threading.Thread(target=first)
        th.start()
        assert gate.entered.wait(WAIT_S)
        with SV.Client(srv.address) as cl:
            with pytest.raises(wire.ShedError, match="queue_full"):
                cl.get_score("q", "a")
        gate.release.set()
        _join(th)
        stats = srv.stats()
    assert out["first"] == 0.0
    assert stats["shed_queue_full"] == 1.0 and stats["admitted"] == 1.0


def test_threadpool_sheds_expired_deadline():
    with SV.ThreadPoolServer(SlowHandler(), num_workers=2,
                             admission=AdmissionController(1024)).start_background() as srv:
        with SV.Client(srv.address) as cl:
            with pytest.raises(wire.ShedError, match="expired"):
                cl.get_score("q", "a", deadline_s=0.0)
            assert cl.get_score("q", "a", deadline_s=30.0) == 0.0   # connection survives
        assert srv.stats()["shed_expired"] == 1


def test_threadpool_oversized_batch_is_hard_error_not_shed():
    with SV.ThreadPoolServer(SlowHandler(), num_workers=2,
                             admission=AdmissionController(max_queue_rows=4)
                             ).start_background() as srv, SV.Client(srv.address) as cl:
        with pytest.raises(RuntimeError, match="exceeds admission bound") as ei:
            cl.get_score_batch([("q", "a")] * 5)
        assert not isinstance(ei.value, wire.ShedError)
        assert list(cl.get_score_batch([("q", "a")] * 3)) == [0.0, 1.0, 2.0]


def test_threadpool_serves_old_version_client():
    """A v1 (pre-deadline) frame hand-rolled on a raw socket still scores."""
    payload = bytes([1]) + wire._pack_str("old q") + wire._pack_str("old a")
    frame = struct.pack("<IB", len(payload), wire.MSG_GET_SCORE) + payload
    with SV.ThreadPoolServer(SlowHandler(), num_workers=2).start_background() as srv:
        with socket.create_connection(srv.address, timeout=WAIT_S) as s:
            s.sendall(frame)
            t, reply = wire.read_frame(s)
    assert wire.decode_reply(t, reply) == [0.0]


def test_simple_server_stop_not_blocked_by_silent_client():
    """A connected client that has gone silent must not hang ``stop()``.
    One answered request first puts the server in that connection's read
    loop."""
    srv = SV.SimpleServer(SlowHandler()).start_background()
    silent = socket.create_connection(srv.address, timeout=WAIT_S)
    try:
        silent.sendall(wire.encode_get_score("q", "a"))
        assert wire.decode_reply(*wire.read_frame(silent)) == [0.0]
        srv.stop()
        assert not srv._thread.is_alive()    # within stop()'s 2 s join
    finally:
        silent.close()


def test_client_context_manager_and_reconnect():
    with SV.ThreadPoolServer(SlowHandler(), num_workers=2).start_background() as srv:
        with SV.Client(srv.address) as cl:
            assert cl.get_score("q", "a") == 0.0
            cl._sock.close()                    # a dropped connection
            assert cl.get_score("q", "a") == 0.0
        cl2 = SV.Client(srv.address, reconnect=False)
        cl2._sock.close()
        with pytest.raises((ConnectionError, OSError)):
            cl2.get_score("q", "a")


def test_health_probe_reports_load_and_drain_state():
    with SV.ThreadPoolServer(SlowHandler(), num_workers=2,
                             admission=AdmissionController(max_queue_rows=64)
                             ).start_background() as srv, SV.Client(srv.address) as cl:
        h = cl.health()
        assert (h["draining"], h["inflight"], h["queue_depth"]) == (0.0, 0.0, 0.0)
        assert h["row_service_ms"] > 0.0


def test_drain_sheds_new_work_then_resume_recovers():
    for server in (lambda h: SV.ThreadPoolServer(h, num_workers=2), SV.SimpleServer):
        with server(SlowHandler()).start_background() as srv, SV.Client(srv.address) as cl:
            assert cl.get_score("q", "a") == 0.0
            assert cl.drain()["draining"] == 1.0
            with pytest.raises(wire.ShedError, match="draining"):
                cl.get_score("q", "a")
            assert cl.health()["draining"] == 1.0   # probes still answer
            srv.resume()
            assert cl.get_score("q", "a") == 0.0


def test_drain_waits_for_inflight_work():
    """drain() returns only once the in-flight request finished; new work
    is shed meanwhile; the in-flight call wins."""
    gate = GateHandler()
    result, drained = {}, {}
    with SV.ThreadPoolServer(gate, num_workers=3).start_background() as srv:
        def call():
            with SV.Client(srv.address) as cl:
                result["score"] = cl.get_score("q", "a")

        th = threading.Thread(target=call)
        th.start()
        assert gate.entered.wait(WAIT_S)
        assert srv.state.inflight == 1
        dr = threading.Thread(target=lambda: drained.update(ok=srv.drain(timeout_s=WAIT_S)))
        dr.start()
        with SV.Client(srv.address) as cl:
            with pytest.raises(wire.ShedError, match="draining"):
                cl.get_score("q", "a")
            assert cl.health()["inflight"] == 1.0
            assert dr.is_alive()                     # still waiting on the request
            gate.release.set()
            _join(th, dr)
            assert cl.health()["inflight"] == 0.0
    assert drained["ok"] and srv.state.inflight == 0
    assert result["score"] == 0.0


def test_rank_against_pair_scoring_only_server_gets_msg_error():
    with SV.SimpleServer(SlowHandler()).start_background() as srv, \
            SV.Client(srv.address) as cl:
        with pytest.raises(RuntimeError, match="pair scoring only"):
            cl.rank("who?")
        assert cl.get_score("q", "a") == 0.0


# ----------------------------------- tests/test_deadline_retry.py, mirrored --

def _stub_scorer(q_tok, a_tok, feats):
    return np.full((q_tok.shape[0],), 0.5, np.float32)


def _rows(n=2, width=4):
    return (np.zeros((n, width), np.int32), np.zeros((n, width), np.int32),
            np.zeros((n, 4), np.float32))


def test_batcher_drops_expired_at_dequeue():
    with MicroBatcher(_stub_scorer, max_batch=8, max_wait_s=0.001) as mb:
        expired = mb.submit_many(*_rows(3), deadline_abs=time.perf_counter() - 1.0)
        with pytest.raises(wire.ShedError, match="expired"):
            expired.result(timeout=WAIT_S)
        live = mb.submit_many(*_rows(2), deadline_abs=time.perf_counter() + 60)
        assert live.result(timeout=WAIT_S) == pytest.approx([0.5, 0.5])
        stats = mb.stats()
        assert stats["rows_shed"] == 3.0 and stats["rows_scored"] == 2.0
        assert mb.outstanding_rows == 0


def test_batcher_without_deadline_never_sheds():
    with MicroBatcher(_stub_scorer, max_batch=8, max_wait_s=0.001) as mb:
        q, a, f = _rows(1)
        assert mb.submit(q[0], a[0], f[0]).result(timeout=WAIT_S) == pytest.approx(0.5)
        assert mb.stats()["rows_shed"] == 0.0


def test_engine_sheds_expired_get_scores_and_server_replies_shed():
    with ServingEngine(_stub_scorer, HashingTokenizer(512), idf={}, max_len=8) as eng:
        with pytest.raises(wire.ShedError, match="expired"):
            eng.get_scores([("what is x", "x is y")], deadline_abs=time.perf_counter() - 1)
        assert eng.get_scores([("what is x", "x is y")]) == pytest.approx([0.5])
        with SV.SimpleServer(eng).start_background() as srv, SV.Client(srv.address) as cl:
            with pytest.raises(wire.ShedError, match="expired"):
                cl.get_score("q", "a", deadline_s=-1.0)
            assert cl.get_score("q", "a") == pytest.approx(0.5)


def _shedding_server(n_sheds):
    """Raw wire stub: MSG_SHED for the first ``n_sheds`` requests, then real
    replies. Returns (address, listening socket, state)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    sock.listen(4)
    state = {"sheds_left": n_sheds, "requests": 0}

    def loop():
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            with conn:
                conn.settimeout(WAIT_S)
                while True:
                    try:
                        t, _ = wire.read_frame(conn)
                    except (ConnectionError, OSError, ValueError):
                        break
                    if not t:
                        break
                    state["requests"] += 1
                    if state["sheds_left"] > 0:
                        state["sheds_left"] -= 1
                        conn.sendall(wire.encode_shed("queue_full"))
                    else:
                        conn.sendall(wire.encode_reply([0.25]))

    threading.Thread(target=loop, daemon=True).start()
    return sock.getsockname(), sock, state


@pytest.mark.parametrize("retries,sheds,want_requests", [(3, 2, 3), (2, 100, 3), (0, 100, 1)])
def test_client_shed_retry_budget(retries, sheds, want_requests):
    """Sheds within the budget are retried; past it (or with the default of
    none) the ShedError surfaces."""
    address, sock, state = _shedding_server(n_sheds=sheds)
    try:
        with SV.Client(address, retry_sheds=retries, backoff_s=0.001) as cl:
            if sheds <= retries:
                assert cl.get_score("q", "a") == pytest.approx(0.25)
                assert cl.shed_retries == sheds
            else:
                with pytest.raises(wire.ShedError):
                    cl.get_score("q", "a")
        assert state["requests"] == want_requests
    finally:
        sock.close()


def test_retry_backoff_is_exponential_and_capped():
    address, sock, _ = _shedding_server(n_sheds=3)
    try:
        with SV.Client(address, retry_sheds=3, backoff_s=0.02, backoff_max_s=0.03) as cl:
            t0 = time.perf_counter()
            assert cl.get_score("q", "a") == pytest.approx(0.25)
            # sleeps: 0.02 + min(0.04, 0.03) + min(0.08, 0.03) = 0.08 s at least
            assert time.perf_counter() - t0 >= 0.08
    finally:
        sock.close()


def _stalling_listener(stall_s: float, record: dict):
    """First connection: read one request, stall, drop it. Second (if the
    client resends): record the resent deadline and answer."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(2)
    lst.settimeout(WAIT_S)

    def serve():
        conn, _ = lst.accept()
        conn.settimeout(WAIT_S)
        record["first_request"] = wire.read_frame(conn)
        time.sleep(stall_s)
        conn.close()
        lst.settimeout(1.0)
        try:
            conn2, _ = lst.accept()
        except socket.timeout:
            return
        record["reconnected"] = True
        conn2.settimeout(WAIT_S)
        t, payload = wire.read_frame(conn2)
        record["resent_deadline"] = wire.decode_request_ex(t, payload)[1]
        conn2.sendall(wire.encode_reply([0.5]))
        conn2.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return lst, th


def test_reconnect_with_expired_budget_sheds_locally():
    record = {}
    lst, th = _stalling_listener(stall_s=0.08, record=record)
    try:
        cl = SV.Client(lst.getsockname())
        with pytest.raises(wire.ShedError, match="expired"):
            cl.get_score("q", "a", deadline_s=0.05)   # < the 80 ms stall
        cl.reconnect = False
        cl.close()
        _join(th)
        assert "reconnected" not in record
    finally:
        lst.close()


def test_reconnect_with_live_budget_resends_remaining_deadline():
    record = {}
    lst, th = _stalling_listener(stall_s=0.08, record=record)
    try:
        cl = SV.Client(lst.getsockname())
        assert cl.get_score("q", "a", deadline_s=5.0) == pytest.approx(0.5)
        cl.close()
        _join(th)
        assert record.get("reconnected")
        assert 0.0 < record["resent_deadline"] <= 5.0 - 0.08 + 0.02
    finally:
        lst.close()


# ------------------------------- tests/test_admission_buckets.py, mirrored --

CHEAP_64_PER_ROW_S = 1e-4
COSTLY_1_PER_ROW_S = 5e-3


def _mixed_traffic(ac, rounds: int = 20):
    for _ in range(rounds):
        for _ in range(9):
            ac.release(64, service_s=64 * CHEAP_64_PER_ROW_S)
        ac.release(1, service_s=COSTLY_1_PER_ROW_S)


def test_bucket_of_edges():
    for n, want in ((1, 1.0), (2, 8.0), (8, 8.0), (64, 64.0), (65, float("inf")),
                    (10_000, SERVICE_BUCKETS[-1])):
        assert _bucket_of(n) == want == jax_admission._bucket_of(n)


def test_single_ewma_would_mispredict_batch1():
    ac = AdmissionController(max_queue_rows=4096)
    _mixed_traffic(ac)
    assert ac.stats()["row_service_ms"] / 1e3 < 0.002
    assert ac.estimated_wait_s(1) == pytest.approx(COSTLY_1_PER_ROW_S, rel=0.5)
    now = time.perf_counter()
    assert ac.try_admit(1, deadline_abs=now + 0.002, now=now) == SHED_LATE


def test_batch64_still_admitted_under_its_own_bucket():
    ac = AdmissionController(max_queue_rows=4096)
    _mixed_traffic(ac)
    now = time.perf_counter()
    assert ac.try_admit(64, deadline_abs=now + 0.05, now=now) is None
    ac.release(64, service_s=64 * CHEAP_64_PER_ROW_S)
    assert ac.try_admit(1, deadline_abs=now + 0.05, now=now) is None
    ac.release(1, service_s=COSTLY_1_PER_ROW_S)


def test_unseen_bucket_falls_back_to_global_ewma():
    ac = AdmissionController(max_queue_rows=4096, init_row_service_s=1e-3)
    for _ in range(10):
        ac.release(64, service_s=64 * CHEAP_64_PER_ROW_S)
    assert ac.estimated_wait_s(8) == pytest.approx(8 * ac.stats()["row_service_ms"] / 1e3,
                                                   rel=1e-6)


def test_stats_expose_per_bucket_estimates():
    ac = AdmissionController(max_queue_rows=4096)
    _mixed_traffic(ac)
    ac.release(500, service_s=500 * CHEAP_64_PER_ROW_S)
    stats = ac.stats()
    assert stats["row_service_ms_le_1"] == pytest.approx(COSTLY_1_PER_ROW_S * 1e3, rel=0.5)
    assert stats["row_service_ms_le_64"] == pytest.approx(CHEAP_64_PER_ROW_S * 1e3, rel=0.5)
    assert "row_service_ms_le_inf" in stats and "row_service_ms_le_8" not in stats


def test_scorer_side_source_still_wins_over_buckets():
    ac = AdmissionController(max_queue_rows=4096)
    _mixed_traffic(ac)
    ac.set_service_time_source(lambda: 2e-3)
    assert ac.estimated_wait_s(1) == pytest.approx(2e-3, rel=1e-6)
    assert ac.estimated_wait_s(64) == pytest.approx(64 * 2e-3, rel=1e-6)


def test_admission_decides_as_the_jax_package_does():
    """One release/admit sequence, drawn from a seed, through both
    packages' controllers: the same decisions and the same stats."""
    rng = np.random.default_rng(3)
    ours = AdmissionController(max_queue_rows=300, effective_parallelism=2)
    theirs = jax_admission.AdmissionController(max_queue_rows=300, effective_parallelism=2)
    now = 1000.0
    held = []
    for _ in range(400):
        n = int(rng.choice([1, 3, 8, 40, 64, 200, 301]))
        if held and rng.random() < 0.5:
            rows, service = held.pop(int(rng.integers(len(held)))), float(rng.random()) * 1e-2
            ours.release(rows, service)
            theirs.release(rows, service)
            continue
        deadline = None if rng.random() < 0.3 else now + float(rng.random()) * 0.05 - 0.005
        got = ours.try_admit(n, deadline_abs=deadline, now=now)
        assert got == theirs.try_admit(n, deadline_abs=deadline, now=now)
        if got is None:
            held.append(n)
        now += 0.001
    assert ours.stats() == theirs.stats()


# -------------------------------------------- the engines, swap and version --

def _registry(world, tmp_path):
    reg = ModelRegistry(str(tmp_path / "registry"))
    va = reg.publish(world["tree"], model=world["cfg"].name).version_id
    tree_b = {k: ({kk: vv * 1.5 for kk, vv in v.items()} if isinstance(v, dict) else v * 1.5)
              for k, v in world["tree"].items()}
    vb = reg.publish(tree_b, model=world["cfg"].name).version_id
    return reg, va, vb


def _engine(world, reg=None, version=None, backend="numpy"):
    import dataclasses
    ctx = dataclasses.replace(world["ctx"], buckets=(1, 8), registry=reg,
                              model_version=version)
    return PipelineEngine(ops.Retrieve(h=8) >> ops.Rerank(backend, k=3), ctx,
                          target="batched")


def test_client_version_and_swap_rpcs(world, tmp_path):
    """MSG_VERSION / MSG_SWAP end to end: probe, swap live, keep serving,
    refuse an unknown version while the old one stays up."""
    reg, va, vb = _registry(world, tmp_path)
    engine = _engine(world, reg, va)
    with SV.SimpleServer(engine).start_background() as srv, SV.Client(srv.address) as cl:
        assert cl.version() == (va, "active")
        assert cl.swap(vb) == (vb, "swapped")
        assert cl.version() == (vb, "active")
        rankings = cl.rank_batch(world["corpus"].questions[:2])
        assert len(rankings) == 2 and rankings[0]
        with pytest.raises(RuntimeError, match="failed"):
            cl.swap("v-000000000000")
        assert cl.version() == (vb, "active")


def test_engine_swap_labels_metrics_per_version(world, tmp_path):
    reg, va, vb = _registry(world, tmp_path)
    telemetry.reset_all()
    engine = _engine(world, reg, va)
    engine.rank_batch(world["corpus"].questions[:3])
    assert engine.swap_version(vb) == vb and engine.model_version == vb
    engine.rank_batch(world["corpus"].questions[:3])
    assert engine.stats()["swaps"] == 1.0
    groups = telemetry.split_by_label(telemetry.get_registry().snapshot(), "model_version")
    assert any(k.startswith("engine_rank_queries") for k in groups[va])
    assert any(k.startswith("engine_rank_queries") for k in groups[vb])


def test_swap_refused_without_registry_and_against_a_versionless_handler(world):
    with pytest.raises(RuntimeError, match="registry"):
        _engine(world).swap_version("latest")
    with SV.SimpleServer(world["handler"]).start_background() as srv, \
            SV.Client(srv.address) as cl:
        assert cl.version()[0] == "unversioned"
        with pytest.raises(RuntimeError, match="swap"):
            cl.swap("latest")
        assert isinstance(cl.get_score(world["corpus"].questions[0], "a"), float)


def test_pipeline_engine_sheds_expired_and_sizes_admission(world):
    engine = _engine(world)
    jengine = JaxPipelineEngine(jax_ops.Retrieve(h=8) >> jax_ops.Rerank("numpy", k=3),
                                world["jctx"], target="batched")
    assert engine.rows_per_query == jengine.rows_per_query > 0
    assert engine.rank_batch([]) == []
    with pytest.raises(wire.ShedError, match="expired"):
        engine.rank_batch(["q"], deadline_abs=time.perf_counter() - 1)


# ------------------------------------------------------- across the packages --

def _agree(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("server", ["simple", "threadpool"])
def test_jax_client_against_port_server(world, server):
    reqs = _requests(world["corpus"], 7)
    make = SV.SimpleServer if server == "simple" else SV.ThreadPoolServer
    with make(world["handler"]).start_background() as srv, JSV.Client(srv.address) as cl:
        got = [cl.get_score(q, a) for q, a in reqs]
        got_batch = cl.get_score_batch(reqs, deadline_s=30.0)
        health = cl.health()
        metrics, spans = cl.stats()
        version = cl.version()
    want = world["jhandler"].get_scores(reqs)
    _agree(got, want)
    _agree(got_batch, want)
    _agree(got, world["handler"].get_scores(reqs))
    assert np.ptp(want) > 1e-3       # the scores differ enough to mean something
    assert health["draining"] == 0.0 and health["inflight"] == 0.0
    assert metrics["server_requests{type=score}"] >= 8.0
    assert any(s[6] == "server.score" for s in spans)
    assert version == ("unversioned", "active")


@pytest.mark.parametrize("server", ["simple", "threadpool"])
def test_port_client_against_jax_server(world, server):
    reqs = _requests(world["corpus"], 7)
    make = JSV.SimpleServer if server == "simple" else JSV.ThreadPoolServer
    with make(world["jhandler"]).start_background() as srv, SV.Client(srv.address) as cl:
        got = [cl.get_score(q, a) for q, a in reqs]
        got_batch = cl.get_score_batch(reqs, deadline_s=30.0)
        assert cl.drain()["draining"] == 1.0
        with pytest.raises(wire.ShedError, match="draining"):
            cl.get_score("q", "a")
        assert cl.health()["inflight"] == 0.0
    _agree(got, world["handler"].get_scores(reqs))
    _agree(got_batch, world["jhandler"].get_scores(reqs))


def _ranking_ids(rankings):
    return [[(d, s) for d, s, _ in r] for r in rankings]


def _jax_engine(world):
    pipe = jax_ops.Retrieve(h=5) >> jax_ops.Rerank("eager") % 4
    return JaxPipelineEngine(pipe, world["jctx"], target="batched")


def _port_engine(world):
    pipe = ops.Retrieve(h=5) >> ops.Rerank("eager") % 4
    return PipelineEngine(pipe, world["ctx"], target="batched")


def test_rank_batch_through_pipeline_engines_across_the_packages(world):
    """The port's PipelineEngine behind the port's ThreadPoolServer, asked
    by a JAX Client, ranks as the JAX PipelineEngine does in process; and
    the other way round."""
    queries = world["corpus"].questions
    ours, theirs = _port_engine(world), _jax_engine(world)
    want_port, want_jax = ours.rank_batch(queries), theirs.rank_batch(queries)
    assert _ranking_ids(want_port) == _ranking_ids(want_jax)
    assert any(want_jax)
    with SV.ThreadPoolServer(ours).start_background() as srv, JSV.Client(srv.address) as cl:
        got = cl.rank_batch(queries)
        one = cl.rank(queries[0])
    with JSV.ThreadPoolServer(theirs).start_background() as jsrv, \
            SV.Client(jsrv.address) as cl:
        got_rev = cl.rank_batch(queries)
        one_rev = cl.rank(queries[0], deadline_s=30.0)
    for rankings in (got, got_rev):
        assert _ranking_ids(rankings) == _ranking_ids(want_jax)
        for r, w in zip(rankings, want_jax):
            _agree([x[2] for x in r], [x[2] for x in w])
    assert _ranking_ids([one, one_rev]) == _ranking_ids(want_jax[:1] * 2)
