"""Socket RPC service — the paper's Thrift server analogues.

``SimpleServer`` is TSimpleServer: single-threaded accept loop, one
connection at a time, repeated requests per connection — exactly the
paper's Table 2 setup, so the measured overhead (serialization + transport
+ dispatch) stays comparable.

``ThreadPoolServer`` is the TThreadPoolServer analogue the paper leaves on
the table: a fixed pool of worker threads each serving one accepted
connection at a time, multiplexing many concurrent clients onto a shared
handler (a ``QuestionAnsweringHandler``, a ``serving.engine.ServingEngine``
or a ``serving.engine.PipelineEngine``). It understands the v2 wire
deadline field and can shed requests through a
``serving.admission.AdmissionController`` instead of queueing unboundedly.

The handler wraps ANY integration backend (Scorer) plus the tokenizer and
overlap featurizer — mirroring QuestionAnsweringHandler in Figure 3. The
scorer runs where it was built (``make_scorer(..., device=)``: the CUDA
card unless asked for the CPU); a scorer fault is answered with MSG_ERROR.
The frames are the JAX package's, byte for byte, so a client of either
package talks to a server of the other.
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock

import numpy as np

from repro_torch.core import wire
from repro_torch.core.backends import Scorer
from repro_torch.data.tokenizer import HashingTokenizer, overlap_features
from repro_torch.serving import telemetry
from repro_torch.serving.admission import SHED_DRAINING, SHED_EXPIRED, SHED_TOO_LARGE

#: Per-connection socket timeout: bounds how long a silent client can hold
#: a serving thread past ``stop()`` (the read loop re-checks the stop flag
#: at this cadence).
CONN_TIMEOUT_S = 0.5


class ServerState:
    """Lifecycle state shared by every connection of one server: the
    graceful-drain flag plus the in-flight request count (requests past
    admission whose handler call has not returned). A draining server sheds
    new work with MSG_SHED "draining" but keeps answering health probes, so
    a fabric router can watch ``inflight`` reach zero before tearing the
    worker down."""

    def __init__(self):
        self.draining = threading.Event()
        self._lock = Lock()
        self._inflight = 0

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def enter(self):
        with self._lock:
            self._inflight += 1

    def exit(self):
        with self._lock:
            self._inflight -= 1


def _health_snapshot(handler, admission, state) -> Dict[str, float]:
    """The MSG_REPLY_HEALTH payload: enough load signal for a router to
    route least-loaded across process boundaries (queue depth + per-row
    service time), plus the readiness bits (draining, inflight)."""
    s: Dict[str, float] = {
        "draining": 1.0 if (state is not None
                            and state.draining.is_set()) else 0.0,
        "inflight": float(state.inflight) if state is not None else 0.0,
        "queue_depth": 0.0,
        "row_service_ms": 0.0,
    }
    if admission is not None:
        a = admission.stats()
        s["queue_depth"] = a["admission_outstanding_rows"]
        s["row_service_ms"] = a["row_service_ms"]
    else:
        outstanding = getattr(handler, "outstanding_rows", None)
        if callable(outstanding):
            s["queue_depth"] = float(outstanding())
        elif outstanding is not None:
            s["queue_depth"] = float(outstanding)
        per_row = getattr(handler, "row_service_s", None)
        if callable(per_row):
            per_row = per_row()
        if per_row:
            s["row_service_ms"] = float(per_row) * 1e3
    rows_per_query = getattr(handler, "rows_per_query", None)
    if rows_per_query is not None:
        s["rows_per_query"] = float(rows_per_query)
    return s


def _stats_snapshot(handler, admission, state
                    ) -> Tuple[Dict[str, float], List[wire.WireSpan]]:
    """The MSG_REPLY_STATS payload: the process-wide MetricsRegistry
    snapshot (batcher queue-wait/compute histograms, admission counters,
    scorer batch sizes — everything instrumented code recorded), prefixed
    health fields, any legacy ``handler.stats()`` numerics, plus the
    tracer's recent finished spans so a supervisor can assemble
    cross-process span trees."""
    metrics = telemetry.get_registry().snapshot()
    for key, value in _health_snapshot(handler, admission, state).items():
        metrics[f"health_{key}"] = value
    stats = getattr(handler, "stats", None)
    if callable(stats):
        for key, value in stats().items():
            try:
                metrics.setdefault(f"handler_{key}", float(value))
            except (TypeError, ValueError):
                continue   # non-numeric legacy stat: not wire-shippable
    return metrics, telemetry.get_tracer().wire_spans()


class QuestionAnsweringHandler:
    """getScore(question, answer) -> double, over a Scorer backend."""

    def __init__(self, scorer: Scorer, tokenizer: HashingTokenizer,
                 idf: Dict[str, float], max_len: int):
        self.scorer = scorer
        self.tok = tokenizer
        self.idf = idf
        self.max_len = max_len

    def get_scores(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        q_tok = self.tok.encode_batch([q for q, _ in pairs], self.max_len)
        a_tok = self.tok.encode_batch([a for _, a in pairs], self.max_len)
        feats = np.stack([overlap_features(self.tok.words(q),
                                           self.tok.words(a), self.idf)
                          for q, a in pairs])
        return self.scorer(q_tok, a_tok, feats)


def _rollout_frame(handler, state: Optional[ServerState], version: Optional[str]
                   ) -> bytes:
    """Answer the rollout control plane (MSG_VERSION / MSG_SWAP).

    A version probe (``version is None``) reports whatever the handler is
    serving. A swap asks the handler to hot-swap to ``version``; success
    clears any graceful-drain state — the v4 drain → reload → REJOIN cycle
    needs no restart — while failure leaves both the old version and the
    drain flag untouched.
    """
    if version is None:
        current = getattr(handler, "model_version", None)
        return wire.encode_reply_version(str(current or "unversioned"))
    swap = getattr(handler, "swap_version", None)
    if swap is None:
        return wire.encode_error(
            "handler has no swap_version (serve a registry-bound "
            "PipelineEngine to enable hot-swap)")
    try:
        active = swap(version)
    except Exception as e:  # noqa: BLE001 — reported, old version serves on
        return wire.encode_error(f"swap to {version!r} failed: {e}")
    if state is not None:
        state.draining.clear()
    telemetry.get_registry().inc("server_swaps")
    return wire.encode_reply_version(str(active), "swapped")


def _serve_connection(conn: socket.socket, handler, stop: threading.Event,
                      admission=None, state: Optional[ServerState] = None
                      ) -> None:
    """Request loop for one accepted connection, shared by both servers.

    Pair-scoring requests need only ``get_scores(pairs) -> array`` on the
    handler; v3 ranking requests (MSG_RANK / MSG_RANK_BATCH) dispatch to
    ``rank_batch(queries) -> rankings`` and are answered with a clean
    MSG_ERROR when the handler only scores pairs. With an
    ``AdmissionController`` attached, requests are admitted (or shed with a
    MSG_SHED reply) before any scoring work starts; ranking requests are
    sized for admission by the handler's per-query candidate-row estimate
    (``rows_per_query``, e.g. retrieve depth x sentences per doc on
    ``serving.engine.PipelineEngine``).

    v4 control frames (MSG_HEALTH / MSG_DRAIN) are answered before — and
    during — drain: health probes never queue behind admission, and a
    draining server keeps reporting its ``inflight`` count so the drainer
    can poll it to zero. The rollout frames (MSG_VERSION / MSG_SWAP) share
    that property: a DRAINED worker still answers them, so the hot-swap
    cycle (drain -> swap -> rejoin) runs over one control connection.
    """
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn.settimeout(CONN_TIMEOUT_S)
    while not stop.is_set():
        try:
            t, payload = wire.read_frame(conn)
        except socket.timeout:
            continue           # idle client: re-check stop flag, keep conn
        except (ConnectionError, OSError):
            break
        except ValueError:     # oversized/corrupt frame: stream is not
            break              # trustworthy past this point — drop it
        if not t:
            break              # clean EOF
        if t in (wire.MSG_HEALTH, wire.MSG_DRAIN, wire.MSG_STATS):
            try:
                wire.decode_control_request(t, payload)
            except Exception as e:  # noqa: BLE001 — malformed request
                frame = wire.encode_error(str(e))
            else:
                if t == wire.MSG_STATS:
                    frame = wire.encode_reply_stats(
                        *_stats_snapshot(handler, admission, state))
                else:
                    if t == wire.MSG_DRAIN and state is not None:
                        state.draining.set()
                    frame = wire.encode_reply_health(
                        _health_snapshot(handler, admission, state))
            try:
                conn.sendall(frame)
            except OSError:
                break
            continue
        if t in (wire.MSG_VERSION, wire.MSG_SWAP):
            try:
                if t == wire.MSG_SWAP:
                    version, _ = wire.decode_swap_request(t, payload)
                else:
                    wire.decode_control_request(t, payload)
                    version = None
            except Exception as e:  # noqa: BLE001 — malformed request
                frame = wire.encode_error(str(e))
            else:
                frame = _rollout_frame(handler, state, version)
            try:
                conn.sendall(frame)
            except OSError:
                break
            continue
        is_rank = t in (wire.MSG_RANK, wire.MSG_RANK_BATCH)
        try:
            if is_rank:
                queries, deadline_s, t_ctx = wire.decode_rank_request_meta(
                    t, payload)
                pairs = ()
            else:
                pairs, deadline_s, t_ctx = wire.decode_request_meta(
                    t, payload)
        except Exception as e:  # noqa: BLE001 — malformed request
            try:
                conn.sendall(wire.encode_error(str(e)))
            except OSError:
                break
            continue
        tracer = telemetry.get_tracer()
        registry = telemetry.get_registry()
        kind = "rank" if is_rank else "score"
        registry.inc("server_requests", type=kind)
        # A v5 frame's trace context makes this server span a CHILD of the
        # caller's client span: one trace tree across the process boundary.
        parent = (telemetry.SpanContext(*t_ctx) if t_ctx is not None
                  else None)
        with tracer.span(f"server.{kind}", parent=parent) as srv_span:
            reply: Optional[bytes] = None
            if state is not None and state.draining.is_set():
                # Graceful drain: in-flight work finishes, new work is shed
                # retriably — another replica (or the respawned worker)
                # takes the retry. Routers stop routing here via the health
                # flag.
                srv_span.set_attr("shed", SHED_DRAINING)
                reply = wire.encode_shed(SHED_DRAINING)
            elif is_rank and not hasattr(handler, "rank_batch"):
                # v3 ranking request against a pair-scoring-only deployment:
                # a typed protocol error, not a dropped connection.
                reply = wire.encode_error(
                    "handler serves pair scoring only (no rank_batch); "
                    "deploy a pipeline handler for MSG_RANK")
            else:
                # Admission sizing: pair requests are their own row count;
                # ranking requests expand server-side into up to
                # rows_per_query candidate pairs per query.
                if is_rank:
                    n_rows = len(queries) * max(
                        int(getattr(handler, "rows_per_query", 1)), 1)
                else:
                    n_rows = len(pairs)
                srv_span.set_attr("rows", n_rows)
                # The wire deadline is a relative budget (no cross-host
                # clock), so the clock can only start when the frame is
                # read: time spent in the kernel/connection queues before
                # this point must be burned from the budget client-side
                # (see benchmarks/loadgen.py) — a non-positive remaining
                # budget sheds as "expired" here.
                arrival = time.perf_counter()
                deadline_abs = (arrival + deadline_s
                                if deadline_s is not None else None)
                if admission is not None:
                    with tracer.span("admission", rows=n_rows) as adm_span:
                        reason = admission.try_admit(n_rows, deadline_abs,
                                                     now=arrival)
                        if reason is not None:
                            adm_span.set_attr("shed", reason)
                            srv_span.set_attr("shed", reason)
                    if reason is not None:
                        # Back-pressure sheds are retriable MSG_SHED; a
                        # request that alone exceeds the queue bound never
                        # will be — make that a hard error so a
                        # backoff-and-retry client doesn't livelock on it.
                        if reason == SHED_TOO_LARGE:
                            reply = wire.encode_error(
                                f"request of {n_rows} rows exceeds "
                                f"admission bound "
                                f"{admission.max_queue_rows}")
                        else:
                            reply = wire.encode_shed(reason)
                if reply is None:
                    if state is not None:
                        state.enter()
                    try:
                        try:
                            # Handlers that opt in (supports_deadline, e.g.
                            # ReplicaPool) get the absolute deadline so
                            # their MicroBatcher can still drop the request
                            # at dequeue if it expires while queued —
                            # surfaced as a ShedError and answered with
                            # MSG_SHED below.
                            wants_deadline = getattr(
                                handler, "supports_deadline", False)
                            if is_rank:
                                if wants_deadline:
                                    rankings = handler.rank_batch(
                                        queries, deadline_abs=deadline_abs)
                                else:
                                    rankings = handler.rank_batch(queries)
                                reply = wire.encode_reply_ranking(rankings)
                            else:
                                if wants_deadline:
                                    scores = handler.get_scores(
                                        pairs, deadline_abs=deadline_abs)
                                else:
                                    scores = handler.get_scores(pairs)
                                reply = wire.encode_reply(
                                    [float(s) for s in scores])
                        finally:
                            if admission is not None:
                                admission.release(
                                    n_rows,
                                    time.perf_counter() - arrival)
                            if state is not None:
                                state.exit()
                    except wire.ShedError as e:
                        srv_span.set_attr("shed", str(e) or "shed")
                        reply = wire.encode_shed(str(e) or "shed")
                    except Exception as e:  # noqa: BLE001 — service edge
                        srv_span.set_attr("error", type(e).__name__)
                        reply = wire.encode_error(str(e))
        # The reply ships AFTER the request span closes: a caller that
        # reads this reply and immediately pulls MSG_STATS (or the span
        # ring in-process) is guaranteed to see the request's span.
        try:
            conn.sendall(reply)
        except OSError:
            break


def _drain(server, timeout_s: float) -> bool:
    """Shared graceful-drain: stop admitting work (new requests get
    MSG_SHED "draining"), then wait for every in-flight request — and any
    rows still queued inside the handler — to finish. Returns True once
    idle, False on timeout (the flag stays set either way; ``resume()``
    re-opens)."""
    server.state.draining.set()
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        queued = getattr(server.handler, "outstanding_rows", 0)
        if callable(queued):
            queued = queued()
        if server.state.inflight == 0 and not queued:
            return True
        time.sleep(0.005)
    return False


def _make_listener(host: str, port: int, backlog: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    return sock


class SimpleServer:
    """TSimpleServer: single thread, one connection at a time."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self._sock = _make_listener(host, port, backlog=8)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.state = ServerState()

    def serve_forever(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                _serve_connection(conn, self.handler, self._stop,
                                  state=self.state)

    def drain(self, timeout_s: float = 10.0) -> bool:
        return _drain(self, timeout_s)

    def resume(self):
        self.state.draining.clear()

    def start_background(self) -> "SimpleServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._sock.close()

    def __enter__(self) -> "SimpleServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class ThreadPoolServer:
    """TThreadPoolServer: fixed worker pool, one connection per worker.

    Accepted connections queue until a worker frees up; each worker runs the
    shared request loop against one handler, which must be thread-safe: a
    ``QuestionAnsweringHandler`` over any of the port's scorers is (``aot``
    replays its CUDA graphs one call at a time, under a lock), and so are
    ``ServingEngine`` and ``PipelineEngine``. Pass an ``AdmissionController`` to bound queueing and shed
    expired/unmeetable requests with MSG_SHED replies.
    """

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 num_workers: int = 8, admission=None, backlog: int = 128):
        self.handler = handler
        self.admission = admission
        if admission is not None and hasattr(handler, "row_service_s"):
            # Estimate waits from scorer-side service time, not request
            # sojourn (which would double-count queueing).
            admission.set_service_time_source(handler.row_service_s)
        if admission is not None:
            # The backlog drains through every replica of the handler at
            # once — without this hint the wait estimate models a serial
            # server and sheds deadline requests ~Nx too eagerly.
            admission.set_effective_parallelism(
                getattr(handler, "effective_parallelism", 1))
        self.num_workers = num_workers
        self.state = ServerState()
        self._sock = _make_listener(host, port, backlog)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._conns: "queue.Queue[Optional[socket.socket]]" = queue.Queue()
        self._accept_thread: Optional[threading.Thread] = None
        self._workers: list = []

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.put(conn)

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                conn = self._conns.get(timeout=0.2)
            except queue.Empty:
                continue
            if conn is None:
                break
            with conn:
                _serve_connection(conn, self.handler, self._stop,
                                  self.admission, self.state)

    def _start_workers(self):
        self._workers = [threading.Thread(target=self._worker_loop,
                                          daemon=True)
                         for _ in range(self.num_workers)]
        for w in self._workers:
            w.start()

    def serve_forever(self):
        """Run the accept loop in the calling thread (SimpleServer-style
        foreground mode); workers still run in the background."""
        self._start_workers()
        self._accept_loop()

    def start_background(self) -> "ThreadPoolServer":
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        self._start_workers()
        return self

    def stats(self) -> Dict[str, float]:
        s: Dict[str, float] = {"num_workers": float(self.num_workers)}
        if self.admission is not None:
            s.update(self.admission.stats())
        if hasattr(self.handler, "stats"):
            s.update(self.handler.stats())
        return s

    def drain(self, timeout_s: float = 10.0) -> bool:
        return _drain(self, timeout_s)

    def resume(self):
        """Re-open a drained server for traffic (rejoin without restart)."""
        self.state.draining.clear()

    def stop(self):
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        for _ in self._workers:
            self._conns.put(None)
        for w in self._workers:
            w.join(timeout=2.0)
        # Accepted-but-unserved connections would otherwise block their
        # clients in recv forever: close them so reads fail fast.
        while True:
            try:
                conn = self._conns.get_nowait()
            except queue.Empty:
                break
            if conn is not None:
                conn.close()
        self._sock.close()

    def __enter__(self) -> "ThreadPoolServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class Client:
    """Blocking single-connection client (the paper's single-thread client).

    Usable as a context manager; on ``ConnectionError`` (server restart, a
    worker dropping the connection) one transparent reconnect + resend is
    attempted per call, so load-generator worker loops survive server churn.
    A deadline request re-checks its remaining budget before the resend: a
    budget that expired while the connection was down raises ``ShedError``
    locally instead of burning a server slot on a request the server would
    only shed as expired — and a still-live request is re-encoded with the
    budget it has LEFT (the wire deadline is relative to send time, so
    resending the original frame would silently refresh it).

    ``ShedError`` replies (MSG_SHED back-pressure) are not retried by
    default — shedding is the server telling the caller to back off, and a
    blind resend would defeat it. ``retry_sheds`` grants a bounded retry
    budget per call with exponential backoff (``backoff_s`` doubling up to
    ``backoff_max_s``): the caller backs off as instructed, and once the
    budget is spent the ShedError still surfaces, so sustained overload
    remains visible instead of turning into a silent retry storm. Sheds
    retried across a client's life are counted in ``shed_retries``.

    Data-plane RPCs open a ``client.<method>`` span and stamp its context
    on the outgoing frame (wire v5 FLAG_TRACE), so the server's request
    span — and everything under it, across the process boundary — parents
    into the caller's trace. ``trace=False`` opts a client out (e.g. the
    fabric's control-plane probe connections, which would otherwise flood
    the span ring at probe frequency).

    Data-plane methods take either deadline form: the wire-native
    *relative* budget (``deadline_s``) or the serving stack's *absolute*
    perf-counter deadline (``deadline_abs``, converted to the remaining
    budget at send time) — so plan/engine code that threads one absolute
    deadline end to end can hand it straight to a socket transport.
    """

    #: plans thread absolute deadlines through this transport (see
    #: ``_budget_s``); advertised the same way the in-process handlers do.
    supports_deadline = True

    def __init__(self, address: Tuple[str, int], reconnect: bool = True,
                 retry_sheds: int = 0, backoff_s: float = 0.01,
                 backoff_max_s: float = 0.5, trace: bool = True):
        self.address = address
        self.reconnect = reconnect
        self.retry_sheds = retry_sheds
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.trace = trace
        self.shed_retries = 0
        self._endpoint = f"{address[0]}:{address[1]}"
        self._sock = self._connect()

    def _span(self, method: str):
        if not self.trace:
            return telemetry.NOOP_SPAN
        return telemetry.get_tracer().span(f"client.{method}",
                                           endpoint=self._endpoint)

    @staticmethod
    def _budget_s(deadline_s: Optional[float],
                  deadline_abs: Optional[float]) -> Optional[float]:
        """Collapse the two deadline forms to one relative send budget.
        An absolute deadline (perf_counter clock) converts to what is
        LEFT of it right now — clamped at 0 so an already-expired request
        sheds at the server boundary instead of riding a negative budget
        that decode would reject."""
        if deadline_abs is not None:
            remaining = max(deadline_abs - time.perf_counter(), 0.0)
            return (remaining if deadline_s is None
                    else min(deadline_s, remaining))
        return deadline_s

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _roundtrip(self, frame: bytes, decode=wire.decode_reply):
        self._sock.sendall(frame)
        t, payload = wire.read_frame(self._sock)
        if not t:
            raise ConnectionError("server closed connection")
        return decode(t, payload)

    def _rpc(self, make_frame, deadline_s: Optional[float],
             decode=wire.decode_reply):
        """One RPC with at most one transparent reconnect + resend.

        ``make_frame(budget_s)`` encodes the request with the given
        deadline budget, so the resend after a reconnect carries only the
        budget that REMAINS — and a request whose budget ran out while the
        connection was down sheds locally (``ShedError``) instead of being
        resent to a server that would score-then-shed it as expired.
        """
        t0 = time.perf_counter()
        try:
            return self._roundtrip(make_frame(deadline_s), decode)
        except (ConnectionError, OSError):
            if not self.reconnect:
                raise
            telemetry.get_registry().inc("client_reconnects")
            try:
                self._sock.close()
            except OSError:
                pass
            remaining = deadline_s
            if deadline_s is not None:
                remaining = deadline_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    telemetry.get_registry().inc("client_sheds_expired")
                    raise wire.ShedError(
                        f"{SHED_EXPIRED}: deadline budget "
                        f"{deadline_s * 1e3:.1f}ms spent during reconnect"
                    ) from None
            self._sock = self._connect()
            return self._roundtrip(make_frame(remaining), decode)

    def _rpc_with_retry(self, make_frame, deadline_s: Optional[float] = None,
                        decode=wire.decode_reply):
        attempt = 0
        while True:
            try:
                return self._rpc(make_frame, deadline_s, decode)
            except wire.ShedError:
                if attempt >= self.retry_sheds:
                    raise  # budget spent: overload surfaces to the caller
                time.sleep(min(self.backoff_s * (2 ** attempt),
                               self.backoff_max_s))
                attempt += 1
                self.shed_retries += 1
                telemetry.get_registry().inc("client_shed_retries")

    def get_score(self, question: str, answer: str,
                  deadline_s: Optional[float] = None,
                  deadline_abs: Optional[float] = None) -> float:
        budget = self._budget_s(deadline_s, deadline_abs)
        with self._span("get_score") as sp:
            return self._rpc_with_retry(
                lambda b: wire.encode_get_score(question, answer, b,
                                                trace=sp.context),
                budget)[0]

    def get_score_batch(self, pairs: Sequence[Tuple[str, str]],
                        deadline_s: Optional[float] = None,
                        deadline_abs: Optional[float] = None):
        budget = self._budget_s(deadline_s, deadline_abs)
        with self._span("get_score_batch") as sp:
            return self._rpc_with_retry(
                lambda b: wire.encode_get_score_batch(pairs, b,
                                                      trace=sp.context),
                budget)

    def rank(self, query: str, deadline_s: Optional[float] = None,
             deadline_abs: Optional[float] = None
             ) -> List[wire.RankedItem]:
        """v3 whole-pipeline ranking: one query in, one ranked
        (doc_id, sent_id, score) list out."""
        budget = self._budget_s(deadline_s, deadline_abs)
        with self._span("rank") as sp:
            out = self._rpc_with_retry(
                lambda b: wire.encode_rank(query, b, trace=sp.context),
                budget, wire.decode_reply_ranking)
        if not out:     # a misbehaving server must fail typed, not crash
            raise ValueError("ranking reply held no rankings for the query")
        return out[0]

    def rank_batch(self, queries: Sequence[str],
                   deadline_s: Optional[float] = None,
                   deadline_abs: Optional[float] = None
                   ) -> List[List[wire.RankedItem]]:
        """v3 whole-pipeline ranking for a query batch — ONE RPC for the
        whole batch instead of chunked per-pair scoring calls."""
        budget = self._budget_s(deadline_s, deadline_abs)
        with self._span("rank_batch") as sp:
            return self._rpc_with_retry(
                lambda b: wire.encode_rank_batch(queries, b,
                                                 trace=sp.context),
                budget, wire.decode_reply_ranking)

    def health(self, deadline_s: Optional[float] = None
               ) -> Dict[str, float]:
        """v4 health/readiness probe: queue depth, row_service_ms,
        inflight, draining (see ``wire.MSG_HEALTH``)."""
        return self._rpc_with_retry(lambda b: wire.encode_health(b),
                                    deadline_s, wire.decode_reply_health)

    def drain(self) -> Dict[str, float]:
        """Ask the server to drain gracefully (v4 MSG_DRAIN): it finishes
        in-flight work, sheds everything new, and acks with a health
        snapshot — poll ``health()`` until ``inflight`` hits zero."""
        return self._rpc_with_retry(lambda b: wire.encode_drain(b), None,
                                    wire.decode_reply_health)

    def version(self, deadline_s: Optional[float] = None) -> Tuple[str, str]:
        """Which registry version is the server serving? Returns
        (version_id or "unversioned", status)."""
        return self._rpc_with_retry(lambda b: wire.encode_version(b),
                                    deadline_s, wire.decode_reply_version)

    def swap(self, version: str, deadline_s: Optional[float] = None
             ) -> Tuple[str, str]:
        """Hot-swap the server to ``version`` ("latest", a registry id, or
        a unique prefix). Blocks until the server has reloaded the weights
        and rebuilt its plan; returns (active_version, "swapped"). A failed
        swap raises ``RuntimeError`` and leaves the old version serving."""
        return self._rpc_with_retry(lambda b: wire.encode_swap(version, b),
                                    deadline_s, wire.decode_reply_version)

    def stats(self, deadline_s: Optional[float] = None
              ) -> Tuple[Dict[str, float], List[wire.WireSpan]]:
        """v5 full telemetry pull (MSG_STATS): the server process's
        MetricsRegistry snapshot plus its recent finished spans — what the
        Fabric supervisor aggregates across workers."""
        return self._rpc_with_retry(lambda b: wire.encode_stats(b),
                                    deadline_s, wire.decode_reply_stats)

    def close(self):
        self._sock.close()
