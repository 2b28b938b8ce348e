"""Compact binary wire protocol — the paper's Thrift IDL analogue.

IDL (mirrors Figure 2 of the paper; v3 grows it past pair scoring to
whole-pipeline ranking):

  service QuestionAnswering {
    double getScore(1: string question, 2: string answer)
    list<double> getScoreBatch(1: list<Pair> pairs)
    // v3: serve a composed multi-stage pipeline behind one RPC
    list<Ranked> rank(1: string query)
    list<list<Ranked>> rankBatch(1: list<string> queries)
  }

Frame: u32 payload_len | u8 msg_type | payload. Strings are u32-len-prefixed
UTF-8. Doubles are little-endian f64. Field ids are implicit in order (the
schema-evolution story is the header's version byte).

Version history:

  v1 — payload = u8 version | body
  v2 — payload = u8 version | u8 flags | [f64 deadline_s] | body
       FLAG_DEADLINE marks an optional per-request deadline budget in
       seconds (relative to send time, so no cross-host clock is assumed).
       Servers answering past-deadline or over-capacity requests reply with
       MSG_SHED instead of queueing unboundedly.
  v3 — same header as v2; adds ranking messages so one RPC serves a whole
       multi-stage cascade (query strings in, ranked lists out) instead of
       shipping every candidate pair over the wire:
         MSG_RANK           query:str                  -> MSG_REPLY_RANKING
         MSG_RANK_BATCH     u32 n | n x query:str      -> MSG_REPLY_RANKING
         MSG_REPLY_RANKING  u32 n_queries | per query: u32 n_items |
                            n_items x (i32 doc_id, i32 sent_id, f64 score)
       The deadline flag is preserved (identical header layout). v1/v2
       pair-scoring frames keep decoding on a v3 server; a v3 ranking
       request against a server whose handler only scores pairs gets a
       clean MSG_ERROR reply (see core.service dispatch).
  v4 — same header as v2/v3; adds the control-plane messages the
       multi-process serving fabric routes on (see serving.fabric):
         MSG_HEALTH        (header only)          -> MSG_REPLY_HEALTH
         MSG_DRAIN         (header only)          -> MSG_REPLY_HEALTH
         MSG_REPLY_HEALTH  u32 n | n x (key:str, f64 value)
       MSG_HEALTH is a readiness/load probe: the reply carries the
       server's queue depth, per-row service time, in-flight count, and
       draining flag, so a router can route least-loaded across process
       boundaries. MSG_DRAIN flips the server into graceful drain (new
       work is shed with MSG_SHED "draining", in-flight requests finish)
       and acks with the same health snapshot. v1-v3 frames keep
       decoding unchanged.
  v5 — adds distributed-tracing context and full metrics export
       (see serving.telemetry):
         FLAG_TRACE        header grows u64 trace_id | u64 span_id after
                           the optional deadline; a server opens its
                           request span as a CHILD of the caller's span,
                           so one trace tree crosses the process boundary.
         MSG_STATS         (header only)           -> MSG_REPLY_STATS
         MSG_REPLY_STATS   u32 n_metrics | n x (key:str, f64 value) |
                           u32 n_spans  | n x (u64 trace_id, u64 span_id,
                           u64 parent_id, f64 ts_us, f64 dur_us, u64 pid,
                           name:str, attrs:str)
       MSG_STATS returns the worker's full MetricsRegistry snapshot
       (same key/f64 layout as health, but everything: histograms
       flattened Prometheus-style) plus its recent finished spans, so a
       Fabric supervisor aggregates metrics and assembles cross-process
       span trees from every worker. v1-v4 clients still decode: the
       trace field sits behind FLAG_TRACE which old encoders never set,
       and old decoders reject unknown versions with a typed error as
       before.
  v5 + rollout — the live model-rollout control plane (see
       serving.rollout). The header byte stays 5: these are new frame
       TYPES, not a new header layout, so every v1-v5 frame keeps
       decoding bit-for-bit and an old server answers the new types with
       its usual MSG_ERROR for unknown messages:
         MSG_VERSION       (header only)            -> MSG_REPLY_VERSION
         MSG_SWAP          header | version:str     -> MSG_REPLY_VERSION
         MSG_REPLY_VERSION version:str | status:str
       MSG_VERSION asks which registry version a worker is serving;
       MSG_SWAP asks it to hot-swap to ``version`` ("latest" or a
       registry id) — the server reloads the weights, atomically replaces
       its plan/scorers, clears any graceful-drain state (the drained
       worker REJOINS on the new version), and acks with the now-active
       version. A failed swap answers MSG_ERROR and leaves the old
       version serving.

The PyTorch port's copy of the JAX package's codec: every frame is
byte-identical to the JAX package's, so a client of either package talks to
a server of the other.

Malformed input: every decoder raises ``ValueError`` with byte-offset
context on truncated or hostile payloads — never a bare ``IndexError`` or
``struct.error`` — so servers answer with a typed protocol error (MSG_ERROR)
and clients surface a diagnosable message instead of a parser traceback.
"""
from __future__ import annotations

import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple

VERSION = 5
MIN_VERSION = 1
FLAG_DEADLINE = 1
FLAG_TRACE = 2
MSG_GET_SCORE = 1
MSG_GET_SCORE_BATCH = 2
MSG_RANK = 3
MSG_RANK_BATCH = 4
MSG_HEALTH = 5
MSG_DRAIN = 6
MSG_STATS = 7
MSG_VERSION = 8
MSG_SWAP = 9
MSG_REPLY_SCORE = 101
MSG_REPLY_SCORES = 102
MSG_REPLY_RANKING = 103
MSG_REPLY_HEALTH = 104
MSG_REPLY_STATS = 105
MSG_REPLY_VERSION = 106
MSG_SHED = 254
MSG_ERROR = 255

#: v5 trace context as it crosses the wire: (trace_id, span_id), two u64s.
TraceContext = Tuple[int, int]

#: One finished span in MSG_REPLY_STATS wire form:
#: (trace_id, span_id, parent_id, ts_us, dur_us, pid, name, attrs).
WireSpan = Tuple[int, int, int, float, float, int, str, str]
_SPAN_FIXED_FMT = "<QQQddQ"
_SPAN_FIXED_SIZE = struct.calcsize(_SPAN_FIXED_FMT)  # 48 bytes

#: One ranked result: (doc_id, sent_id, score).
RankedItem = Tuple[int, int, float]
_RANKED_FMT = "<iid"
_RANKED_SIZE = struct.calcsize(_RANKED_FMT)  # 16 bytes

#: Upper bound on a frame payload; a corrupt or hostile length prefix must
#: not make the server try to buffer gigabytes.
MAX_FRAME = 1 << 24


class ShedError(RuntimeError):
    """Request rejected by admission control (MSG_SHED) — retriable."""


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _unpack_from(fmt: str, buf, off: int) -> tuple:
    """``struct.unpack_from`` that reports truncation as ``ValueError`` with
    byte-offset context instead of leaking ``struct.error``."""
    try:
        return struct.unpack_from(fmt, buf, off)
    except struct.error:
        raise ValueError(
            f"truncated payload: need {struct.calcsize(fmt)} bytes at "
            f"offset {off}, have {max(len(buf) - off, 0)}") from None


def _unpack_str(buf: memoryview, off: int) -> Tuple[str, int]:
    (n,) = _unpack_from("<I", buf, off)
    if off + 4 + n > len(buf):
        raise ValueError(f"truncated string: need {n} bytes at offset {off}")
    return bytes(buf[off + 4:off + 4 + n]).decode(), off + 4 + n


def _check_count(n: int, remaining: int, min_bytes: int, what: str) -> None:
    """A hostile element count must fail fast, not drive a 4-billion-round
    decode loop: every element needs at least ``min_bytes`` of payload."""
    if n * min_bytes > remaining:
        raise ValueError(f"{what} count {n} exceeds payload "
                         f"({remaining} bytes remaining)")


def _request_header(deadline_s: Optional[float],
                    trace: Optional[TraceContext] = None) -> bytes:
    flags = 0
    tail = b""
    if deadline_s is not None:
        flags |= FLAG_DEADLINE
        tail += struct.pack("<d", deadline_s)
    if trace is not None:
        flags |= FLAG_TRACE
        tail += struct.pack("<QQ", int(trace[0]), int(trace[1]))
    return bytes([VERSION, flags]) + tail


def _decode_header_ex(buf: memoryview
                      ) -> Tuple[Optional[float], Optional[TraceContext], int]:
    """Version/flags/deadline/trace prefix shared by every request decoder.
    Returns (deadline_s or None, trace context or None, body offset)."""
    if len(buf) == 0:
        raise ValueError("empty request payload (version byte missing at "
                         "offset 0)")
    ver = buf[0]
    if not MIN_VERSION <= ver <= VERSION:
        raise ValueError(f"wire version {ver} outside "
                         f"[{MIN_VERSION}, {VERSION}]")
    if ver == 1:
        return None, None, 1
    if len(buf) < 2:
        raise ValueError("truncated header: flags byte missing at offset 1")
    flags = buf[1]
    off = 2
    deadline_s: Optional[float] = None
    trace: Optional[TraceContext] = None
    if flags & FLAG_DEADLINE:
        (deadline_s,) = _unpack_from("<d", buf, off)
        off += 8
    if flags & FLAG_TRACE:
        trace_id, span_id = _unpack_from("<QQ", buf, off)
        trace = (trace_id, span_id)
        off += 16
    return deadline_s, trace, off


def _decode_header(buf: memoryview) -> Tuple[Optional[float], int]:
    """Pre-v5 view of the header: (deadline_s or None, body offset)."""
    deadline_s, _, off = _decode_header_ex(buf)
    return deadline_s, off


def encode_get_score(question: str, answer: str,
                     deadline_s: Optional[float] = None,
                     trace: Optional[TraceContext] = None) -> bytes:
    payload = (_request_header(deadline_s, trace)
               + _pack_str(question) + _pack_str(answer))
    return struct.pack("<IB", len(payload), MSG_GET_SCORE) + payload


def encode_get_score_batch(pairs: Sequence[Tuple[str, str]],
                           deadline_s: Optional[float] = None,
                           trace: Optional[TraceContext] = None) -> bytes:
    payload = (_request_header(deadline_s, trace)
               + struct.pack("<I", len(pairs)))
    for q, a in pairs:
        payload += _pack_str(q) + _pack_str(a)
    return struct.pack("<IB", len(payload), MSG_GET_SCORE_BATCH) + payload


def encode_rank(query: str, deadline_s: Optional[float] = None,
                trace: Optional[TraceContext] = None) -> bytes:
    payload = _request_header(deadline_s, trace) + _pack_str(query)
    return struct.pack("<IB", len(payload), MSG_RANK) + payload


def encode_rank_batch(queries: Sequence[str],
                      deadline_s: Optional[float] = None,
                      trace: Optional[TraceContext] = None) -> bytes:
    payload = (_request_header(deadline_s, trace)
               + struct.pack("<I", len(queries)))
    for q in queries:
        payload += _pack_str(q)
    return struct.pack("<IB", len(payload), MSG_RANK_BATCH) + payload


def encode_health(deadline_s: Optional[float] = None) -> bytes:
    """Health/readiness probe: header-only request, answered with
    MSG_REPLY_HEALTH (queue depth, row_service_ms, inflight, draining)."""
    payload = _request_header(deadline_s)
    return struct.pack("<IB", len(payload), MSG_HEALTH) + payload


def encode_drain(deadline_s: Optional[float] = None) -> bytes:
    """Graceful-drain control frame: the server stops admitting new work
    (MSG_SHED "draining"), finishes in-flight requests, and acks with a
    MSG_REPLY_HEALTH snapshot the drainer can poll to completion."""
    payload = _request_header(deadline_s)
    return struct.pack("<IB", len(payload), MSG_DRAIN) + payload


def encode_stats(deadline_s: Optional[float] = None) -> bytes:
    """Full telemetry pull: header-only request, answered with
    MSG_REPLY_STATS (the process's MetricsRegistry snapshot + recent
    finished spans)."""
    payload = _request_header(deadline_s)
    return struct.pack("<IB", len(payload), MSG_STATS) + payload


def encode_version(deadline_s: Optional[float] = None) -> bytes:
    """Model-version probe: header-only request, answered with
    MSG_REPLY_VERSION (the registry version id the server is serving)."""
    payload = _request_header(deadline_s)
    return struct.pack("<IB", len(payload), MSG_VERSION) + payload


def encode_swap(version: str, deadline_s: Optional[float] = None) -> bytes:
    """Hot-swap control frame: ask the server to reload ``version`` (a
    registry id, a unique prefix, or "latest") and rejoin serving on it.
    Success answers MSG_REPLY_VERSION with the now-active version; failure
    answers MSG_ERROR and leaves the previous version serving."""
    payload = _request_header(deadline_s) + _pack_str(version)
    return struct.pack("<IB", len(payload), MSG_SWAP) + payload


def decode_control_request(msg_type: int, payload: bytes) -> Optional[float]:
    """Decode a bodyless control frame (MSG_HEALTH / MSG_DRAIN / MSG_STATS /
    MSG_VERSION); returns the deadline_s or None."""
    if msg_type not in (MSG_HEALTH, MSG_DRAIN, MSG_STATS, MSG_VERSION):
        raise ValueError(f"unknown control msg type {msg_type}")
    return _decode_header(memoryview(payload))[0]


def decode_swap_request(msg_type: int, payload: bytes
                        ) -> Tuple[str, Optional[float]]:
    """Decode a MSG_SWAP frame into (target version, deadline_s or None)."""
    if msg_type != MSG_SWAP:
        raise ValueError(f"unknown swap msg type {msg_type}")
    buf = memoryview(payload)
    deadline_s, off = _decode_header(buf)
    version, _ = _unpack_str(buf, off)
    return version, deadline_s


def encode_reply_version(version: str, status: str = "active") -> bytes:
    """Version reply: version:str | status:str ("active" for a probe,
    "swapped" after a successful MSG_SWAP)."""
    payload = _pack_str(version) + _pack_str(status)
    return struct.pack("<IB", len(payload), MSG_REPLY_VERSION) + payload


def decode_reply_version(msg_type: int, payload: bytes) -> Tuple[str, str]:
    """Decode a MSG_REPLY_VERSION frame into (version, status); shed/error
    frames raise exactly like ``decode_reply``."""
    if msg_type == MSG_SHED:
        # repro-lint: allow[DL003] codec re-raises the server's shed; accounting happens at the decision site and the client retry loop
        raise ShedError(f"request shed: {_reply_text(payload)}")
    if msg_type == MSG_ERROR:
        raise RuntimeError(f"server error: {_reply_text(payload)}")
    if msg_type != MSG_REPLY_VERSION:
        raise ValueError(f"unknown version reply type {msg_type}")
    buf = memoryview(payload)
    version, off = _unpack_str(buf, 0)
    status, _ = _unpack_str(buf, off)
    return version, status


def encode_reply_health(stats: Dict[str, float]) -> bytes:
    """Health snapshot reply: u32 n | n x (key:str, f64 value)."""
    parts = [struct.pack("<I", len(stats))]
    for key, value in stats.items():
        parts.append(_pack_str(key))
        parts.append(struct.pack("<d", float(value)))
    payload = b"".join(parts)
    return struct.pack("<IB", len(payload), MSG_REPLY_HEALTH) + payload


def decode_reply_health(msg_type: int, payload: bytes) -> Dict[str, float]:
    """Decode a MSG_REPLY_HEALTH frame (shed/error frames raise exactly
    like ``decode_reply``)."""
    if msg_type == MSG_SHED:
        # repro-lint: allow[DL003] codec re-raises the server's shed; accounting happens at the decision site and the client retry loop
        raise ShedError(f"request shed: {_reply_text(payload)}")
    if msg_type == MSG_ERROR:
        raise RuntimeError(f"server error: {_reply_text(payload)}")
    if msg_type != MSG_REPLY_HEALTH:
        raise ValueError(f"unknown health reply type {msg_type}")
    buf = memoryview(payload)
    (n,) = _unpack_from("<I", buf, 0)
    off = 4
    # Every entry needs at least a 4-byte key length prefix + an 8-byte
    # value, so a hostile count fails fast.
    _check_count(n, len(buf) - off, 12, "health entry")
    out: Dict[str, float] = {}
    for _ in range(n):
        key, off = _unpack_str(buf, off)
        (value,) = _unpack_from("<d", buf, off)
        off += 8
        out[key] = value
    return out


def encode_reply_stats(metrics: Dict[str, float],
                       spans: Sequence[WireSpan] = ()) -> bytes:
    """Full telemetry reply: the registry snapshot (same key/f64 layout as
    health) followed by recent finished spans."""
    parts = [struct.pack("<I", len(metrics))]
    for key, value in metrics.items():
        parts.append(_pack_str(key))
        parts.append(struct.pack("<d", float(value)))
    parts.append(struct.pack("<I", len(spans)))
    for (trace_id, span_id, parent_id, ts_us, dur_us, pid,
         name, attrs) in spans:
        parts.append(struct.pack(_SPAN_FIXED_FMT, int(trace_id),
                                 int(span_id), int(parent_id), float(ts_us),
                                 float(dur_us), int(pid)))
        parts.append(_pack_str(name))
        parts.append(_pack_str(attrs))
    payload = b"".join(parts)
    return struct.pack("<IB", len(payload), MSG_REPLY_STATS) + payload


def decode_reply_stats(msg_type: int, payload: bytes
                       ) -> Tuple[Dict[str, float], List[WireSpan]]:
    """Decode a MSG_REPLY_STATS frame into (metrics snapshot, wire spans);
    shed/error frames raise exactly like ``decode_reply``."""
    if msg_type == MSG_SHED:
        # repro-lint: allow[DL003] codec re-raises the server's shed; accounting happens at the decision site and the client retry loop
        raise ShedError(f"request shed: {_reply_text(payload)}")
    if msg_type == MSG_ERROR:
        raise RuntimeError(f"server error: {_reply_text(payload)}")
    if msg_type != MSG_REPLY_STATS:
        raise ValueError(f"unknown stats reply type {msg_type}")
    buf = memoryview(payload)
    (n_metrics,) = _unpack_from("<I", buf, 0)
    off = 4
    _check_count(n_metrics, len(buf) - off, 12, "stats entry")
    metrics: Dict[str, float] = {}
    for _ in range(n_metrics):
        key, off = _unpack_str(buf, off)
        (value,) = _unpack_from("<d", buf, off)
        off += 8
        metrics[key] = value
    (n_spans,) = _unpack_from("<I", buf, off)
    off += 4
    # Fixed part + two (possibly empty) length-prefixed strings.
    _check_count(n_spans, len(buf) - off, _SPAN_FIXED_SIZE + 8, "span")
    spans: List[WireSpan] = []
    for _ in range(n_spans):
        fixed = _unpack_from(_SPAN_FIXED_FMT, buf, off)
        off += _SPAN_FIXED_SIZE
        name, off = _unpack_str(buf, off)
        attrs, off = _unpack_str(buf, off)
        spans.append(fixed + (name, attrs))
    return metrics, spans


def encode_reply(scores: Sequence[float]) -> bytes:
    if len(scores) == 1:
        payload = struct.pack("<d", scores[0])
        return struct.pack("<IB", len(payload), MSG_REPLY_SCORE) + payload
    payload = struct.pack("<I", len(scores)) + struct.pack(f"<{len(scores)}d", *scores)
    return struct.pack("<IB", len(payload), MSG_REPLY_SCORES) + payload


def encode_reply_ranking(
        rankings: Sequence[Sequence[RankedItem]]) -> bytes:
    """One ranked (doc_id, sent_id, score) list per query."""
    parts = [struct.pack("<I", len(rankings))]
    for items in rankings:
        parts.append(struct.pack("<I", len(items)))
        for doc_id, sent_id, score in items:
            parts.append(struct.pack(_RANKED_FMT, int(doc_id), int(sent_id),
                                     float(score)))
    payload = b"".join(parts)
    return struct.pack("<IB", len(payload), MSG_REPLY_RANKING) + payload


def encode_error(msg: str) -> bytes:
    payload = _pack_str(msg)
    return struct.pack("<IB", len(payload), MSG_ERROR) + payload


def encode_shed(reason: str) -> bytes:
    payload = _pack_str(reason)
    return struct.pack("<IB", len(payload), MSG_SHED) + payload


def read_frame(sock: socket.socket) -> Tuple[int, bytes]:
    head = _read_exact(sock, 5)  # a timeout HERE means genuinely idle
    if not head:
        return 0, b""
    n, t = _unpack_from("<IB", head, 0)
    if n > MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds MAX_FRAME {MAX_FRAME}")
    try:
        return t, _read_exact(sock, n)
    except socket.timeout:
        # Header consumed but payload never arrived: the stream is desynced
        # for any retry, so surface a connection-level failure.
        raise ConnectionError(
            f"stalled reading {n}-byte payload after header") from None


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            c = sock.recv(n - got)
        except socket.timeout:
            if not chunks:
                raise  # idle at a frame boundary: caller may retry cleanly
            # Mid-frame stall: partial bytes are already consumed, so
            # treating this as idle would desync the stream — the peer is
            # broken or pathologically slow; drop the connection instead.
            raise ConnectionError(
                f"stalled mid-frame: got {got} of {n} bytes") from None
        if not c:
            if not chunks:
                return b""
            raise ConnectionError(f"truncated frame: got {got} of {n} bytes")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def decode_request_meta(
        msg_type: int, payload: bytes
) -> Tuple[List[Tuple[str, str]], Optional[float], Optional[TraceContext]]:
    """Decode a pair-scoring request frame into (pairs, deadline_s or None,
    trace context or None)."""
    buf = memoryview(payload)
    deadline_s, trace, off = _decode_header_ex(buf)
    if msg_type == MSG_GET_SCORE:
        q, off = _unpack_str(buf, off)
        a, off = _unpack_str(buf, off)
        return [(q, a)], deadline_s, trace
    if msg_type == MSG_GET_SCORE_BATCH:
        (n,) = _unpack_from("<I", buf, off)
        off += 4
        _check_count(n, len(buf) - off, 8, "pair")
        pairs = []
        for _ in range(n):
            q, off = _unpack_str(buf, off)
            a, off = _unpack_str(buf, off)
            pairs.append((q, a))
        return pairs, deadline_s, trace
    raise ValueError(f"unknown msg type {msg_type}")


def decode_request_ex(msg_type: int, payload: bytes
                      ) -> Tuple[List[Tuple[str, str]], Optional[float]]:
    """Pre-v5 view: (pairs, deadline_s or None)."""
    pairs, deadline_s, _ = decode_request_meta(msg_type, payload)
    return pairs, deadline_s


def decode_request(msg_type: int, payload: bytes) -> List[Tuple[str, str]]:
    return decode_request_meta(msg_type, payload)[0]


def decode_rank_request_meta(
        msg_type: int, payload: bytes
) -> Tuple[List[str], Optional[float], Optional[TraceContext]]:
    """Decode a ranking request frame into (queries, deadline_s or None,
    trace context or None)."""
    buf = memoryview(payload)
    deadline_s, trace, off = _decode_header_ex(buf)
    if msg_type == MSG_RANK:
        q, off = _unpack_str(buf, off)
        return [q], deadline_s, trace
    if msg_type == MSG_RANK_BATCH:
        (n,) = _unpack_from("<I", buf, off)
        off += 4
        _check_count(n, len(buf) - off, 4, "query")
        queries = []
        for _ in range(n):
            q, off = _unpack_str(buf, off)
            queries.append(q)
        return queries, deadline_s, trace
    raise ValueError(f"unknown ranking msg type {msg_type}")


def decode_rank_request(msg_type: int, payload: bytes
                        ) -> Tuple[List[str], Optional[float]]:
    """Pre-v5 view: (queries, deadline_s or None)."""
    queries, deadline_s, _ = decode_rank_request_meta(msg_type, payload)
    return queries, deadline_s


def _reply_text(payload: bytes) -> str:
    return _unpack_str(memoryview(payload), 0)[0]


def decode_reply(msg_type: int, payload: bytes) -> List[float]:
    if msg_type == MSG_REPLY_SCORE:
        return [_unpack_from("<d", payload, 0)[0]]
    if msg_type == MSG_REPLY_SCORES:
        buf = memoryview(payload)
        (n,) = _unpack_from("<I", buf, 0)
        _check_count(n, len(buf) - 4, 8, "score")
        return list(_unpack_from(f"<{n}d", buf, 4))
    if msg_type == MSG_SHED:
        # repro-lint: allow[DL003] codec re-raises the server's shed; accounting happens at the decision site and the client retry loop
        raise ShedError(f"request shed: {_reply_text(payload)}")
    if msg_type == MSG_ERROR:
        raise RuntimeError(f"server error: {_reply_text(payload)}")
    raise ValueError(f"unknown reply type {msg_type}")


def decode_reply_ranking(msg_type: int, payload: bytes
                         ) -> List[List[RankedItem]]:
    """Decode a MSG_REPLY_RANKING frame (shed/error frames raise exactly
    like ``decode_reply``)."""
    if msg_type == MSG_SHED:
        # repro-lint: allow[DL003] codec re-raises the server's shed; accounting happens at the decision site and the client retry loop
        raise ShedError(f"request shed: {_reply_text(payload)}")
    if msg_type == MSG_ERROR:
        raise RuntimeError(f"server error: {_reply_text(payload)}")
    if msg_type != MSG_REPLY_RANKING:
        raise ValueError(f"unknown ranking reply type {msg_type}")
    buf = memoryview(payload)
    (n_queries,) = _unpack_from("<I", buf, 0)
    off = 4
    _check_count(n_queries, len(buf) - off, 4, "ranking")
    out: List[List[RankedItem]] = []
    for _ in range(n_queries):
        (n_items,) = _unpack_from("<I", buf, off)
        off += 4
        _check_count(n_items, len(buf) - off, _RANKED_SIZE, "ranked item")
        items: List[RankedItem] = []
        for _ in range(n_items):
            doc_id, sent_id, score = _unpack_from(_RANKED_FMT, buf, off)
            off += _RANKED_SIZE
            items.append((doc_id, sent_id, score))
        out.append(items)
    return out
