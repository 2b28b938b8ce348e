"""The port's v5 wire codec against the JAX package's: every ``encode_*``
gives the same bytes for the same inputs, and every decoder treats the same
payload alike (the same result, or the same exception type and message) on
``tests/test_wire_edges.py``'s cases, on every proper prefix of a frame,
on hand-rolled v1-v5 headers and on random bytes drawn from a seed."""
import socket
import struct

import numpy as np
import pytest

from repro.core import wire as J
from repro_torch.core import wire as P

TRACE = (0x1122334455667788, 0x99AABBCCDDEEFF00)
SPANS = [(1, 2, 0, 1000.5, 42.25, 4242, "server.rank", "rows=80"),
         (1, 3, 2, 1001.0, 10.0, 4242, "scorer", ""),
         (2**64 - 1, 5, 3, -0.0, 1e-300, 0, "naïve ≠ span", "k=ü")]

#: (encoder, args, kwargs): every encoder, with and without the optional
#: deadline and trace flags, unicode, empty strings and empty batches.
ENCODE_CASES = [
    ("encode_get_score", ("what is foo", "foo is bar"), {}),
    ("encode_get_score", ("café ≠ caffé", "naïve answer"), {}),
    ("encode_get_score", ("", ""), {}),
    ("encode_get_score", ("q", "a"), {"deadline_s": 0.125}),
    ("encode_get_score", ("q", "a"), {"trace": TRACE}),
    ("encode_get_score", ("q", "a"), {"deadline_s": 0.5, "trace": TRACE}),
    ("encode_get_score", ("q", "a"), {"deadline_s": -1.0}),
    ("encode_get_score_batch", ([(f"q{i}", f"a{i} text") for i in range(5)],), {}),
    ("encode_get_score_batch", ([],), {}),
    ("encode_get_score_batch", ([("ü", "ß")],), {"deadline_s": 2.5, "trace": TRACE}),
    ("encode_rank", ("who wrote it",), {}),
    ("encode_rank", ("",), {"deadline_s": 0.25}),
    ("encode_rank", ("who?",), {"trace": TRACE}),
    ("encode_rank_batch", ([f"query {i}" for i in range(5)] + [""],), {"deadline_s": 1.5}),
    ("encode_rank_batch", ([],), {}),
    ("encode_rank_batch", (["a", "b"],), {"trace": TRACE}),
    ("encode_health", (), {}),
    ("encode_health", (0.5,), {}),
    ("encode_drain", (), {}),
    ("encode_drain", (0.25,), {}),
    ("encode_stats", (), {}),
    ("encode_stats", (0.75,), {}),
    ("encode_version", (), {}),
    ("encode_version", (0.5,), {}),
    ("encode_swap", ("v-0123abcd4567",), {}),
    ("encode_swap", ("latest",), {"deadline_s": 2.0}),
    ("encode_reply_version", ("v-abc", "swapped"), {}),
    ("encode_reply_version", ("unversioned",), {}),
    ("encode_reply_health", ({"queue_depth": 12.0, "row_service_ms": 1.5,
                              "inflight": 3.0, "draining": 0.0},), {}),
    ("encode_reply_health", ({},), {}),
    ("encode_reply_stats", ({"batcher_queue_wait_ms_count": 7.0,
                             "server_requests{type=rank}": 3.0}, SPANS), {}),
    ("encode_reply_stats", ({},), {}),
    ("encode_reply", ([0.5],), {}),
    ("encode_reply", ([0.1, 0.9, 0.3333],), {}),
    ("encode_reply", ([],), {}),
    ("encode_reply", ([float("inf"), -0.0, 1e-308],), {}),
    ("encode_reply_ranking", ([[(3, 0, 1.5), (7, 2, -0.25)], [], [(0, 0, 0.0)]],), {}),
    ("encode_reply_ranking", ([],), {}),
    ("encode_reply_ranking", ([[(-1, 2**31 - 1, 1e9)]],), {}),
    ("encode_error", ("kaboom: 42",), {}),
    ("encode_error", ("",), {}),
    ("encode_shed", ("queue_full",), {}),
    ("encode_shed", ("dräining",), {}),
]

#: every decoder, keyed by the frame types it takes
DECODERS = ["decode_request", "decode_request_ex", "decode_request_meta",
            "decode_rank_request", "decode_rank_request_meta",
            "decode_control_request", "decode_swap_request", "decode_reply",
            "decode_reply_ranking", "decode_reply_health", "decode_reply_stats",
            "decode_reply_version"]


def _outcome(fn, *args):
    """What a call does: ("ok", result) or ("raise", exception class name,
    message). The class name, so the two packages' ``ShedError``s compare
    equal."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return ("raise", type(e).__name__, str(e))


def _same(name, *args):
    want = _outcome(getattr(J, name), *args)
    got = _outcome(getattr(P, name), *args)
    assert got == want, (name, args)
    return got


def _frame_parts(frame: bytes):
    return frame[4], frame[5:]


# ------------------------------------------------------------- the frames --

def test_constants_and_the_codecs_names_are_the_jax_packages():
    for name in dir(J):
        if name.startswith(("MSG_", "FLAG_")) or name in ("VERSION", "MIN_VERSION",
                                                          "MAX_FRAME"):
            assert getattr(P, name) == getattr(J, name), name
    public = {n for n in dir(J) if n.startswith(("encode_", "decode_"))}
    assert public == {n for n in dir(P) if n.startswith(("encode_", "decode_"))}
    assert {c[0] for c in ENCODE_CASES} == {n for n in public if n.startswith("encode_")}
    assert set(DECODERS) == {n for n in public if n.startswith("decode_")}
    assert issubclass(P.ShedError, RuntimeError)


@pytest.mark.parametrize("case", ENCODE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ENCODE_CASES)])
def test_every_encoder_is_byte_equal_to_the_jax_packages(case):
    name, args, kwargs = case
    got = getattr(P, name)(*args, **kwargs)
    assert isinstance(got, bytes)
    assert got == getattr(J, name)(*args, **kwargs)


@pytest.mark.parametrize("case", ENCODE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ENCODE_CASES)])
def test_every_frame_decodes_alike_in_both_packages(case):
    """Each encoded frame through every decoder of both packages: the frame's
    own decoder returns the same values, the others fail alike."""
    name, args, kwargs = case
    t, payload = _frame_parts(getattr(P, name)(*args, **kwargs))
    outcomes = [_same(d, t, payload) for d in DECODERS]
    assert any(o[0] == "ok" or o[1] in ("ShedError", "RuntimeError") for o in outcomes)


@pytest.mark.parametrize("case", ENCODE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ENCODE_CASES)])
def test_fuzz_truncation_every_prefix_decodes_alike(case):
    """Every proper prefix of every frame through every decoder: the same
    result or the same typed error in both packages."""
    name, args, kwargs = case
    t, payload = _frame_parts(getattr(P, name)(*args, **kwargs))
    for cut in range(len(payload)):
        for d in DECODERS:
            out = _same(d, t, payload[:cut])
            if out[0] == "raise":
                assert out[1] in ("ValueError", "ShedError", "RuntimeError",
                                  "UnicodeDecodeError"), (d, cut, out)


def test_fuzz_random_payloads_decode_alike():
    """Random payloads, drawn from a seed, through every decoder and frame
    type of both packages: a decoder returns or raises ValueError (or the
    shed/error a MSG_SHED/MSG_ERROR frame carries), never a parser error."""
    rng = np.random.default_rng(21)
    types = sorted({getattr(J, n) for n in dir(J) if n.startswith("MSG_")}) + [0, 77]
    heads = [b"", bytes([J.VERSION, 0]), bytes([J.VERSION, 3]), bytes([1]),
             bytes([2, 1]), bytes([6, 0])]
    for _ in range(300):
        n = int(rng.integers(0, 48))
        head = heads[int(rng.integers(len(heads)))]
        payload = head + rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        t = int(rng.choice(types))
        for d in DECODERS:
            out = _same(d, t, payload)
            if out[0] == "raise":
                assert out[1] in ("ValueError", "ShedError", "RuntimeError",
                                  "UnicodeDecodeError"), (d, t, payload, out)


# ------------------------------------------------ v1-v5 headers, deadlines --

def _header(version: int, deadline_s=None, trace=None) -> bytes:
    if version == 1:
        return bytes([1])
    flags, tail = 0, b""
    if deadline_s is not None:
        flags |= J.FLAG_DEADLINE
        tail += struct.pack("<d", deadline_s)
    if trace is not None:
        flags |= J.FLAG_TRACE
        tail += struct.pack("<QQ", *trace)
    return bytes([version, flags]) + tail


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_hand_rolled_v1_to_v5_headers_decode_alike(version):
    heads = [_header(version)]
    if version > 1:
        heads.append(_header(version, deadline_s=0.5))
        heads.append(_header(version, trace=TRACE))
        heads.append(_header(version, deadline_s=0.25, trace=TRACE))
    for head in heads:
        pair = head + J._pack_str("old q") + J._pack_str("old a")
        assert P._pack_str("old q") == J._pack_str("old q")
        got = _same("decode_request_meta", J.MSG_GET_SCORE, pair)
        assert got[0] == "ok" and got[1][0] == [("old q", "old a")]
        rank = head + J._pack_str("old query")
        got = _same("decode_rank_request_meta", J.MSG_RANK, rank)
        assert got[0] == "ok" and got[1][0] == ["old query"]
        for t in (J.MSG_HEALTH, J.MSG_DRAIN, J.MSG_STATS, J.MSG_VERSION):
            _same("decode_control_request", t, head)
        _same("decode_swap_request", J.MSG_SWAP, head + J._pack_str("latest"))


def test_unsupported_and_empty_headers_fail_alike():
    for payload in (b"", bytes([J.VERSION]), bytes([J.VERSION + 1, 0]), bytes([0, 0]),
                    bytes([J.VERSION, J.FLAG_DEADLINE]) + b"\x00\x01",
                    bytes([J.VERSION, J.FLAG_TRACE]) + struct.pack("<Q", 1)):
        for d in ("decode_request_ex", "decode_rank_request_meta",
                  "decode_control_request"):
            t = J.MSG_RANK if "rank" in d else (J.MSG_HEALTH if "control" in d
                                                else J.MSG_GET_SCORE)
            out = _same(d, t, payload)
            assert out[0] == "raise" and out[1] == "ValueError"


# ---------------------------------- test_wire_edges.py's cases, both ways --

def test_hostile_lengths_and_counts_fail_alike():
    cases = [
        ("decode_request", J.MSG_GET_SCORE,
         bytes([J.VERSION, 0]) + struct.pack("<I", 1 << 20) + b"hi"),
        ("decode_request_ex", J.MSG_GET_SCORE_BATCH,
         bytes([J.VERSION, 0]) + struct.pack("<I", 0xFFFFFFFF)),
        ("decode_rank_request", J.MSG_RANK_BATCH,
         bytes([J.VERSION, 0]) + struct.pack("<I", 0xFFFFFFFF)),
        ("decode_reply_ranking", J.MSG_REPLY_RANKING, struct.pack("<I", 0xFFFFFFFF)),
        ("decode_reply_health", J.MSG_REPLY_HEALTH, struct.pack("<I", 1 << 30)),
        ("decode_reply_stats", J.MSG_REPLY_STATS, struct.pack("<I", 1 << 30)),
        ("decode_reply_stats", J.MSG_REPLY_STATS,
         struct.pack("<I", 0) + struct.pack("<I", 1 << 30)),
        ("decode_reply", J.MSG_REPLY_SCORES,
         struct.pack("<I", 4) + struct.pack("<d", 1.0)),
        ("decode_reply", J.MSG_REPLY_SCORE, b"\x00\x01"),
    ]
    for name, t, payload in cases:
        out = _same(name, t, payload)
        assert out[0] == "raise" and out[1] == "ValueError", (name, out)


def test_unknown_types_fail_alike():
    _, payload = _frame_parts(P.encode_get_score("q", "a"))
    cases = [("decode_request", 77, payload), ("decode_reply", 78, b"\x00" * 8),
             ("decode_rank_request", J.MSG_GET_SCORE, payload),
             ("decode_reply_ranking", J.MSG_REPLY_SCORE, b"\x00" * 8),
             ("decode_control_request", J.MSG_GET_SCORE, payload),
             ("decode_swap_request", J.MSG_GET_SCORE, payload),
             ("decode_reply_health", J.MSG_REPLY_SCORE, b"\x00" * 8),
             ("decode_reply_stats", J.MSG_REPLY_HEALTH, b"\x00" * 8),
             ("decode_reply_version", J.MSG_REPLY_SCORE, b"\x00" * 8)]
    for name, t, p in cases:
        out = _same(name, t, p)
        assert out[0] == "raise" and out[1] == "ValueError" and "unknown" in out[2]


@pytest.mark.parametrize("decoder", ["decode_reply", "decode_reply_ranking",
                                     "decode_reply_health", "decode_reply_stats",
                                     "decode_reply_version"])
def test_shed_and_error_frames_raise_alike(decoder):
    t, payload = _frame_parts(P.encode_shed("queue_full"))
    assert _same(decoder, t, payload) == ("raise", "ShedError",
                                          "request shed: queue_full")
    with pytest.raises(P.ShedError):
        getattr(P, decoder)(t, payload)
    t, payload = _frame_parts(P.encode_error("not a shed"))
    assert _same(decoder, t, payload) == ("raise", "RuntimeError",
                                          "server error: not a shed")


# ------------------------------------------------------ read_frame, sockets --

def _read_both(send: bytes, close: bool, timeout: float = 2.0):
    """read_frame of each package on a socket pair fed ``send``."""
    out = []
    for mod in (J, P):
        a, b = socket.socketpair()
        b.settimeout(timeout)
        try:
            a.sendall(send)
            if close:
                a.close()
            out.append(_outcome(mod.read_frame, b))
        finally:
            a.close()
            b.close()
    assert out[0] == out[1], out
    return out[1]


def test_read_frame_truncated_payload_and_header_fail_alike():
    frame = P.encode_get_score("question", "answer")
    out = _read_both(frame[:-3], close=True)
    assert out[:2] == ("raise", "ConnectionError") and "truncated" in out[2]
    out = _read_both(b"\x01\x02", close=True)
    assert out[:2] == ("raise", "ConnectionError") and "truncated" in out[2]


def test_read_frame_stall_eof_and_oversized_alike():
    frame = P.encode_get_score("question", "answer")
    out = _read_both(frame[:7], close=False, timeout=0.05)
    assert out[:2] == ("raise", "ConnectionError") and "stalled" in out[2]
    assert _read_both(b"", close=True) == ("ok", (0, b""))
    out = _read_both(struct.pack("<IB", J.MAX_FRAME + 1, J.MSG_GET_SCORE), close=False)
    assert out[:2] == ("raise", "ValueError") and "MAX_FRAME" in out[2]
    assert _read_both(frame, close=True) == ("ok", _frame_parts(frame))


def test_read_frame_idle_timeout_at_boundary_is_retryable():
    a, b = socket.socketpair()
    b.settimeout(0.05)
    try:
        with pytest.raises(socket.timeout):
            P.read_frame(b)        # nothing sent: the caller may retry
        a.sendall(J.encode_get_score("q", "a"))
        t, payload = P.read_frame(b)
        assert P.decode_request(t, payload) == [("q", "a")]
    finally:
        a.close()
        b.close()
