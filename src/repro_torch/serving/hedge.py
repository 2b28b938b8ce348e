"""Hedged RPC dispatch — the tail-tolerance technique from Dean & Barroso,
"The Tail at Scale" (CACM 2013).

``HedgedTransport`` fronts N interchangeable endpoints (socket
``service.Client``s, in-process handlers, ``ReplicaPool`` replicas — anything
exposing the same scoring/ranking methods). A request goes to a primary
endpoint chosen round-robin; if no answer arrives within the hedge delay,
the same request fires at the next endpoint and the first answer wins.

The hedge delay defaults to the p95 of recently observed call latencies
(clamped to ``min_hedge_s``), so only the slowest ~5% of requests pay a
duplicate RPC — the classic operating point. A fixed delay can be forced
with ``hedge_s`` (``float("inf")`` disables hedging entirely, which makes
the unhedged baseline in benchmarks share this exact code path).

Loser draining: each endpoint is guarded by its own lock, and the losing
attempt keeps running on its own connection until its reply is fully read,
then discards it. The framed stream therefore never desyncs — a request
routed to a still-draining endpoint simply waits on the lock (at worst it
hedges away again). Nothing is cancelled mid-frame.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock

from repro_torch.serving import telemetry
from repro_torch.serving.stats import LatencyTracker


class HedgedTransport:
    """Race two replicas per slow request; first answer wins.

    Error semantics: a failed primary (exception, including ``ShedError``)
    triggers an immediate hedge instead of waiting out the delay; the call
    only raises once every attempted endpoint has failed (the primary's
    error is re-raised). A success always wins over a concurrent failure.
    """

    def __init__(self, transports: Sequence, hedge_s: Optional[float] = None,
                 min_hedge_s: float = 0.001, default_hedge_s: float = 0.05,
                 min_samples: int = 16):
        if not transports:
            raise ValueError("HedgedTransport needs at least one endpoint")
        self._transports = list(transports)
        self._locks = [Lock() for _ in self._transports]
        self._hedge_s = hedge_s
        self._min_hedge_s = min_hedge_s
        self._default_hedge_s = default_hedge_s
        self._min_samples = min_samples
        self.tracker = LatencyTracker()
        self._meta = Lock()
        self._rr = 0
        self._requests = 0
        self._hedged = 0
        self._hedge_wins = 0
        self._observed = 0

    # ------------------------------------------------------------ delay --

    def hedge_delay_s(self) -> float:
        """Current hedge delay: fixed if configured, else adaptive p95 of
        completed-call latency (the default until enough samples exist)."""
        if self._hedge_s is not None:
            return self._hedge_s
        with self._meta:
            enough = self._observed >= self._min_samples
        if not enough:
            return self._default_hedge_s
        return max(self.tracker.percentile(0.95), self._min_hedge_s)

    # --------------------------------------------------------- dispatch --

    def _attempt(self, idx: int, method: str, args: tuple,
                 results: "queue.Queue", parent=None,
                 role: str = "primary") -> None:
        lock = self._locks[idx]
        tracer = telemetry.get_tracer()
        with lock:
            t0 = time.perf_counter()
            # Attempts run in fresh daemon threads, so the caller's span
            # context is handed over explicitly: the attempt span — and the
            # client span it wraps — joins the request's trace tree.
            with tracer.activate(parent):
                with tracer.span(f"hedge.{role}", endpoint=idx,
                                 method=method) as sp:
                    try:
                        # The RPC stays under the endpoint lock by design:
                        # a losing attempt keeps the framed stream to
                        # itself until its reply is fully read (see module
                        # docstring) — the lock IS the drain barrier.
                        # repro-lint: allow[LOCK001] loser draining holds the endpoint lock across the RPC by design: the framed stream must stay serialized until the losing reply is fully read, so the lock is the drain barrier (see hedge.py module docstring)
                        val = getattr(self._transports[idx], method)(*args)
                    except Exception as e:  # noqa: BLE001 — raced, judged
                        sp.set_attr("error", type(e).__name__)
                        results.put((idx, e, None))
                        return
            dt = time.perf_counter() - t0
        # Bookkeeping runs after the endpoint lock is released: the tracker
        # and meta locks are only ever taken bare, never nested inside an
        # endpoint lock, so a draining loser cannot stall stats readers.
        self.tracker.observe(dt)
        with self._meta:
            self._observed += 1
        results.put((idx, None, val))

    def _pick_endpoints(self) -> "tuple":
        """Choose ``(primary, backup)`` endpoint indices for one request;
        ``backup is None`` means there is nothing to hedge to. The base
        policy is round-robin skewed away from busy endpoints: one whose
        lock is currently held (a request in flight, or a losing attempt
        still draining its reply) is only chosen when every endpoint is
        busy — a fresh request should not queue behind a drain it could
        simply avoid. Subclasses route on live signals instead
        (``fabric.HealthRouter`` picks the least-loaded healthy workers
        from MSG_HEALTH probes)."""
        n = len(self._transports)
        with self._meta:
            start = self._rr % n
            self._rr += 1
        order = [(start + i) % n for i in range(n)]
        free = [i for i in order if not self._locks[i].locked()]
        busy = [i for i in order if i not in free]
        ranked = free + busy
        return ranked[0], (ranked[1] if n > 1 else None)

    def _call(self, method: str, args: tuple):
        primary, backup = self._pick_endpoints()
        registry = telemetry.get_registry()
        registry.inc("hedge_requests")
        with self._meta:
            self._requests += 1
        # Captured here, replayed inside each attempt thread (thread-local
        # span context does not cross thread starts).
        parent = telemetry.get_tracer().current_context()
        results: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._attempt,
                         args=(primary, method, args, results, parent),
                         daemon=True).start()
        delay = self.hedge_delay_s()
        first = None
        if backup is None or not math.isfinite(delay):
            first = results.get()           # hedging disabled: just wait
        else:
            try:
                first = results.get(timeout=delay)
            except queue.Empty:
                first = None                # primary is slow: hedge
        if first is not None and first[1] is None:
            return first[2]
        if backup is None:
            raise first[1]
        # Hedge: fire the same request at the backup endpoint. The primary
        # attempt keeps draining its reply in the background; whichever
        # answers first (successfully) wins.
        registry.inc("hedge_hedged")
        with self._meta:
            self._hedged += 1
        threading.Thread(target=self._attempt,
                         args=(backup, method, args, results, parent,
                               "hedge"),
                         daemon=True).start()
        outcomes = [first] if first is not None else []
        while True:
            got = results.get()
            outcomes.append(got)
            if got[1] is None:
                if got[0] == backup:
                    telemetry.get_registry().inc("hedge_wins")
                    with self._meta:
                        self._hedge_wins += 1
                return got[2]
            if len(outcomes) == 2:          # both attempts failed
                errs = {idx: err for idx, err, _ in outcomes}
                raise errs.get(primary, got[1])

    # --------------------------------------------------------- protocol --

    def get_score_batch(self, pairs) -> List[float]:
        return self._call("get_score_batch", (list(pairs),))

    def rank(self, query: str):
        return self._call("rank", (query,))

    def rank_batch(self, queries: Sequence[str]):
        return self._call("rank_batch", (list(queries),))

    def stats(self) -> Dict[str, float]:
        with self._meta:
            s = {
                "hedge_requests": float(self._requests),
                "hedged": float(self._hedged),
                "hedge_wins": float(self._hedge_wins),
            }
        s["hedge_delay_ms"] = (self.hedge_delay_s() * 1e3
                               if math.isfinite(self.hedge_delay_s())
                               else -1.0)
        s["p95_ms"] = self.tracker.percentile(0.95) * 1e3
        return s

    def close(self) -> None:
        """Close owned endpoints that have a ``close`` (socket clients);
        waits on each endpoint lock so a draining loser finishes first."""
        for lock, t in zip(self._locks, self._transports):
            with lock:
                close = getattr(t, "close", None)
                if close is not None:
                    try:
                        close()
                    except OSError:
                        pass

    def __enter__(self) -> "HedgedTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
