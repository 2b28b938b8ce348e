"""Micro-batching request queue for the reranking service.

The paper's TSimpleServer scores one request at a time; a production
deployment amortizes dispatch by coalescing concurrent requests into
bucketed batches (Table 1 shows 8-30x per-pair speedup at batch 64). This
batcher implements the standard policy: collect up to ``max_batch`` rows
or wait at most ``max_wait_s``, pad to the scorer's bucket, scatter results
back to per-request futures.

Two submission granularities share one queue and one worker:

  submit       — a single (q_tok, a_tok, feats) row    -> Future[float]
  submit_many  — a whole (n, ...) sub-batch, e.g. every rerank pair of one
                 pipeline query batch                  -> Future[np.ndarray]

Sub-batches stay contiguous in the coalesced scorer call and resolve with
one future, so a batched pipeline pays one enqueue + one wakeup per query
batch instead of one per candidate pair.

Deadline propagation: ``submit``/``submit_many`` accept an absolute
``deadline_abs`` (``time.perf_counter`` clock). Admission control sheds
requests whose deadline can't be met *before* they enqueue, but a request
admitted with budget to spare can still expire while it waits behind a slow
batch — those items are dropped at dequeue (their future raises
``wire.ShedError("expired")``, which servers translate to a MSG_SHED reply)
instead of wasting scorer time on an answer nobody is waiting for.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock

import numpy as np

from repro_torch.core.wire import ShedError
from repro_torch.serving import telemetry
from repro_torch.serving.admission import SHED_EXPIRED


class _Item:
    """One queue entry: ``n`` rows scored together, one future.

    ``single`` marks a scalar ``submit`` (future resolves to float);
    otherwise the future resolves to the (n,) score array.
    ``deadline_abs`` (perf_counter clock) marks when the caller stops
    caring; ``None`` never expires. ``trace`` is the submitter's span
    context captured at enqueue — the batch loop runs in its own thread, so
    thread-local propagation stops here and the item carries its trace
    explicitly; ``t_enq`` anchors the queue-wait measurement."""

    __slots__ = ("q_tok", "a_tok", "feats", "n", "single", "future",
                 "deadline_abs", "trace", "t_enq")

    def __init__(self, q_tok, a_tok, feats, single: bool,
                 deadline_abs: Optional[float] = None):
        q_tok, a_tok = np.asarray(q_tok), np.asarray(a_tok)
        feats = np.asarray(feats)
        if single:
            q_tok, a_tok, feats = q_tok[None], a_tok[None], feats[None]
        self.q_tok = q_tok
        self.a_tok = a_tok
        self.feats = feats
        self.n = q_tok.shape[0]
        self.single = single
        self.deadline_abs = deadline_abs
        self.trace = telemetry.get_tracer().current_context()
        self.t_enq = time.perf_counter()
        self.future: Future = Future()


class MicroBatcher:
    """Coalesce get_score requests into scorer batches on a worker thread."""

    def __init__(self, scorer, max_batch: int = 64, max_wait_s: float = 0.002):
        self.scorer = scorer
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._lock = Lock()
        self._outstanding_rows = 0
        self._rows_scored = 0
        self._rows_shed = 0
        self._row_scorer_s: Optional[float] = None
        self._n_batches = 0   # monotonic, all-time (stats "batches")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._thread.start()
        # Sliding window: bounds memory over a long-running server's life.
        # Only "mean_batch" is derived from it; the batch COUNT is the
        # monotonic _n_batches counter, so it doesn't plateau at maxlen.
        self.batch_sizes: "deque[int]" = deque(maxlen=4096)

    @property
    def outstanding_rows(self) -> int:
        """Rows enqueued or in flight — the load-balancing signal."""
        with self._lock:
            return self._outstanding_rows

    @property
    def row_scorer_s(self) -> Optional[float]:
        """EWMA of pure scorer time per row (no queue wait) — the service
        time admission control should estimate waits from. None until the
        first batch completes."""
        with self._lock:
            return self._row_scorer_s

    def _enqueue(self, item: "_Item") -> "Future":
        # The running check and the put must be one atomic step: otherwise
        # an item slipped in after stop()'s drain would never resolve.
        with self._lock:
            if not self._running:
                item.future.set_exception(RuntimeError("MicroBatcher "
                                                       "stopped"))
                return item.future
            self._outstanding_rows += item.n
            self._q.put(item)
        # Registered OUTSIDE the lock: a Future that is already done runs
        # callbacks synchronously on the registering thread, and _settle
        # re-takes the non-reentrant lock — under the lock this is a
        # self-deadlock whenever the batch loop beats us to the future.
        item.future.add_done_callback(lambda _f, n=item.n: self._settle(n))
        return item.future

    def _settle(self, n: int):
        # Runs on failure too (set_exception), so only the outstanding
        # count settles here; rows_scored counts successes in _loop.
        with self._lock:
            self._outstanding_rows -= n

    def submit(self, q_tok: np.ndarray, a_tok: np.ndarray,
               feats: np.ndarray,
               deadline_abs: Optional[float] = None) -> "Future[float]":
        return self._enqueue(_Item(q_tok, a_tok, feats, single=True,
                                   deadline_abs=deadline_abs))

    def submit_many(self, q_tok: np.ndarray, a_tok: np.ndarray,
                    feats: np.ndarray,
                    deadline_abs: Optional[float] = None
                    ) -> "Future[np.ndarray]":
        """Enqueue an (n, ...) sub-batch; the future resolves to all n scores
        at once (empty sub-batches resolve immediately)."""
        item = _Item(q_tok, a_tok, feats, single=False,
                     deadline_abs=deadline_abs)
        if item.n == 0:
            item.future.set_result(np.zeros((0,), np.float32))
            return item.future
        return self._enqueue(item)

    def score(self, q_tok, a_tok, feats) -> float:
        return self.submit(q_tok, a_tok, feats).result()

    def _drain(self) -> List[_Item]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        items, rows = [first], first.n
        deadline = self.max_wait_s
        t0 = time.perf_counter()
        while rows < self.max_batch:
            remaining = deadline - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
            rows += nxt.n
        return items

    def _expire(self, items: List[_Item]) -> List[_Item]:
        """Drop already-expired items at dequeue: their budget burned away
        in the queue, so scoring them would only delay the live ones."""
        now = time.perf_counter()
        live = []
        for i in items:
            if i.deadline_abs is not None and now >= i.deadline_abs:
                with self._lock:
                    self._rows_shed += i.n
                telemetry.get_registry().inc("batcher_rows_expired", i.n)
                i.future.set_exception(ShedError(SHED_EXPIRED))
            else:
                live.append(i)
        return live

    def _loop(self):
        tracer = telemetry.get_tracer()
        registry = telemetry.get_registry()
        while self._running:
            items = self._expire(self._drain())
            if not items:
                continue
            try:
                q = np.concatenate([i.q_tok for i in items])
                a = np.concatenate([i.a_tok for i in items])
                f = np.concatenate([i.feats for i in items])
                t_deq = time.perf_counter()
                for i in items:
                    # The queue-wait vs compute split, per item: how long
                    # the rows sat coalescing vs how long the scorer ran.
                    registry.observe("batcher_queue_wait_ms",
                                     (t_deq - i.t_enq) * 1e3)
                    if i.trace is not None:
                        tracer.record("batcher.queue_wait", i.t_enq, t_deq,
                                      parent=i.trace, rows=i.n)
                t0 = time.perf_counter()
                # Adopt the first traced item's context for the scorer call
                # so kernel-side spans (Scorer buckets) attach to a real
                # request tree — the batch is shared, so one tree hosts it.
                batch_trace = next((i.trace for i in items
                                    if i.trace is not None), None)
                with tracer.activate(batch_trace):
                    scores = np.asarray(self.scorer(q, a, f))
                t1 = time.perf_counter()
                registry.observe("batcher_compute_ms", (t1 - t0) * 1e3)
                registry.observe("batcher_batch_rows", float(q.shape[0]),
                                 buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
                for i in items:
                    if i.trace is not None:
                        tracer.record("batcher.compute", t0, t1,
                                      parent=i.trace, rows=i.n,
                                      batch=int(q.shape[0]))
                per_row = (t1 - t0) / q.shape[0]
                with self._lock:
                    self._row_scorer_s = (
                        per_row if self._row_scorer_s is None
                        else self._row_scorer_s
                        + 0.2 * (per_row - self._row_scorer_s))
                    self._rows_scored += int(q.shape[0])
                    self._n_batches += 1
                    self.batch_sizes.append(int(q.shape[0]))
                offset = 0
                for i in items:
                    seg = scores[offset:offset + i.n]
                    offset += i.n
                    i.future.set_result(float(seg[0]) if i.single
                                        else np.asarray(seg))
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for i in items:
                    if not i.future.done():
                        i.future.set_exception(e)

    def stats(self) -> dict:
        with self._lock:
            rows, out = self._rows_scored, self._outstanding_rows
            shed, batches = self._rows_shed, self._n_batches
            sizes = list(self.batch_sizes)  # snapshot: worker appends
        return {
            "rows_scored": float(rows),
            "rows_shed": float(shed),
            "outstanding_rows": float(out),
            # All-time count; "mean_batch" stays a sliding-window mean over
            # the most recent maxlen batches (recent behavior, bounded
            # memory) — the two deliberately cover different horizons.
            "batches": float(batches),
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
        }

    def stop(self):
        with self._lock:  # after this, _enqueue fails fast — see above
            self._running = False
        self._q.put(None)
        self._thread.join(timeout=2.0)
        # Fail any items the worker never reached: leaving their futures
        # unresolved would hang callers blocked in .result() forever.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("MicroBatcher "
                                                       "stopped"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
