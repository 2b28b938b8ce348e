"""Deadline-aware admission control for the serving cluster.

Four shed conditions, checked in order at the RPC boundary (before any
featurization or scorer work is spent on the request):

  expired     — the client's deadline already passed while the request sat
                in the kernel/server queues; scoring it would waste a slot
                on an answer nobody is waiting for.
  too_large   — the request ALONE exceeds ``max_queue_rows``: permanent,
                reported as a hard error (retrying can never help).
  queue_full  — admitting the request would push the cluster-wide
                outstanding row count past ``max_queue_rows``; bounding the
                queue bounds p99 under overload (shed fast, don't buffer).
  late        — the per-row service-time estimate predicts the request
                would complete after its deadline even if admitted now.
                The estimate prefers a scorer-side source (see
                ``set_service_time_source`` / ``ReplicaPool.row_service_s``
                — pure compute time, no queue wait); the fallback is an
                EWMA of observed request sojourn, which is conservative
                under load (it includes queueing, which the wait formula
                also models).

The drain estimate models the backlog emptying through
``effective_parallelism`` servers at once (replicas in a pool, worker
processes in a fabric): ``(outstanding + n) * per_row /
effective_parallelism``. Modelling it serially overestimates the wait by
~Nx on an N-replica deployment and sheds requests as ``late`` that would
comfortably meet their deadline — servers wire the hint from the handler
(``ReplicaPool.effective_parallelism``) next to the service-time source.

The fallback EWMA is kept PER ROW-COUNT BUCKET (``SERVICE_BUCKETS``
edges), not as one global average: per-row cost falls steeply with batch
size (fixed dispatch overhead amortizes across a 64-row batch), so under
mixed traffic a stream of cheap batch-64 rows would deflate a single
EWMA and make the controller admit batch-1 requests whose real per-row
cost is an order of magnitude higher — then miss their deadlines anyway.
The wait estimate prices a request at ITS OWN bucket's rate (the backlog
is approximated at the same rate; a scorer-side source, when installed,
still wins over every bucket).

``try_admit`` returns ``None`` and takes an outstanding-rows reservation on
admission, or the shed reason string; every admitted request must be paired
with exactly one ``release`` (use try/finally) which also feeds the service
time estimate. All state is behind one lock — the controller is shared by
every server worker thread.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock

from repro_torch.serving import telemetry

SHED_EXPIRED = "expired"
SHED_QUEUE_FULL = "queue_full"
SHED_LATE = "late"
#: Permanent rejection (not back-pressure): the request alone exceeds
#: max_queue_rows, so no amount of client backoff would ever admit it.
#: Servers should answer with a hard error, not a retriable MSG_SHED.
SHED_TOO_LARGE = "too_large"
#: The server is gracefully draining (wire MSG_DRAIN): it finishes its
#: in-flight work but admits nothing new. Routers treat this as
#: "unroutable", clients as retriable back-pressure (another replica will
#: answer).
SHED_DRAINING = "draining"

#: Row-count bucket edges for the per-bucket service-time EWMAs: a request
#: with n rows lands in the first bucket with n <= edge (inf = overflow).
#: Edges mirror the scorer bucket ladder so "batch-1" and "batch-64"
#: traffic — whose per-row costs differ by the amortized dispatch
#: overhead — never share an estimate.
SERVICE_BUCKETS = (1.0, 8.0, 64.0, float("inf"))


def _bucket_of(n_rows: int) -> float:
    for edge in SERVICE_BUCKETS:
        if n_rows <= edge:
            return edge
    return SERVICE_BUCKETS[-1]


class AdmissionController:
    def __init__(self, max_queue_rows: int = 1024,
                 ewma_alpha: float = 0.1,
                 init_row_service_s: float = 1e-3,
                 service_time_source: Optional[Callable[[],
                                               Optional[float]]] = None,
                 effective_parallelism: int = 1):
        self.max_queue_rows = max_queue_rows
        self._alpha = ewma_alpha
        self._row_service_s = init_row_service_s
        #: Per-bucket EWMAs, populated lazily from releases; a bucket with
        #: no observations falls back to the global EWMA.
        self._bucket_service_s: Dict[float, float] = {}
        self._service_source = service_time_source
        self._parallelism = max(int(effective_parallelism), 1)
        self._outstanding_rows = 0
        self._admitted = 0
        self._shed: Dict[str, int] = {SHED_EXPIRED: 0, SHED_QUEUE_FULL: 0,
                                      SHED_LATE: 0, SHED_TOO_LARGE: 0}
        self._lock = Lock()

    def set_service_time_source(self, source: Callable[[],
                                                       Optional[float]]):
        """Install a scorer-side per-row service-time estimate (e.g.
        ``ReplicaPool.row_service_s``). Preferred over the internal request
        EWMA, which measures sojourn (queue wait + service) and so would
        double-count queueing in the wait estimate under load."""
        self._service_source = source

    def set_effective_parallelism(self, n: int):
        """How many servers drain the backlog concurrently (replicas in a
        pool, worker processes behind a fabric router). The wait estimate
        divides by this: a 4-replica pool drains a 400-row backlog ~4x
        faster than one server, and modelling it serially sheds requests
        as ``late`` that would easily meet their deadline."""
        with self._lock:
            self._parallelism = max(int(n), 1)

    def _per_row_s(self, n_rows: Optional[int] = None) -> float:
        if self._service_source is not None:
            est = self._service_source()
            if est is not None:
                return est
        if n_rows is not None:
            est = self._bucket_service_s.get(_bucket_of(n_rows))
            if est is not None:
                return est
        return self._row_service_s

    def _estimated_wait_locked(self, n_rows: int) -> float:
        # Priced at the REQUEST's bucket rate: a batch-1 arrival is judged
        # by observed batch-1 per-row cost even when the recent traffic
        # was cheap batch-64 rows (see module docstring).
        return ((self._outstanding_rows + n_rows) * self._per_row_s(n_rows)
                / self._parallelism)

    def estimated_wait_s(self, n_rows: int) -> float:
        """Predicted completion time for ``n_rows`` more rows: outstanding
        backlog + the new rows, drained at the per-row service-time
        estimate through ``effective_parallelism`` concurrent servers."""
        with self._lock:
            return self._estimated_wait_locked(n_rows)

    def try_admit(self, n_rows: int,
                  deadline_abs: Optional[float] = None,
                  now: Optional[float] = None) -> Optional[str]:
        """Admit (reserve rows, return None) or return a shed reason.
        Every decision is mirrored into the process registry
        (``admission_decisions{outcome=...}``) so MSG_STATS exports the
        accept/shed split without touching this controller's lock."""
        now = time.perf_counter() if now is None else now
        reason: Optional[str] = None
        with self._lock:
            if deadline_abs is not None and now >= deadline_abs:
                self._shed[SHED_EXPIRED] += 1
                reason = SHED_EXPIRED
            elif n_rows > self.max_queue_rows:
                self._shed[SHED_TOO_LARGE] += 1
                reason = SHED_TOO_LARGE
            elif self._outstanding_rows + n_rows > self.max_queue_rows:
                self._shed[SHED_QUEUE_FULL] += 1
                reason = SHED_QUEUE_FULL
            elif deadline_abs is not None:
                est = self._estimated_wait_locked(n_rows)
                if now + est > deadline_abs:
                    self._shed[SHED_LATE] += 1
                    reason = SHED_LATE
            if reason is None:
                self._outstanding_rows += n_rows
                self._admitted += 1
        telemetry.get_registry().inc("admission_decisions",
                                     outcome=reason or "admitted")
        return reason

    def release(self, n_rows: int, service_s: Optional[float] = None):
        """Return an admitted request's rows; feed the service-time EWMA."""
        with self._lock:
            self._outstanding_rows = max(self._outstanding_rows - n_rows, 0)
            if service_s is not None and n_rows > 0:
                per_row = service_s / n_rows
                self._row_service_s += self._alpha * (per_row
                                                      - self._row_service_s)
                bucket = _bucket_of(n_rows)
                prev = self._bucket_service_s.get(bucket)
                self._bucket_service_s[bucket] = (
                    per_row if prev is None
                    else prev + self._alpha * (per_row - prev))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            s = {f"shed_{k}": float(v) for k, v in self._shed.items()}
            s.update({
                "admitted": float(self._admitted),
                "shed_total": float(sum(self._shed.values())),
                # Prefixed: ReplicaPool.stats() also reports an
                # "outstanding_rows" (batcher-enqueued rows); this one is
                # the reservation count gated against max_queue_rows.
                "admission_outstanding_rows": float(self._outstanding_rows),
                "row_service_ms": self._per_row_s() * 1e3,
                "effective_parallelism": float(self._parallelism),
            })
            for edge, est in sorted(self._bucket_service_s.items()):
                label = "inf" if edge == float("inf") else f"{int(edge)}"
                s[f"row_service_ms_le_{label}"] = est * 1e3
        return s
