"""Replica pool: N independent scorer replicas behind one scoring interface.

Each replica owns a ``MicroBatcher`` worker thread, so the pool overlaps N
scorer dispatches while every replica still coalesces its own micro-batches.
Featurization goes through one shared ``FeaturizationCache`` (pure function
of the strings — sharing only raises the hit rate; the per-replica state is
the batcher queue).

Routing policies (``POLICIES``):

  round_robin        — rotate replicas; oblivious to load.
  least_outstanding  — route to the replica with the fewest enqueued/in-
                       flight rows; best tail latency, O(N) scan per pick.
  p2c                — power-of-two-choices: sample two replicas, take the
                       less loaded; near-least-outstanding tails at O(1)
                       cost (Mitzenmacher's classic result).

``get_scores`` is the ``QuestionAnsweringHandler``-compatible entry point,
so a pool drops straight into ``core.service`` servers. Pools built with
``ReplicaPool.build`` score on ``device`` (the CUDA card unless the caller
passes ``device="cpu"``); each replica has a scorer of its own.
"""
from __future__ import annotations

import random
import time
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.wire import ShedError
from repro_torch.data.featurize import FeaturizationCache
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.serving import telemetry
from repro_torch.serving.admission import SHED_EXPIRED
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.stats import LatencyTracker

POLICIES = ("round_robin", "least_outstanding", "p2c")


class Replica:
    """One scorer + its micro-batching worker + counters.

    ``draining`` marks a replica mid-hot-swap: ``_pick`` skips it so its
    retiring batcher can run its backlog dry on the OLD model while the
    rest of the pool absorbs new work (see ``ReplicaPool.swap_version``).
    """

    def __init__(self, scorer, name: str, max_batch: int, max_wait_s: float):
        self.name = name
        self.batcher = MicroBatcher(scorer, max_batch, max_wait_s)
        self.requests = 0
        self.draining = False

    @property
    def outstanding_rows(self) -> int:
        return self.batcher.outstanding_rows

    def stats(self) -> Dict[str, float]:
        s = self.batcher.stats()
        s["requests"] = float(self.requests)
        s["draining"] = 1.0 if self.draining else 0.0
        return s

    def stop(self):
        self.batcher.stop()

    def __enter__(self) -> "Replica":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class ReplicaPool:
    #: core.service passes the decoded wire deadline through ``get_scores``
    #: so the replica's MicroBatcher can drop already-expired work at
    #: dequeue (see serving.batcher deadline propagation).
    supports_deadline = True

    def __init__(self, scorers: Sequence, tokenizer: HashingTokenizer,
                 idf: Dict[str, float], max_len: int,
                 policy: str = "least_outstanding",
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 cache_capacity: int = 8192, seed: int = 0):
        if not scorers:
            raise ValueError("ReplicaPool needs at least one scorer")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self.features = FeaturizationCache(tokenizer, idf, max_len,
                                           cache_capacity)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.replicas = [Replica(s, f"replica{i}", max_batch, max_wait_s)
                         for i, s in enumerate(scorers)]
        self.tracker = LatencyTracker()
        self._lock = Lock()
        self._rr = 0
        self._rng = random.Random(seed)
        #: Registry version the replicas serve, when version-bound (set by
        #: ``build``/``swap_version``; pools built from raw scorers stay
        #: None and cannot hot-swap).
        self.model_version: Optional[str] = None
        self._build_info = None      # (backend, cfg, buckets, device)
        self._params_template = None  # restore template for version loads
        self._swap_lock = Lock()  # serializes the claim flag only
        self._swapping = False

    @classmethod
    def build(cls, backend: str, params, cfg, tokenizer: HashingTokenizer,
              idf: Dict[str, float], n_replicas: int = 2,
              buckets: Sequence[int] = (1, 8, 64), device="cuda",
              **kw) -> "ReplicaPool":
        """Convenience: N fresh scorer instances of one backend on
        ``device``. Pools built this way remember how (backend/cfg/buckets/
        device), which is what ``swap_version`` needs to rebuild replicas
        on a new version."""
        from repro_torch.core import backends as BK
        scorers = [BK.make_scorer(backend, params, cfg, buckets=buckets,
                                  device=device)
                   for _ in range(n_replicas)]
        pool = cls(scorers, tokenizer, idf, cfg.max_len, **kw)
        pool._build_info = (backend, cfg, tuple(buckets), device)
        pool._params_template = params
        return pool

    def _pick(self) -> Replica:
        # Draining replicas (mid-hot-swap) drop out of routing; if EVERY
        # replica is draining (single-replica pool mid-swap) new work keeps
        # flowing — it just lands on the replacement batcher and queues.
        reps = [r for r in self.replicas if not r.draining]
        if not reps:
            reps = self.replicas
        if len(reps) == 1:
            chosen = reps[0]
        elif self.policy == "round_robin":
            with self._lock:
                chosen = reps[self._rr % len(reps)]
                self._rr += 1
        elif self.policy == "least_outstanding":
            chosen = min(reps, key=lambda r: r.outstanding_rows)
        else:  # p2c
            with self._lock:
                a, b = self._rng.sample(range(len(reps)), 2)
            chosen = min(reps[a], reps[b], key=lambda r: r.outstanding_rows)
        with self._lock:
            chosen.requests += 1
        return chosen

    def _featurize_batch(self, pairs: Sequence[Tuple[str, str]]):
        rows = [self.features.featurize(q, a) for q, a in pairs]
        return (np.stack([r[0] for r in rows]),
                np.stack([r[1] for r in rows]),
                np.stack([r[2] for r in rows]))

    def submit(self, pairs: Sequence[Tuple[str, str]],
               deadline_abs: Optional[float] = None):
        """Route one request's pairs to a replica; returns the future.

        A submit can race a hot-swap: ``_pick`` read the replica before its
        batcher was replaced, and the retiring batcher stopped before the
        enqueue landed. The stopped-batcher rejection is SYNCHRONOUS (the
        item never entered its queue — see ``MicroBatcher._enqueue``), so
        re-routing is lossless; a fresh pick sees the replacement batcher.
        """
        q_tok, a_tok, feats = self._featurize_batch(pairs)
        for _ in range(3):
            fut = self._pick().batcher.submit_many(q_tok, a_tok, feats,
                                                   deadline_abs=deadline_abs)
            if fut.done() and isinstance(fut.exception(), RuntimeError) \
                    and "stopped" in str(fut.exception()):
                telemetry.get_registry().inc("pool_swap_reroutes")
                continue
            return fut
        return fut

    def get_scores(self, pairs: Sequence[Tuple[str, str]],
                   deadline_abs: Optional[float] = None) -> np.ndarray:
        """``QuestionAnsweringHandler``-compatible blocking entry point.
        Raises ``wire.ShedError`` if the request expired in the batcher
        queue before being scored (dropped at dequeue)."""
        if not pairs:
            return np.zeros((0,), np.float32)
        # Already expired on arrival: shed before paying featurization
        # (per-pair tokenize + overlap features hold the GIL).
        if deadline_abs is not None and time.perf_counter() >= deadline_abs:
            telemetry.get_registry().inc("pool_sheds_expired")
            raise ShedError(SHED_EXPIRED)
        t0 = time.perf_counter()
        # The batcher items capture this span as their trace parent, so the
        # queue-wait/compute split lands under the request's tree.
        with telemetry.get_tracer().span("pool.get_scores",
                                         rows=len(pairs)):
            # ``submit`` re-routes synchronous stopped-batcher rejections,
            # but an enqueue can also land on a retiring batcher in the gap
            # between its drain and its stop (hot-swap step 4) and fail
            # asynchronously. Scoring is pure, the item was never scored —
            # resubmitting is lossless, so a swap never fails a request.
            for attempt in range(3):
                try:
                    out = np.asarray(
                        self.submit(pairs, deadline_abs).result())
                    break
                except RuntimeError as e:
                    if (isinstance(e, ShedError)
                            or "MicroBatcher stopped" not in str(e)
                            or attempt == 2):
                        raise
                    telemetry.get_registry().inc("pool_swap_reroutes")
        self.tracker.observe(time.perf_counter() - t0, n=len(pairs))
        return out

    def get_score(self, question: str, answer: str,
                  deadline_abs: Optional[float] = None) -> float:
        """Single-pair twin of ``get_scores`` with the same deadline
        semantics (expired-on-arrival shed + dequeue drop)."""
        return float(self.get_scores([(question, answer)],
                                     deadline_abs=deadline_abs)[0])

    def outstanding_rows(self) -> int:
        return sum(r.outstanding_rows for r in self.replicas)

    @property
    def effective_parallelism(self) -> int:
        """How many backlogs drain concurrently — the admission
        controller's parallelism hint (see
        ``AdmissionController.set_effective_parallelism``)."""
        return len(self.replicas)

    def row_service_s(self) -> Optional[float]:
        """Per-row scorer service-time estimate for admission control: the
        mean scorer-side per-row time over warmed replicas. This is the
        time ONE replica spends on one row; the admission controller
        divides its drain estimate by ``effective_parallelism`` (dividing
        here too would double-count the pool's parallelism). None until
        some replica has scored a batch."""
        obs = [r.batcher.row_scorer_s for r in self.replicas]
        obs = [o for o in obs if o is not None]
        if not obs:
            return None
        return sum(obs) / len(obs)

    def stats(self) -> Dict[str, float]:
        s = self.tracker.summary()
        s["n_replicas"] = float(len(self.replicas))
        s["outstanding_rows"] = float(self.outstanding_rows())
        for r in self.replicas:
            for k, v in r.stats().items():
                s[f"{r.name}_{k}"] = v
        s.update(self.features.stats())
        return s

    # -- hot-swap --------------------------------------------------------------

    def _swap_replica(self, rep: Replica, scorer, drain_timeout_s: float):
        """Zero-loss batcher replacement for one replica:

          1. mark draining    — ``_pick`` routes new work elsewhere;
          2. install the NEW batcher — any submit that already picked this
             replica lands on the new model from here on;
          3. run the OLD batcher's backlog dry — queued rows finish on the
             model they were admitted under;
          4. rejoin, then stop the old batcher — a straggler that still
             holds the old batcher object gets the synchronous stopped
             rejection and ``submit`` re-routes it (see there).
        """
        rep.draining = True
        old = rep.batcher
        rep.batcher = MicroBatcher(scorer, self.max_batch, self.max_wait_s)
        deadline = time.perf_counter() + drain_timeout_s
        while old.outstanding_rows > 0 and time.perf_counter() < deadline:
            time.sleep(0.001)
        rep.draining = False
        old.stop()

    def swap_version(self, version: str, registry,
                     drain_timeout_s: float = 10.0) -> str:
        """Hot-swap every replica to registry ``version`` ("latest", an id,
        or a unique prefix), one replica at a time, under load, without
        failing a request. Returns the resolved version id. Only pools
        constructed via ``build`` know their backend/cfg and can swap."""
        if self._build_info is None:
            raise RuntimeError("pool was built from raw scorers; only "
                               "ReplicaPool.build pools can swap_version")
        with self._swap_lock:
            if self._swapping:
                raise RuntimeError("swap already in progress")
            self._swapping = True
        try:
            from repro_torch.core import backends as BK
            backend, cfg, buckets, device = self._build_info
            vid = registry.resolve(version)
            params = registry.load_params(vid,
                                          template=self._params_template)
            t0 = time.perf_counter()
            for rep in self.replicas:
                scorer = BK.make_scorer(backend, params, cfg,
                                        buckets=buckets, device=device)
                self._swap_replica(rep, scorer, drain_timeout_s)
            self._params_template = params
            self.model_version = vid
            registry_m = telemetry.get_registry()
            registry_m.inc("pool_swaps")
            registry_m.observe("pool_swap_ms",
                               (time.perf_counter() - t0) * 1e3)
            return vid
        finally:
            with self._swap_lock:
                self._swapping = False

    def stop(self):
        for r in self.replicas:
            r.stop()

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
