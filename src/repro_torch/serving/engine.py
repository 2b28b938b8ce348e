"""Serving engines behind the paper's RPC interface.

``ServingEngine``: the batcher + tracker wrapped behind the paper's
``getScore`` interface, pluggable into core.service as a drop-in handler.
Featurization (tokenize + overlap features) is memoized through a bounded
LRU (``data.featurize.FeaturizationCache``) so repeated (question, answer)
pairs — the common case under production traffic — skip string processing
entirely; batch requests go through ``MicroBatcher.submit_many`` as one
contiguous sub-batch instead of per-pair futures.

``PipelineEngine``: the multi-stage analogue, routed through the
declarative pipeline API (``repro_torch.core.ops`` + ``repro_torch.core.plan``) — it
serves a whole composed ranking pipeline (``rank``/``rank_many``) under one
latency tracker, lowering the description to whichever execution target the
deployment wants instead of hard-coding an engine class per strategy."""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock

import numpy as np

from repro_torch.core.wire import ShedError
from repro_torch.data.featurize import FeaturizationCache
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.serving import telemetry
from repro_torch.serving.admission import SHED_EXPIRED
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.stats import LatencyTracker


class ServingEngine:
    #: core.service passes the wire deadline through get_scores so expired
    #: sub-batches are dropped at the MicroBatcher dequeue (SHED reply).
    supports_deadline = True

    def __init__(self, scorer, tokenizer: HashingTokenizer,
                 idf: Dict[str, float], max_len: int,
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 cache_capacity: int = 8192):
        self.tok = tokenizer
        self.idf = idf
        self.max_len = max_len
        self.features = FeaturizationCache(tokenizer, idf, max_len,
                                           cache_capacity)
        self.batcher = MicroBatcher(scorer, max_batch, max_wait_s)
        self.tracker = LatencyTracker()

    def _featurize(self, question: str, answer: str):
        return self.features.featurize(question, answer)

    def get_score(self, question: str, answer: str,
                  deadline_abs: Optional[float] = None) -> float:
        """Single-pair twin of ``get_scores``: the deadline propagates the
        same way (shed before featurization if already expired, dropped at
        the batcher dequeue if it expires while queued)."""
        if deadline_abs is not None and time.perf_counter() >= deadline_abs:
            telemetry.get_registry().inc("engine_sheds_expired")
            raise ShedError(SHED_EXPIRED)
        t0 = time.perf_counter()
        fut = self.batcher.submit(*self._featurize(question, answer),
                                  deadline_abs=deadline_abs)
        out = fut.result()
        self.tracker.observe(time.perf_counter() - t0)
        return out

    def get_scores(self, pairs: Sequence[Tuple[str, str]],
                   deadline_abs: Optional[float] = None) -> np.ndarray:
        """service.QuestionAnsweringHandler-compatible batch entry point:
        one featurization pass, one sub-batch enqueue, one future. Raises
        ``wire.ShedError`` if the deadline expires in the batcher queue."""
        if not pairs:
            return np.zeros((0,), np.float32)
        # Already expired on arrival: shed before paying featurization.
        if deadline_abs is not None and time.perf_counter() >= deadline_abs:
            telemetry.get_registry().inc("engine_sheds_expired")
            raise ShedError(SHED_EXPIRED)
        t0 = time.perf_counter()
        tracer = telemetry.get_tracer()
        with tracer.span("engine.get_scores", rows=len(pairs)):
            with tracer.span("featurize") as feat_span:
                before = self.features.stats()
                rows = [self._featurize(q, a) for q, a in pairs]
                after = self.features.stats()
                feat_span.set_attr("hits", int(after["feat_cache_hits"]
                                               - before["feat_cache_hits"]))
                feat_span.set_attr(
                    "misses", int(after["feat_cache_misses"]
                                  - before["feat_cache_misses"]))
            q_tok = np.stack([r[0] for r in rows])
            a_tok = np.stack([r[1] for r in rows])
            feats = np.stack([r[2] for r in rows])
            out = self.batcher.submit_many(
                q_tok, a_tok, feats, deadline_abs=deadline_abs).result()
        self.tracker.observe(time.perf_counter() - t0)
        return np.asarray(out)

    def stats(self) -> Dict[str, float]:
        s = self.tracker.summary()
        s.update(self.batcher.stats())  # mean_batch, rows, queue depth
        s.update(self.features.stats())
        return s

    def stop(self):
        self.batcher.stop()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class PipelineEngine:
    """Serve one declarative ranking pipeline end to end.

    Wraps ``plan(pipeline, target, ctx)`` with per-request latency tracking
    and cache/stat reporting, so deployments pick an execution strategy by
    *name* ("local" | "batched" | "remote") instead of by engine class. The
    description is the single source of truth: the same ``pipeline`` value
    a notebook runs locally is the one the cluster serves batched or
    remote.

    It is also a drop-in handler for ``core.service`` servers on the v3
    ranking messages: ``rank_batch`` answers MSG_RANK / MSG_RANK_BATCH with
    wire-level ``(doc_id, sent_id, score)`` rankings, ``supports_deadline``
    sheds expired-on-arrival requests before any retrieval work, and
    ``rows_per_query`` (retrieve depth x max sentences per doc, clipped by
    the pipeline's cutoffs) sizes ranking requests for admission control.

    With a registry-bound context the engine is also the hot-swap unit:
    ``swap_version`` re-plans against a rebound context and swaps the plan
    reference atomically (in-flight requests finish on the plan object
    they started on), and every request metric carries a ``model_version``
    label so per-version traffic separates in merged snapshots — the
    rollout controller's A/B and guardrail signals (see serving.rollout).
    """

    #: core.service passes the decoded wire deadline into ``rank_batch`` so
    #: requests already past their budget shed before stage 1 runs.
    supports_deadline = True

    def __init__(self, pipeline, ctx, target: str = "batched"):
        from repro_torch.core.plan import candidate_bound, plan as _plan
        self.pipeline = pipeline
        self.ctx = ctx
        self.target = target
        self.plan = _plan(pipeline, target, ctx)
        self.tracker = LatencyTracker()
        self.model_version: str = (getattr(ctx, "model_version", None)
                                   or "unversioned")
        self.swaps = 0
        self._swap_lock = Lock()  # serializes the claim flag only
        self._swapping = False
        #: Admission row estimate for one ranking query: the planner's
        #: candidate bound on the widest rerank stage (never below 1 so a
        #: rerank-free pipeline still counts each query).
        self.rows_per_query = max(candidate_bound(pipeline, ctx) or 1, 1)

    def rank(self, query: str, deadline_abs: Optional[float] = None):
        t0 = time.perf_counter()
        out = self.plan.run(query, deadline_abs=deadline_abs)
        dt = time.perf_counter() - t0
        self.tracker.observe(dt)
        registry = telemetry.get_registry()
        registry.inc("engine_rank_queries", model_version=self.model_version)
        registry.observe("engine_rank_ms", dt * 1e3,
                         model_version=self.model_version)
        return out

    def rank_many(self, queries: Sequence[str],
                  deadline_abs: Optional[float] = None):
        t0 = time.perf_counter()
        version = self.model_version  # one label per call, even mid-swap
        with telemetry.get_tracer().span("engine.rank_many",
                                         queries=len(queries),
                                         model_version=version):
            out = self.plan.run_many(queries, deadline_abs=deadline_abs)
        dt = time.perf_counter() - t0
        self.tracker.observe(dt, n=max(len(queries), 1))
        registry = telemetry.get_registry()
        registry.inc("engine_rank_queries", float(len(queries)),
                     model_version=version)
        registry.observe("engine_rank_ms", dt * 1e3, model_version=version)
        return out

    def swap_version(self, version: str) -> str:
        """Hot-swap to registry ``version`` ("latest", an id, or a unique
        prefix) with zero downtime. Local/batched targets re-plan against a
        rebound context off to the side (fresh scorers compile while the
        OLD plan keeps serving) and then swap the plan reference
        atomically; the remote target delegates to the in-process
        ``ReplicaPool``'s replica-by-replica swap. Returns the resolved
        version id; on any failure the old version keeps serving."""
        registry = getattr(self.ctx, "registry", None)
        if registry is None:
            raise RuntimeError("no model registry bound in the PlanContext; "
                               "serve with --registry (or PlanContext("
                               "registry=...)) to enable hot-swap")
        with self._swap_lock:
            if self._swapping:
                raise RuntimeError("swap already in progress")
            self._swapping = True
        try:
            pool = getattr(self.ctx, "remote", None)
            if self.target in ("remote", "remote_pipeline") \
                    and hasattr(pool, "swap_version"):
                vid = pool.swap_version(version, registry)
            else:
                from repro_torch.core.plan import plan as _plan
                new_ctx = self.ctx.bind_version(version)
                new_plan = _plan(self.pipeline, self.target, new_ctx)
                self.ctx = new_ctx
                self.plan = new_plan    # atomic reference swap: in-flight
                vid = new_ctx.model_version  # work finishes on the old plan
            self.model_version = vid
            self.swaps += 1
        finally:
            with self._swap_lock:
                self._swapping = False
        telemetry.get_registry().inc("engine_swaps")
        return vid

    def rank_batch(self, queries: Sequence[str],
                   deadline_abs: Optional[float] = None):
        """Wire-level handler entry point (MSG_RANK / MSG_RANK_BATCH): one
        ranked ``(doc_id, sent_id, score)`` list per query. Raises
        ``wire.ShedError`` when the request is already past its deadline —
        the whole cascade would otherwise run for an answer nobody waits
        for."""
        if not queries:
            return []
        if deadline_abs is not None and time.perf_counter() >= deadline_abs:
            telemetry.get_registry().inc("engine_sheds_expired",
                                         model_version=self.model_version)
            raise ShedError(SHED_EXPIRED)
        # The deadline keeps flowing: the plan threads it into every
        # remote stage so expired work is dropped downstream too (the
        # arrival check above alone would let queued work outlive it).
        results = self.rank_many(list(queries), deadline_abs=deadline_abs)
        return [[(c.doc_id, c.sent_id, c.score) for c in cands]
                for cands, _trace in results]

    def describe(self) -> str:
        return self.plan.describe()

    def stats(self) -> Dict[str, float]:
        s = self.tracker.summary()
        s.update(self.plan.cache_stats())
        s["rows_per_query"] = float(self.rows_per_query)
        s["swaps"] = float(self.swaps)
        return s
