"""Batched cross-query pipeline execution (PyTerrier-style batch semantics).

``MultiStageRanker.run_batch`` is a list comprehension over single queries:
every query pays its own scorer dispatch, and ``RerankStage`` re-encodes the
query once per candidate. Table 1's central lever is batching (8-30x
per-pair speedup at batch 64), and cascade ranking budgets [Wang et al. 2011]
are meant to amortize over query batches — so this engine runs stage 1
(BM25 + segmentation) per query but coalesces ALL rerank work across the
query batch:

  * one featurization pass — each query/sentence encoded once (LRU-cached),
    not once per candidate;
  * a single padded (B_total, max_len) token batch routed through
    ``core.backends.Scorer`` bucketing (which shape-buckets and chunks);
  * per-query scatter of scores back into ranked lists.

Results are identical to the sequential ranker: same candidates, same
ordering, same top-k — only the execution schedule changes. Per-stage
latency accounting is preserved; for coalesced stages each query's
``StageResult.latency_s`` is the batch stage time amortized over the
queries it covered (so summed trace latencies still add up to wall time).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline import (Candidate, MultiStageRanker, RerankStage,
                                 Stage, StageResult)
from repro_torch.data.featurize import FeaturizationCache

QueryResult = Tuple[List[Candidate], List[StageResult]]


class BatchedMultiStageRanker:
    """Run a stage cascade over a query batch, coalescing rerank stages.

    Accepts the same ``Stage`` sequence as ``MultiStageRanker``. Non-rerank
    stages (retrieval, cutoff) are inherently per-query and run as-is;
    every ``RerankStage`` is executed once for the whole batch through a
    shared featurization cache and bucketed scorer calls.

    ``shared_cache`` is the planner's plan-level optimization
    (``repro_torch.core.plan``): one ``FeaturizationCache`` serves every rerank
    stage in the plan (and every plan built from the same context), instead
    of one private cache per stage — a query or sentence featurized by any
    stage is a hit for all of them. Stages built with a matching tokenizer/
    idf/max_len use it; others keep a private cache.

    .. deprecated:: prefer ``repro_torch.core.ops`` + ``repro_torch.core.plan`` — the
       planner's ``batched`` target lowers onto this exact engine.
    """

    def __init__(self, stages: Sequence[Stage], cache_capacity: int = 8192,
                 shared_cache: Optional[FeaturizationCache] = None):
        self.stages = list(stages)
        self._caches: Dict[int, FeaturizationCache] = {}
        self._cache_capacity = cache_capacity
        self._shared_cache = shared_cache

    def _cache_for(self, stage: RerankStage) -> FeaturizationCache:
        shared = self._shared_cache
        if (shared is not None and stage.tok is shared.tok
                and stage.idf is shared.idf
                and stage.max_len == shared.max_len):
            return shared
        cache = self._caches.get(id(stage))
        if cache is None:
            cache = FeaturizationCache(stage.tok, stage.idf, stage.max_len,
                                       self._cache_capacity)
            self._caches[id(stage)] = cache
        return cache

    def run(self, query: str) -> QueryResult:
        return self.run_batch([query])[0]

    def run_batch(self, queries: Sequence[str]) -> List[QueryResult]:
        from repro_torch.serving import telemetry
        tracer = telemetry.get_tracer()
        states: List[Optional[List[Candidate]]] = [None] * len(queries)
        traces: List[List[StageResult]] = [[] for _ in queries]
        for stage in self.stages:
            # One span per stage for the whole coalesced batch (the work IS
            # batch-wide); per-query amortized time stays in the StageResult
            # trace so the two views agree on totals.
            with tracer.span(f"stage.{stage.name}", queries=len(queries)):
                if isinstance(stage, RerankStage):
                    self._run_rerank_coalesced(stage, queries, states,
                                               traces)
                elif hasattr(stage, "run_batch"):   # e.g. RetrievalStage:
                    t0 = time.perf_counter()        # one coalesced BM25 call
                    outs = stage.run_batch(queries, states)
                    per_query = (time.perf_counter() - t0) / max(
                        len(queries), 1)
                    for i, out in enumerate(outs):
                        states[i] = out
                        traces[i].append(StageResult(stage.name, out,
                                                     per_query))
                else:
                    for i, q in enumerate(queries):
                        t0 = time.perf_counter()
                        states[i] = stage.run(q, states[i])
                        traces[i].append(StageResult(
                            stage.name, states[i],
                            time.perf_counter() - t0))
        return [(cands or [], trace) for cands, trace in zip(states, traces)]

    def _run_rerank_coalesced(self, stage: RerankStage,
                              queries: Sequence[str],
                              states: List[Optional[List[Candidate]]],
                              traces: List[List[StageResult]]) -> None:
        from repro_torch.serving import telemetry
        t0 = time.perf_counter()
        cache = self._cache_for(stage)
        # gather the cross-query work list; queries with no candidates keep
        # the sequential contract (an empty StageResult, no scorer row)
        active = [i for i, c in enumerate(states) if c]
        segments: List[Tuple[int, int]] = []   # (query index, n candidates)
        with telemetry.get_tracer().span("featurize") as feat_span:
            before = cache.stats()
            q_rows, a_rows, pairs = [], [], []
            for i in active:
                cands = states[i]
                q_row = cache.query_row(queries[i])   # encoded ONCE per query
                for c in cands:
                    q_rows.append(q_row)
                    a_rows.append(cache.answer_row(c.text))
                    pairs.append((queries[i], c.text))
                segments.append((i, len(cands)))
            feats = (cache.pair_feats_many(pairs) if q_rows
                     else np.zeros((0, 4), np.float32))
            after = cache.stats()
            feat_span.set_attr("rows", len(pairs))
            feat_span.set_attr("hits", int(after["feat_cache_hits"]
                                           - before["feat_cache_hits"]))
            feat_span.set_attr("misses", int(after["feat_cache_misses"]
                                             - before["feat_cache_misses"]))

        if q_rows:
            scores = stage.scorer(np.stack(q_rows), np.stack(a_rows), feats)
        else:
            scores = np.zeros((0,), np.float32)

        offset = 0
        for i, n in segments:
            seg = scores[offset:offset + n]
            offset += n
            ranked = sorted((Candidate(c.doc_id, c.sent_id, c.text, float(s))
                             for c, s in zip(states[i], seg)),
                            key=lambda c: -c.score)
            states[i] = ranked[: stage.k]
        active_set = set(active)
        for i in range(len(states)):
            if i not in active_set:
                states[i] = []

        per_query = (time.perf_counter() - t0) / max(len(queries), 1)
        for i in range(len(queries)):
            traces[i].append(StageResult(stage.name, states[i], per_query))

    def cache_stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        caches = list(self._caches.values())
        if self._shared_cache is not None:
            caches.append(self._shared_cache)
        for cache in caches:
            for k, v in cache.stats().items():
                out[k] = out.get(k, 0.0) + v
        n = max(out.get("feat_cache_hits", 0.0)
                + out.get("feat_cache_misses", 0.0), 1.0)
        out["feat_cache_hit_rate"] = out.get("feat_cache_hits", 0.0) / n
        return out


def verify_equivalence(sequential: MultiStageRanker,
                       batched: BatchedMultiStageRanker,
                       queries: Sequence[str],
                       tie_atol: float = 1e-5) -> None:
    """Assert the batched engine reproduces the sequential rankings (same
    candidates in the same order); raises AssertionError with the first
    divergent query. Positions may swap only between candidates whose
    sequential scores are within ``tie_atol`` (the batched featurization's
    float64 summation order can differ in the last ulp, which may flip
    exact ties). Used by tests and the e2e benchmark's self-check."""
    seq = [sequential.run(q) for q in queries]
    bat = batched.run_batch(queries)
    for q, (sc, _), (bc, _) in zip(queries, seq, bat):
        s_ids = [(c.doc_id, c.sent_id, c.text) for c in sc]
        b_ids = [(c.doc_id, c.sent_id, c.text) for c in bc]
        if s_ids == b_ids:
            continue
        assert sorted(s_ids) == sorted(b_ids), (
            f"candidate set mismatch for query {q!r}: {s_ids} != {b_ids}")
        for rank, (si, bi) in enumerate(zip(s_ids, b_ids)):
            if si != bi:   # only a float-level tie may swap positions
                gap = abs(sc[rank].score - bc[rank].score)
                assert gap <= tie_atol, (
                    f"ranking mismatch for query {q!r} at rank {rank}: "
                    f"{si} != {bi} (score gap {gap:g})")
