"""Multi-stage ranking architecture: candidate generation -> rerank cascade.

The paper's pipeline [Tellex et al. 2003 style]: a natural-language question
is a bag-of-words query retrieving h documents (BM25); documents are
segmented into sentences; sentences are rescored by the neural reranker.
Generalized here to an N-stage cascade with per-stage budgets (Wang et al.
2011 cascade ranking; Asadi & Lin 2013 candidate generation trade-offs),
per-stage latency accounting, and pluggable scorer backends.

This module is the *execution layer*: concrete ``Stage`` implementations
plus the sequential cascade runner. New code should describe pipelines with
the declarative algebra in ``repro_torch.core.ops`` and lower them with
``repro_torch.core.plan.plan(pipeline, target, ctx)`` — the planner reuses these
stage impls for its ``local`` plan. ``MultiStageRanker`` is kept as the
(deprecated) direct entry point so existing callers keep working.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import bm25 as bm25_lib
from repro_torch.core.backends import Scorer
from repro_torch.data.tokenizer import HashingTokenizer, overlap_features


@dataclasses.dataclass
class Candidate:
    doc_id: int
    sent_id: int
    text: str
    score: float


@dataclasses.dataclass
class StageResult:
    name: str
    candidates: List[Candidate]
    latency_s: float


class Stage:
    name: str = "stage"

    def run(self, query: str, candidates: Optional[List[Candidate]]
            ) -> List[Candidate]:
        raise NotImplementedError


class RetrievalStage(Stage):
    """BM25 document retrieval + sentence segmentation (stage 1); the BM25
    scoring runs on ``device``."""

    def __init__(self, index: bm25_lib.BM25Index, documents: Sequence[Sequence[str]],
                 tokenizer: HashingTokenizer, h: int = 20, device="cuda"):
        self.name = f"bm25-h{h}"
        self.index = index
        self.documents = documents
        self.tok = tokenizer
        self.h = h
        self.device = resolve_device(device)

    def _segment(self, scores, doc_ids) -> List[Candidate]:
        out = []
        for s, di in zip(scores, doc_ids):
            if s <= 0:
                continue
            for si, sent in enumerate(self.documents[int(di)]):
                out.append(Candidate(int(di), si, sent, float(s)))
        return out

    def run(self, query, candidates=None) -> List[Candidate]:
        terms = self.tok.encode(query)
        scores, doc_ids = bm25_lib.retrieve(self.index, terms, self.h,
                                            device=self.device)
        return self._segment(scores, doc_ids)

    def run_batch(self, queries: Sequence[str],
                  states=None) -> List[List[Candidate]]:
        """Per-query retrieval, but one coalesced (Q, P) BM25 scoring call
        (identical per-query results to ``run``)."""
        hits = bm25_lib.retrieve_many(self.index,
                                      [self.tok.encode(q) for q in queries],
                                      self.h, device=self.device)
        return [self._segment(scores, doc_ids) for scores, doc_ids in hits]


class RerankStage(Stage):
    """Neural rerank through any integration backend (stage >= 2)."""

    def __init__(self, scorer: Scorer, tokenizer: HashingTokenizer,
                 idf: Dict[str, float], max_len: int, k: int = 10,
                 name: Optional[str] = None):
        self.name = name or f"rerank-{scorer.name}-k{k}"
        self.scorer = scorer
        self.tok = tokenizer
        self.idf = idf
        self.max_len = max_len
        self.k = k

    def run(self, query, candidates) -> List[Candidate]:
        if not candidates:
            return []
        q_tok = self.tok.encode_batch([query] * len(candidates), self.max_len)
        a_tok = self.tok.encode_batch([c.text for c in candidates], self.max_len)
        qw = self.tok.words(query)
        feats = np.stack([overlap_features(qw, self.tok.words(c.text), self.idf)
                          for c in candidates])
        scores = self.scorer(q_tok, a_tok, feats)
        ranked = sorted((Candidate(c.doc_id, c.sent_id, c.text, float(s))
                         for c, s in zip(candidates, scores)),
                        key=lambda c: -c.score)
        return ranked[: self.k]


class TopKStage(Stage):
    """Rank cutoff (``ops.Cutoff``): stable sort by score desc, keep top-k.

    Distinct from ``CutoffStage`` (dynamic, score-gap based): this is the
    fixed-depth truncation of cascade ranking budgets. Stable sort keeps
    the upstream order on exact score ties, so results are deterministic
    across execution plans."""

    def __init__(self, k: int):
        self.name = f"top{k}"
        self.k = int(k)

    def run(self, query, candidates) -> List[Candidate]:
        if not candidates:
            return []
        return sorted(candidates, key=lambda c: -c.score)[: self.k]


class CutoffStage(Stage):
    """Dynamic cutoff [Culpepper et al. 2016]: early-exit when stage-1 scores
    are already confidently separated — saves reranker invocations."""

    def __init__(self, margin: float = 2.0, min_keep: int = 4):
        self.name = f"cutoff-m{margin}"
        self.margin = margin
        self.min_keep = min_keep

    def run(self, query, candidates) -> List[Candidate]:
        if not candidates or len(candidates) <= self.min_keep:
            return candidates or []
        scores = np.asarray([c.score for c in candidates])
        order = np.argsort(-scores)
        keep = len(candidates)
        top = scores[order[0]]
        for rank, i in enumerate(order):
            if rank >= self.min_keep and top - scores[i] > self.margin:
                keep = rank
                break
        return [candidates[i] for i in order[:keep]]


class MultiStageRanker:
    """Compose stages; track per-stage latency for the paper's tables.

    .. deprecated:: prefer ``repro_torch.core.ops`` + ``repro_torch.core.plan`` — the
       planner's ``local`` target lowers onto this exact runner, and the
       same pipeline description also lowers to batched and remote plans.
    """

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)

    def run(self, query: str) -> Tuple[List[Candidate], List[StageResult]]:
        from repro_torch.serving import telemetry
        tracer = telemetry.get_tracer()
        candidates: Optional[List[Candidate]] = None
        trace = []
        for stage in self.stages:
            t0 = time.perf_counter()
            with tracer.span(f"stage.{stage.name}") as sp:
                candidates = stage.run(query, candidates)
                sp.set_attr("out", len(candidates or ()))
            trace.append(StageResult(stage.name, candidates,
                                     time.perf_counter() - t0))
        return candidates or [], trace

    def run_batch(self, queries: Sequence[str]):
        return [self.run(q) for q in queries]
